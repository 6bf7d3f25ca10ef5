"""The mesh tier on ``torch.distributed``: meshes (``compat``), the
reference's partition specs (``specs``) and the sharded train step
(``spmd``)."""
