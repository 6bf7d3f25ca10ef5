"""Model side of the port: the LM serving path, dense and MoE
(``transformer``, ``steps``), and the recsys serving path (``recsys``,
``steps``) over plain tensor layers (``layers``, ``flash``) and the
hand-written kernels."""
