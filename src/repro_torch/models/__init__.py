"""Model side of the port: the dense decoder-only LM's serving path
(``transformer``, ``steps``) over plain tensor layers (``layers``, ``flash``)
and the hand-written attention kernels."""
