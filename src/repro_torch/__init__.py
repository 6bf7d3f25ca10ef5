"""PyTorch / CUDA implementation of the universal indexes for highly
repetitive document collections: seeded data, Re-Pair stores, anchored device
arrays, hand-written CUDA kernels and the batched serving path.  Imports
``torch`` and ``numpy`` only; device work runs on the GPU unless a caller asks
for ``device="cpu"``."""
