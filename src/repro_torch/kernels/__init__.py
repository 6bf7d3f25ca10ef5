"""Hand-written CUDA kernels (sources under ``repro_torch/csrc``) with their
PyTorch wrappers.  Each family keeps three files: ``ops.py`` (the wrapper,
its launch count and the plain PyTorch version of the same function),
``ref.py`` (a NumPy oracle) and the ``.cu`` source.  Nothing here builds or
loads a kernel at import: that happens inside the first launch."""
