"""Build and load the package's CUDA kernels.

The sources under ``repro_torch/csrc`` compile with ``nvcc`` for ``sm_90a``
into ONE shared library with a plain C interface, loaded with ``ctypes``
(no PyTorch headers in the sources, so a build takes seconds).  The build
happens at first use — never at import, so every module of the package
imports on a machine without ``nvcc`` — and lands in ``build/`` at the
repository root.  The library's name carries a hash of the sources, so an edited source rebuilds
and an unchanged one is reused.

There is no fallback: a missing compiler, a failed build or a failed launch
raises.  The wrappers in ``kernels/*/ops.py`` take the plain PyTorch version
only for tensors that lie on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

#: C entry point -> argument types (every pointer and the stream are
#: ``c_void_p``: a bare Python int would be cut to 32 bits)
SIGNATURES = {
    # (q, lo, hi, anchors, out, nq, stream)
    "anchor_probe_sliced_launch": (_P, _P, _P, _P, _P, _L, _P),
    # (q, anchors, idx, found, nq, na, route, stream)
    "anchor_probe_launch": (_P, _P, _P, _P, _L, _L, _I, _P),
    # (cand_vals, cand_valid, C, query_terms, row stride, W, query_lens,
    #  c_offsets, n_offsets, anchors, n_entries, expand, expand_valid,
    #  expand_len, phrase, hit, B, stream)
    "dense_probe_window_launch": (_P, _P, _L, _P, _L, _I, _P, _P, _L, _P, _L, _P, _P, _I,
                                  _I, _P, _L, _P),
    # (gaps, out, workspace, workspace_len, n, route, stream)
    "dgap_decode_launch": (_P, _P, _P, _L, _L, _I, _P),
    # (pool, pool_n, ptr, base, lens, values, valid, rows, L, stream)
    "decode_rows_launch": (_P, _L, _P, _P, _P, _P, _P, _L, _I, _P),
    # (pool, pool_n, ptr, base, lens, targets, hit, rows, stream)
    "probe_rows_launch": (_P, _L, _P, _P, _P, _P, _P, _L, _P),
    # (pool, pool_n, c_offsets, n_offsets, anchors, c_ptr, c_len, n_entries,
    #  list_ids, ids stride, row_start, window rows, values, valid, B, L, stream)
    "decode_window_launch": (_P, _L, _P, _L, _P, _P, _P, _L, _P, _L, _L, _I, _P, _P, _L,
                             _I, _P),
    # (cand_vals, cand_valid, C, query_terms, row stride, W, query_lens,
    #  c_offsets, n_offsets, anchors, c_ptr, c_len, n_entries, pool, pool_n,
    #  phrase, hit, B, stream)
    "probe_window_launch": (_P, _P, _L, _P, _L, _I, _P, _P, _L, _P, _P, _P, _L, _P, _L,
                            _I, _P, _L, _P),
    # (shingles, lens, a, b, out, D, L, P, route, stream)
    "minhash_rows_launch": (_P, _P, _P, _P, _P, _L, _L, _I, _I, _P),
    # (q, k, v, out, lse or null, B, T, S, H, K, hd, dtype, causal, scale,
    #  q strides b/t/h, k strides b/s/k, v strides b/s/k, route, stream)
    "flash_attention_launch": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _P),
    # (q, k, v, positions, part, out, B, S, H, K, hd, q dtype, kv dtype, scale,
    #  chunk, n_splits, route, q strides b/h, k strides b/s/k, v strides b/s/k,
    #  stream)
    "flash_decode_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
                            _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _P),
    # (q, k, v, positions, start, part, out, lse, B, S, H, K, hd, q dtype,
    #  kv dtype, scale, chunk, n_splits, route, q strides b/h, k strides b/s/k,
    #  v strides b/s/k, stream)
    "flash_decode_partial_launch": (_P, _P, _P, _P, _L, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _I, _F, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _P),
    # (idx, table, out, n_bags, bag, D, V, row stride, row_start, n_rows, dtype, route,
    #  stream)
    "embedding_bag_launch": (_P, _P, _P, _L, _I, _I, _L, _L, _L, _L, _I, _I, _P),
    # (x0, xk, w, out, B, m, Hk, H, D, stream)
    "cin_layer_launch": (_P, _P, _P, _P, _L, _I, _I, _I, _I, _P),
    # (buf, w, out, E, C, D, F, buf dtype, w dtype, route, stream)
    "moe_gemm_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
}

_lib: ctypes.CDLL | None = None
#: facts of the build that loaded the library (seconds, nvcc, path, reused?)
build_info: dict = {}


def build_dir() -> Path:
    # <root>/src/repro_torch/kernels/cuda_build.py -> <root>/build
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            exe = str(cand)
    if exe is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "CUDA kernels of repro_torch build from source at first use and "
            "there is no fallback for CUDA tensors")
    return exe


def _run(cmd: list[str]) -> subprocess.Popen:
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _wait(proc: subprocess.Popen, what: str) -> str:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {proc.returncode}):\n{out}")
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it first when needed.  One
    ``nvcc -c`` per source, all started together, then one link; what
    ``ptxas -v`` says of each kernel (registers, spills) lands in
    ``build_info["log"]``."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC_DIR.glob("*.cu"))
    headers = sorted(CSRC_DIR.glob("*.cuh"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    digest = hashlib.sha256()
    for f in sources + headers:
        digest.update(f.name.encode())
        digest.update(f.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / f"librepro_torch_kernels_{digest.hexdigest()[:16]}.so"
    t0 = time.perf_counter()
    reused = so.is_file()
    log = ""
    if not reused:
        nvcc = _nvcc()
        flags = [*NVCC_FLAGS, "-Xptxas", "-v"]
        objs = [out_dir / f"{src.stem}_{digest.hexdigest()[:16]}.o" for src in sources]
        procs = [_run([nvcc, *flags, "-I", str(CSRC_DIR), "-c", str(src), "-o", str(obj)])
                 for src, obj in zip(sources, objs)]
        for src, proc in zip(sources, procs):
            log += _wait(proc, f"nvcc -c {src.name}")
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        log += _wait(_run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)]), "nvcc -shared")
        os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
        version = subprocess.run([nvcc, "--version"], capture_output=True,
                                 text=True).stdout.strip().splitlines()
        build_info["nvcc"] = version[-2] if len(version) >= 2 else " ".join(version)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    build_info.update(seconds=round(time.perf_counter() - t0, 3), library=str(so),
                      reused=reused, sources=[s.name for s in sources], log=log)
    _lib = lib
    return lib


def check(code: int, what: str) -> None:
    """Raise when a launch function returned a CUDA error code."""
    if code != 0:
        msg = load().repro_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {code} ({msg})")


def stream_ptr() -> int:
    """PyTorch's current CUDA stream as the integer ``cudaStream_t``."""
    import torch

    return torch.cuda.current_stream().cuda_stream


def require_int32(name: str, t, ndim: int = 1, row_stride: bool = False) -> None:
    """The kernels take contiguous int32 tensors and nothing else (the
    wrappers check the device themselves).  With ``row_stride`` the kernel
    reads rows by a stride: only the last dimension of a 2-D tensor must be
    contiguous, and a 1-D one (one element a row) may have any stride."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimension(s), got shape {tuple(t.shape)}")
    if row_stride:
        if ndim > 1 and t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: expected a contiguous last dimension")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


#: the floating-point kernels' element types, by the code their launch
#: functions take (``csrc/floats.cuh``)
FLOAT_CODES = {"torch.float32": 0, "torch.bfloat16": 1}


def require_float(name: str, t, ndim: int) -> int:
    """The floating-point kernels take float32 or bfloat16 tensors of ``ndim``
    dimensions, read by strides, whose last dimension is contiguous; returns
    the element type's code for the launch function."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if str(t.dtype) not in FLOAT_CODES:
        raise TypeError(f"{name}: expected float32 or bfloat16, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dimensions, got shape {tuple(t.shape)}")
    if t.shape[-1] > 1 and t.stride(-1) != 1:
        raise ValueError(f"{name}: expected a contiguous last dimension")
    return FLOAT_CODES[str(t.dtype)]


def require_cuda(name: str, t) -> None:
    """A wrapper takes the plain version for a CPU tensor and launches for a
    CUDA one; a tensor on any other device is refused."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} lies on {t.device}: the kernel takes CUDA tensors "
                         f"(a CPU tensor takes the plain version)")


def require_no_grad(name: str, *tensors) -> None:
    """A wrapper has no backward of its own: a direct call that autograd
    would have to differentiate is refused (the training path calls the
    ``torch.autograd.Function`` of its kernel, whose forward runs without
    grad)."""
    import torch

    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(f"{name} has no backward; call it under torch.no_grad() "
                                  f"or train through its autograd Function")
