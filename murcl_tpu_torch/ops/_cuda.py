"""Build, load and launch-count the hand-written CUDA kernels in ``csrc/``.

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The library is
built on first use into ``build/murcl_tpu_torch/`` at the repository root,
named by a hash of the sources and flags, so an edited source builds anew.
Nothing here runs at import time; a machine without ``nvcc`` raises when a
kernel is first needed.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
:data:`LAUNCHES` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "murcl_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

LAUNCHES = {
    "compact": 0,
    "fused_trunk_fwd": 0,
    "fused_trunk_bwd": 0,
    "ntxent_fwd": 0,
    "ntxent_bwd": 0,
}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_SIGNATURES = {
    # bank, offsets, ranks, num_patches, out, B, nmax, F, row_bytes, stream
    "murcl_compact": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # zi, zj, temp, loss, B, d, stream
    "murcl_ntxent_fwd": [_P, _P, _F, _P, _I, _I, _P],
    # zi, zj, temp, g, dzi, dzj, B, d, stream
    "murcl_ntxent_bwd": [_P, _P, _F, _P, _P, _P, _I, _I, _P],
    # is_bf16, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, mask,
    # use_dropout, seed, thresh, scale, xc_scratch, m, p, s, B, N, Fin, L1, D,
    # stream
    "murcl_fused_trunk_fwd": [_I] + [_P] * 12 + [_I, _U, _U, _F] + [_P] * 4
    + [_I] * 5 + [_P],
    # is_bf16, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, waT, wbT, mask,
    # use_dropout, seed, thresh, scale, p, gm, gp, gs, hm, xc, dp, dza, dzb,
    # dz, dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc, B, N, Fin, L1, D, stream
    "murcl_fused_trunk_bwd": [_I] + [_P] * 13 + [_I, _U, _U, _F] + [_P] * 18
    + [_I] * 5 + [_P],
}

_lib = None


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    raise RuntimeError(
        "the CUDA kernels need nvcc (CUDA toolkit) to build; none found on "
        "PATH or under $CUDA_HOME/bin")


def library_path() -> Path:
    sources = sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmurcl_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels unless a library of the current sources exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.murcl_error_string.argtypes = [ctypes.c_int]
        lib.murcl_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        msg = library().murcl_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expects CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")

