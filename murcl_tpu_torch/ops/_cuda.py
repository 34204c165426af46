"""Build, load and launch-count the hand-written CUDA kernels in ``csrc/``.

Each ``.cu`` source is compiled with ``nvcc`` for ``sm_90a`` by its own
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with :mod:`ctypes`. The
measurement probes (the ports of the JAX package's TPU probes,
``murcl_tpu_torch/scripts/dbg_*.py``) build into a second library,
:func:`probe_library`, on a probe's first call: their sources
(:data:`PROBE_SOURCES`) beside the production source they drive, so that
no training path waits for their build. The library
links only the CUDA runtime: the warpgroup kernels' TMA descriptors come
from the driver's ``cuTensorMapEncodeTiled``, reached at run time through
the runtime's ``cudaGetDriverEntryPointByVersion`` (``csrc/wgmma_tiles.cuh``),
so no ``-lcuda`` is needed at build time. Each library is
built on first use into ``build/murcl_tpu_torch/`` at the repository root,
named by a hash of its sources and flags, so an edited source builds anew.
An exclusive file lock (``fcntl``) on ``build/murcl_tpu_torch/.build.lock``
makes processes that need the library at once (data-parallel ranks, however
they were started) wait for one build instead of compiling side by side.
Nothing here runs at import time; a machine without ``nvcc`` raises when a
kernel is first needed.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a nonzero code into an error.
:data:`LAUNCHES` counts, per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "murcl_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]
# SMs of the H100 SXM the kernels are built for; the grid planners of
# ops/compact.py and ops/attention.py size their grids by it (a plain
# number, so that the CPU twins plan the same chunks)
H100_SMS = 132

LAUNCHES = {
    "compact": 0,
    "attention_pool_fwd": 0,
    "attention_pool_bwd": 0,
    "fused_trunk_fwd": 0,
    "fused_trunk_bwd": 0,
    "ntxent_fwd": 0,
    "ntxent_bwd": 0,
    "mixup_rows": 0,
    "attention_pool_tiled": 0,
    # not the port of a TPU kernel: libjpeg's upsampling and colour
    # conversion on nvJPEG's planes (preprocess/nvjpeg.py)
    "ycc_to_rgb": 0,
    # the ports of the JAX package's TPU probes (scripts/dbg_vpu_lean.py,
    # dbg_bwd_ablate.py, dbg_mxu_vpu_overlap.py): K2/K3's ablations
    # (ops/attention.py TRUNK_FWD_VARIANTS, TRUNK_BWD_VARIANTS) and the
    # overlap probe's modes (ops/overlap.py), each under its own name
    **{f"trunk_fwd_{v}": 0 for v in ("lean", "prelean")},
    **{f"trunk_bwd_{v}": 0 for v in ("full", "nodrop", "nowgrad", "nodx", "recompute",
                                     "prelean", "lean2")},
    **{f"overlap_{m}": 0 for m in ("mxu", "vpu", "dep", "indep")},
}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    # bank, offsets, ranks, num_patches, out, B, nmax, F, row_bytes,
    # slot_slice, stream
    "murcl_compact": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # is_bf16, x, perm, lam, out, B, per_bag, vec, stream
    "murcl_mixup_rows": [_I, _P, _P, _P, _P, _I, _L, _I, _P],
    # zi, zj, temp, loss, stats, terms, ticket, zn, B, d, stream
    "murcl_ntxent_fwd": [_P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _P],
    # zi, zj, temp, stats, g, dzi, dzj, zn, B, d, stream
    "murcl_ntxent_bwd": [_P, _P, _F, _P, _P, _P, _P, _P, _I, _I, _P],
    # is_bf16, gated, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, bc, x3, mask,
    # use_dropout, seed, thresh, scale, xc_scratch, hm_scratch, m, p, s, B, N,
    # Fin, L1, D, stream
    "murcl_fused_trunk_fwd": [_I, _I] + [_P] * 13 + [_I, _U, _U, _F] + [_P] * 5
    + [_I] * 5 + [_P],
    # is_bf16, gated, h, perm, lam, wf, bf, wa, ba, wb, bb, wc, x3, mask,
    # use_dropout, seed, thresh, scale, p, gm, gp, gs, hm, xc, dp, dzab, dz,
    # dh, dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc, B, N, Fin, L1, D, stream
    "murcl_fused_trunk_bwd": [_I, _I] + [_P] * 12 + [_I, _U, _U, _F] + [_P] * 18
    + [_I] * 5 + [_P],
    # is_bf16, gated, x, wa, ba, wb, bb, wc, bc, mask, use_dropout, seed,
    # thresh, scale, xpl, m, p, s, B, N, F, D, Dl (the logical D), stream
    "murcl_attention_pool_fwd": [_I, _I] + [_P] * 8 + [_I, _U, _U, _F] + [_P] * 4
    + [_I] * 5 + [_P],
    # is_bf16, gated, x, wa, ba, wb, bb, wc, wa2, wb2, mask, use_dropout, seed,
    # thresh, scale, p, gm, gp, gs, dp, z, xpl, dx, dwa, dba, dwb, dbb, dwc,
    # dbc, B, N, F, D, Dl, stream
    "murcl_attention_pool_bwd": [_I, _I] + [_P] * 9 + [_I, _U, _U, _F] + [_P] * 14
    + [_I] * 5 + [_P],
    # is_bf16, x, s, mask, m_part, mx_part, l_part, m, B, N, F, chunk, stream
    "murcl_attention_pool_tiled": [_I] + [_P] * 7 + [_I] * 4 + [_P],
    # src, out, rows, cols, stream
    "murcl_split_bf16": [_P, _P, _I, _I, _P],
    # y, cb, cr, out, h, w, ch, cw, fv, fh, stream
    "murcl_ycc_to_rgb": [_P] * 4 + [_I] * 6 + [_P],
}

# the probe library's sources: the probes' own, which the kernel library
# leaves out, and fused_trunk.cu, whose passes the K2/K3 ablations run
_PROBE_ONLY = ("fused_trunk_ablate.cu", "wgmma_overlap.cu")
PROBE_SOURCES = ("fused_trunk.cu",) + _PROBE_ONLY
_PROBE_SIGNATURES = {
    # variant, then murcl_fused_trunk_fwd's and murcl_fused_trunk_bwd's
    "murcl_fused_trunk_fwd_ablate": [_I] + _SIGNATURES["murcl_fused_trunk_fwd"],
    "murcl_fused_trunk_bwd_ablate": [_I] + _SIGNATURES["murcl_fused_trunk_bwd"],
    # mode, x, y, w, m_out, v_out, steps, N, stream
    "murcl_wgmma_overlap": [_I] + [_P] * 5 + [_I, _I, _P],
}

_lib = _probe_lib = None
# one build when several threads first need a kernel; the probe library's
# own, so that a probe's build holds up no production kernel
_lib_lock, _probe_lock = threading.Lock(), threading.Lock()


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


def sources(probes: bool = False) -> list:
    """The ``.cu`` sources of the kernel library, or of the probe library."""
    cu = sorted(CSRC.glob("*.cu"))
    if probes:
        return [src for src in cu if src.name in PROBE_SOURCES]
    return [src for src in cu if src.name not in _PROBE_ONLY]


def library_path(probes: bool = False) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources(probes) + sorted(CSRC.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    name = "probes" if probes else "kernels"
    return BUILD_DIR / f"libmurcl_{name}_{digest.hexdigest()[:16]}.so"


def _wait(procs) -> None:
    """Wait for every ``(process, source)`` pair, then raise if any failed."""
    failed = []
    for proc, src in procs:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(probes: bool = False) -> Path:
    """Compile the kernels (``probes``: the probe library) unless a library
    of the current sources exists; one process at a time builds, the others
    then find its library."""
    out = library_path(probes)
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if not out.exists():
            _compile(nvcc, out, sources(probes))
    return out


def _compile(nvcc: str, out: Path, srcs: list) -> None:
    tag = f"{out.stem}.{os.getpid()}"
    objs, procs = [], []
    for src in srcs:
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        objs.append(obj)
        procs.append((subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                                       stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True), src.name))
    _wait(procs)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.Popen([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _wait([(link, "the link")])
    for obj in objs:
        obj.unlink()
    os.replace(tmp, out)


def _load(path: Path, signatures: dict) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _load(build(), _SIGNATURES)
            lib.murcl_error_string.argtypes = [ctypes.c_int]
            lib.murcl_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def probe_library() -> ctypes.CDLL:
    """The loaded probe library (built on first call): the K2/K3 ablations
    and the overlap probe, off every training path."""
    global _probe_lib
    with _probe_lock:
        if _probe_lib is None:
            _probe_lib = _load(build(probes=True), _PROBE_SIGNATURES)
    return _probe_lib


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

