"""The overlap probe: does CUDA-core work overlap a warpgroup product in flight?

Counterpart of the ``pallas_call`` of ``scripts/dbg_mxu_vpu_overlap.py``
(``run``, ``:96``), the JAX package's TPU probe of whether independent
matrix-unit and vector-unit work overlap inside one program; the port's
kernel is ``csrc/wgmma_overlap.cu`` (its design and bound there), driven by
``murcl_tpu_torch/scripts/dbg_mxu_vpu_overlap.py``. Over ``steps`` tiles
``x[s]``, ``y[s]`` ``(N, 512)`` bf16 and ``w (512, 512)`` bf16, each mode
returns the f32 column sums of ``m`` and ``v`` per step, ``(steps, 512)``
each:

- ``mxu``: ``m = rnd(m @ w)`` four times from ``x[s]`` (:func:`mxu_chain`);
  ``v`` is ``y[s]`` as it is.
- ``vpu``: ``v = rnd(tanh(v) sigmoid(v))`` eight times from ``y[s]``, in
  f32 math (:func:`heavy`); ``m`` is ``x[s]`` as it is.
- ``dep``: ``heavy`` of ``mxu_chain`` of ``x[s]``.
- ``indep``: ``mxu_chain`` of ``x[s]`` and ``heavy`` of ``y[s]``.

CPU tensors take :func:`overlap_plain`; CUDA tensors launch the kernel. A
probe: no training path takes it.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda

MODES = {"mxu": 0, "vpu": 1, "dep": 2, "indep": 3}
PRODUCTS, ROUNDS, WIDTH = 4, 8, 512


def mxu_chain(x, w):
    """``m = rnd(m @ w)`` :data:`PRODUCTS` times from ``x``, each product in
    f32 from bf16 operands."""
    m = x
    for _ in range(PRODUCTS):
        m = (m.float() @ w.float()).to(x.dtype)
    return m


def heavy(v):
    """``v = rnd(tanh(v) sigmoid(v))`` :data:`ROUNDS` times, in f32 math."""
    for _ in range(ROUNDS):
        v32 = v.float()
        v = (torch.tanh(v32) * torch.sigmoid(v32)).to(v.dtype)
    return v


def overlap_plain(mode, x, y, w):
    """The twin of mode ``mode``: ``(m sums, v sums)``, each ``(steps, D)``
    f32."""
    if mode not in MODES:
        raise ValueError(f"overlap: no mode {mode!r}")
    m = mxu_chain(x, w) if mode != "vpu" else x
    if mode == "dep":
        v = heavy(m)
    else:
        v = heavy(y) if mode in ("vpu", "indep") else y
    return m.float().sum(1), v.float().sum(1)


def _overlap_cuda(mode, x, y, w):
    name = "wgmma_overlap"
    steps, n, d = x.shape
    if x.dtype != torch.bfloat16 or y.dtype != x.dtype or w.dtype != x.dtype:
        raise ValueError(f"{name}: x, y and w must be bfloat16")
    if d != WIDTH or y.shape != x.shape or w.shape != (WIDTH, WIDTH) or n % 128:
        raise ValueError(f"{name}: needs x, y (steps, N, {WIDTH}) with N % 128 == 0 and w "
                         f"({WIDTH}, {WIDTH}) (got {tuple(x.shape)}, {tuple(y.shape)}, "
                         f"{tuple(w.shape)})")
    x, y, w = x.contiguous(), y.contiguous(), w.contiguous()
    _cuda.require_cuda(name, x, y, w)
    m = torch.empty((steps, d), dtype=torch.float32, device=x.device)
    v = torch.empty_like(m)
    _cuda.check(_cuda.probe_library().murcl_wgmma_overlap(
        MODES[mode], x.data_ptr(), y.data_ptr(), w.data_ptr(), m.data_ptr(), v.data_ptr(),
        steps, n, _cuda.stream()), name)
    _cuda.LAUNCHES[f"overlap_{mode}"] += 1
    return m, v


def wgmma_overlap(mode, x, y, w):
    """Mode ``mode`` (:data:`MODES`) over ``x``, ``y`` ``(steps, N, 512)`` and
    ``w (512, 512)``, bf16: ``(m sums, v sums)``, ``(steps, 512)`` f32."""
    if mode not in MODES:
        raise ValueError(f"overlap: no mode {mode!r}")
    if x.device.type == "cpu":
        return overlap_plain(mode, x, y, w)
    return _overlap_cuda(mode, x, y, w)
