"""K7's gate keep masks, written out: the port of ``scripts/tpu_smoke.py``'s
mask writer.

Counterpart of the ``pallas_call`` of ``scripts/tpu_smoke.py:101``
(``mask_kernel``, ``:96-99``), which wrote the gated pool's two dropout keep
masks (``murcl_tpu/ops/attention_pallas.py`` ``_dropout_masks``) so that the
JAX script could rebuild the pool with them. The port's K7f and K7b draw
their keep bits from the counter hash of ``csrc/common.cuh`` (streams 1 and
2, ``ops/attention.py`` ``_keep_bits``); :func:`gate_keep_masks` writes those
bits, ``ka`` and ``kb`` of ``(B, N, D)`` bool, by the kernel
``csrc/gate_masks.cu`` on a CUDA device and by :func:`gate_keep_masks_plain`
on the CPU. A probe (``murcl_tpu_torch/scripts/dropout_smoke.py``), on no
training path.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.ops.attention import _M32, _keep_bits, dropout_threshold


def gate_keep_masks_plain(seed: int, rate: float, b: int, n: int, d: int, device="cpu"):
    """``(ka, kb)``, ``(b, n, d)`` bool: K7's keep bits of gates a and b
    (hash streams 1 and 2) at ``seed``, kept where the bits are at least
    :func:`dropout_threshold` of ``rate``, as K7f and K7b keep them."""
    bags = torch.arange(b, device=torch.device(device), dtype=torch.int64)
    thresh = dropout_threshold(rate)
    return tuple(_keep_bits(seed, bags, n, d, stream) >= thresh for stream in (1, 2))


def _gate_keep_masks_cuda(seed, rate, b, n, d, device):
    name = "gate_keep_masks"
    dev = torch.device(device)
    if not 0.0 < rate < 1.0:
        raise ValueError(f"{name}: needs a dropout rate in (0, 1), got {rate}")
    ka = torch.empty((b, n, d), dtype=torch.bool, device=dev)
    kb = torch.empty_like(ka)
    _cuda.require_cuda(name, ka, kb)
    _cuda.check(_cuda.probe_library().murcl_gate_masks(
        int(seed) & _M32, dropout_threshold(rate), b, n, d, ka.data_ptr(), kb.data_ptr(),
        _cuda.stream()), name)
    _cuda.LAUNCHES["gate_masks"] += 1
    return ka, kb


def gate_keep_masks(seed: int, rate: float, b: int, n: int, d: int, device="cuda:0"):
    """K7's gate keep masks ``(ka, kb)``, ``(b, n, d)`` bool, on ``device``:
    the kernel on a CUDA device, :func:`gate_keep_masks_plain` on the CPU."""
    if torch.device(device).type == "cpu":
        return gate_keep_masks_plain(seed, rate, b, n, d, device)
    return _gate_keep_masks_cuda(seed, rate, b, n, d, device)
