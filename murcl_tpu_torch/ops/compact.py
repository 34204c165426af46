"""Sub-bag compaction: kernel K1 and its plain twin.

``out[i, f, :] = bank[row_offsets[i] + p, :]`` where ``ranks[i, p] == f``
and ``p < num_patches[i]``; slots no patch maps to are zeros. Counterpart of
``murcl_tpu/ops/compact_pallas.py`` ``gather_compact`` (grouped kernel
``_make_kernel_grouped``), bitwise equal to its golden
``gather_compact_xla``.

On the TPU this was a one-hot matmul over a DMA'd slide window, and the
grouped variant shared one window read between the ``repeat`` bags of a
slide. On the GPU it is a direct row copy (``csrc/compact.cu``): the L2
cache serves the reuse of a slide's rows across its bags, so the
``repeat``/``group``/``band``/``tile`` knobs have no counterpart.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda


def gather_compact_plain(bank_feats, row_offsets, ranks, feat_size: int,
                         num_patches):
    """Plain PyTorch compaction (the CPU path and the kernel's reference)."""
    b, n_max = ranks.shape
    out = bank_feats.new_zeros((b, feat_size, bank_feats.shape[1]))
    p = torch.arange(n_max, device=ranks.device)[None, :]
    live = (ranks >= 0) & (p < num_patches[:, None])
    bag, patch = torch.nonzero(live, as_tuple=True)
    out[bag, ranks[bag, patch].long()] = bank_feats[row_offsets[bag] + patch]
    return out


def compact_slot_slice(batch: int, feat_size: int) -> int:
    """Output slots per block of K1: the bag's ``feat_size`` slots split
    into a power-of-two number of slices, so that ``batch`` x slices reaches
    two blocks per H100 SM where the sub-bag allows, each slice a multiple
    of 32 slots (a word of the kernel's bitmap) and at least 32. The last
    slice takes what is left: ``ceil(feat_size / slice)`` slices tile the
    slots exactly."""
    want = -(-2 * _cuda.H100_SMS // max(batch, 1))
    slices = 1
    while slices < want:
        slices *= 2
    per = -(-feat_size // slices)
    return max(32, -(-per // 32) * 32)


def _gather_compact_cuda(bank_feats, row_offsets, ranks, feat_size: int,
                         num_patches):
    name = "gather_compact"
    offs = row_offsets.to(torch.int64).contiguous()
    nump = num_patches.to(torch.int64).contiguous()
    _cuda.require_cuda(name, bank_feats, offs, ranks, nump)
    if ranks.dtype != torch.int32 or ranks.dim() != 2:
        raise ValueError(f"{name}: ranks must be (B, Nmax) int32")
    if bank_feats.dtype not in (torch.float32, torch.bfloat16) or bank_feats.dim() != 2:
        raise ValueError(f"{name}: bank must be (P, D) float32 or bfloat16")
    b, n_max = ranks.shape
    row_bytes = bank_feats.shape[1] * bank_feats.element_size()
    if row_bytes % 16 or bank_feats.data_ptr() % 16 or offs.shape != (b,) \
            or nump.shape != (b,):
        raise ValueError(f"{name}: rows must be 16-byte multiples on a 16-byte "
                         "aligned bank, offsets/num_patches (B,)")
    out = torch.empty((b, feat_size, bank_feats.shape[1]), dtype=bank_feats.dtype,
                      device=bank_feats.device)
    lib = _cuda.library()
    err = lib.murcl_compact(
        bank_feats.data_ptr(), offs.data_ptr(), ranks.data_ptr(), nump.data_ptr(),
        out.data_ptr(), b, n_max, feat_size, row_bytes, compact_slot_slice(b, feat_size),
        _cuda.stream())
    _cuda.check(err, name)
    _cuda.LAUNCHES["compact"] += 1
    return out


def gather_compact(bank_feats, row_offsets, ranks, feat_size: int, num_patches):
    """Compact selected bank rows into ``(B, feat_size, D)`` sub-bags.

    ``bank_feats (P, D)``, ``row_offsets (B,)``, ``ranks (B, Nmax)`` int32
    (-1 = not selected, slots unique per bag), ``num_patches (B,)``. CPU
    tensors take the plain version; CUDA tensors launch the kernel.
    """
    if bank_feats.device.type == "cpu":
        return gather_compact_plain(bank_feats, row_offsets, ranks, feat_size,
                                    num_patches)
    return _gather_compact_cuda(bank_feats, row_offsets, ranks, feat_size,
                                num_patches)
