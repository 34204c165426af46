"""Sub-bag compaction: kernel K1 and its plain twin.

``out[i, f, :] = bank[row_offsets[i] + p, :]`` where ``ranks[i, p] == f``
and ``p < num_patches[i]``; slots no patch maps to are zeros. Counterpart of
``murcl_tpu/ops/compact_pallas.py`` ``gather_compact`` (grouped kernel
``_make_kernel_grouped``), bitwise equal to its golden
``gather_compact_xla``.

On the TPU this was a one-hot matmul over a DMA'd slide window, and the
grouped variant shared one window read between the ``repeat`` bags of a
slide. On the GPU it is a copy (``csrc/compact.cu``): each block inverts a
bag's ranks into a slot -> patch table for its slice of slots, then gathers
slot-ordered tiles of rows with TMA bulk copies and stores each tile whole
(:func:`compact_plan` sizes the slices, tiles and ring). The L2 cache serves
the reuse of a slide's rows across its bags, so the
``repeat``/``group``/``band``/``tile`` knobs have no counterpart.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

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


# K1's launch plan, mirroring csrc/compact.cu: 256 threads a block, tiles of
# about 64 KB (at most 64 rows) in a ring that keeps about 128 KB of loads in
# flight, a 128-byte head of barriers and the slice's int32 slot table
_TILE_BYTES, _MAX_ROWS, _IN_FLIGHT, _MAX_RING = 65536, 64, 131072, 8
_HEAD, _MAX_SLICE = 128, 4096  # slots a block's table holds, at most (plus a tile)
SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_SM_SMEM, _SM_BLOCKS, _BLOCK_RESERVE = 233472, 8, 1024  # per SM: bytes, blocks of 256


class CompactPlan(NamedTuple):
    slot_slice: int  # output slots per block
    slices: int      # blocks per bag
    rows: int        # slots per tile
    ring: int        # tile buffers
    smem: int        # dynamic shared memory per block, bytes
    by_slide: bool   # blocks take the bags in slide order (more than one wave)


def _table_bytes(slots: int) -> int:
    return -(-4 * slots // 128) * 128


@functools.lru_cache(maxsize=64)
def compact_plan(batch: int, feat_size: int, row_bytes: int) -> CompactPlan:
    """K1's grid and tiles for ``batch`` bags of ``feat_size`` slots of
    ``row_bytes`` each: tiles of ``64 KB / row_bytes`` rows (1 to 64) in a
    ring of up to 8 buffers, as many as keep 128 KB of loads in flight and
    fit (a ring under 2 is refused); a bag's slots split into as many slices
    as fill one wave of the blocks that fit on the H100's SMs where the bags
    are few, one slice a bag where they are many, each slice a whole number
    of tiles but the last and at most 4,096 slots plus a tile. Past one wave
    the blocks take the bags in slide order (``by_slide``: the kernel ranks
    them by offset first), so that the bags of a slide run together and
    read its rows through the L2 cache."""
    rows = max(1, min(_MAX_ROWS, _TILE_BYTES // row_bytes))
    tile = rows * row_bytes
    room = (SMEM_LIMIT - _HEAD - _table_bytes(_MAX_SLICE + _MAX_ROWS)) // tile
    ring = min(_MAX_RING, 1 + -(-_IN_FLIGHT // tile), room)
    if ring < 2:
        raise ValueError(f"gather_compact: rows of {row_bytes} bytes leave no room for two "
                         "tile buffers in a block's shared memory")
    est = _HEAD + _table_bytes(min(feat_size, _MAX_SLICE)) + ring * tile + _BLOCK_RESERVE
    resident = max(1, min(_SM_BLOCKS, _SM_SMEM // est)) * _cuda.H100_SMS
    slices = max(1, resident // max(batch, 1), -(-feat_size // _MAX_SLICE))
    per = -(-max(feat_size, 1) // slices)
    per = -(-per // rows) * rows
    slices = -(-feat_size // per)
    return CompactPlan(per, slices, rows, ring, _HEAD + _table_bytes(per) + ring * tile,
                       batch * slices > resident)


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
    plan = compact_plan(b, feat_size, row_bytes)
    out = torch.empty((b, feat_size, bank_feats.shape[1]), dtype=bank_feats.dtype,
                      device=bank_feats.device)
    if b and feat_size:
        # the kernel writes the bags' slide order here first (bags of one
        # slide share its offset)
        order = torch.empty(b, dtype=torch.int64, device=offs.device) if plan.by_slide \
            else None
        err = _cuda.library().murcl_compact(
            bank_feats.data_ptr(), offs.data_ptr(), ranks.data_ptr(), nump.data_ptr(),
            None if order is None else order.data_ptr(), out.data_ptr(), b, n_max, feat_size,
            row_bytes, plan.slot_slice, plan.rows, plan.ring, _cuda.stream())
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
