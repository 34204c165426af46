"""Cluster-window sub-bag selection (counterpart of ``murcl_tpu/ops/select.py``).

Reference semantics (``utils/datasets.py:274-308``), per bag with ``N``
patches, ``K`` clusters, action ``a in [0,1]^K`` and target size ``F``:
window size ``s_c = round(n_c * F / N)`` (half to even), start
``l_c = floor(a_c * (n_c - s_c))``, take the python slice
``cluster_c[l_c : l_c + s_c]``, union the slices in ascending patch order,
zero-pad or truncate to ``F`` rows.

:func:`select_ranks` (JAX ``select_ranks`` / ``_ranks_one``) gives each
patch its slot in the sub-bag, or -1; it is bitwise equal to the JAX
version under the same actions. :func:`select_feats` then compacts the
selected rows (:func:`murcl_tpu_torch.ops.compact.gather_compact`, the CUDA
kernel on the GPU).
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops.compact import gather_compact
from murcl_tpu_torch.utils.trace import span


def _python_slice_bounds(l, r, n):
    """Effective ``[start, end)`` of python slicing ``lst[l:r]`` for length n."""
    start = torch.where(l < 0, torch.clamp(n + l, min=0), torch.minimum(l, n))
    end = torch.where(r < 0, torch.clamp(n + r, min=0), torch.minimum(r, n))
    return start, end


def _ranks_one(num_patches, cluster_sizes, actions, patch_cluster, patch_pos,
               feat_size: int):
    """Per-patch sub-bag slot or -1, batched: ``(rank (B, Nmax), count (B,))``.

    ``num_patches (B,)``, ``cluster_sizes (B, K)``, ``actions (B, K)`` f32,
    ``patch_cluster``/``patch_pos`` ``(B, Nmax)``. Selected patches past
    ``feat_size`` are truncated (-1), like the reference.
    """
    n_c = cluster_sizes.to(torch.float32)
    ratio = feat_size / num_patches.to(torch.float32)
    s_c = torch.round(n_c * ratio[:, None]).to(torch.int64)
    l_c = torch.floor(actions * (n_c - s_c.to(torch.float32))).to(torch.int64)
    sizes = cluster_sizes.to(torch.int64)
    start, end = _python_slice_bounds(l_c, l_c + s_c, sizes)

    # padding rows carry pos = -1 and can never fall inside a window
    pc = patch_cluster.to(torch.int64)
    pos = patch_pos.to(torch.int64)
    flag = (pos >= torch.gather(start, 1, pc)) & (pos < torch.gather(end, 1, pc))
    cum = torch.cumsum(flag.to(torch.int32), dim=1)
    count = cum[:, -1]
    rank = cum - 1
    rank = torch.where(flag & (rank < feat_size), rank, torch.full_like(rank, -1))
    return rank.to(torch.int32), count


def select_ranks(slide_ids, offsets, num_patches, cluster_sizes, actions,
                 patch_cluster, patch_pos, feat_size: int):
    """Batched per-patch slots: ``(ranks (B, Nmax) int32, row_offsets (B,),
    valid (B, feat_size))``. ``ranks[i, p] == f`` makes bank row
    ``row_offsets[i] + p`` row ``f`` of sub-bag ``i``."""
    ranks, counts = _ranks_one(
        num_patches[slide_ids], cluster_sizes[slide_ids], actions,
        patch_cluster[slide_ids], patch_pos[slide_ids], feat_size)
    slot = torch.arange(feat_size, device=ranks.device)[None, :]
    valid = slot < torch.clamp(counts, max=feat_size)[:, None]
    return ranks, offsets[slide_ids], valid


def select_feats(bank, slide_ids, actions, feat_size: int):
    """The reference ``get_feats``: ``(B, feat_size, D)`` sub-bags of
    ``bank`` (a :class:`~murcl_tpu_torch.data.bank.FeatureBank`)."""
    with span("murcl.select"):
        ranks, row_offsets, _ = select_ranks(
            slide_ids, bank.offsets, bank.num_patches, bank.cluster_sizes, actions,
            bank.patch_cluster, bank.patch_pos, feat_size)
        return gather_compact(bank.feats, row_offsets, ranks, feat_size,
                              bank.num_patches[slide_ids])
