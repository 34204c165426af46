"""K2/K3's shape rules on the CPU: the shared memory their tiles take and the
shapes the wrapper refuses.

``trunk_tile_smem`` reckons the bytes of the widest block of the warpgroup
kernels (128-row tiles; a TMA ring of 16 KB slices of 128 x 64 bf16, in
bf16 three slices a stage in the mixing trunk and two elsewhere, at least 3
stages; in float32 each slice as its two bf16 planes, at least 2 stages; as
many as fit up to 6, each with three 8-byte barriers, beside 1,024 bytes of
alignment, the output staging and the kernels' f32 arrays) from
``trunk_plans``; every width the port's CLAM sizes give must fit one H100
block's 232,448 bytes, and the float32 route takes every shape the FMA
tiles it replaced took. ``_check_shapes`` raises, naming the shape, on an L1
or D that is not a multiple of 128 (the kernels' column passes), on the
meta device: no data and no card needed.
"""

import pytest
import torch

from murcl_tpu_torch.ops import attention as tat


def _operands(n, fin, l1, d, dtype):
    meta = dict(device="meta")
    return (torch.empty(2, n, fin, dtype=dtype, **meta), torch.empty(fin, l1, **meta),
            torch.empty(l1, d, **meta))


@pytest.mark.parametrize("fin,l1,d,refused", [
    (512, 512, 256, None),   # CLAM "small" at dim 512 (the bench.py shape)
    (512, 512, 384, None),   # CLAM "big"
    (1024, 512, 256, None),  # CLAM "small" at dim 1024 (ResNet-50 features)
    (512, 192, 256, "(512, 192, 256)"),
    (512, 512, 200, "(512, 512, 200)"),
])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_trunk_tiles_fit_and_refuse(fin, l1, d, refused, dtype):
    h, wf, wa = _operands(1024, fin, l1, d, dtype)
    if refused:
        with pytest.raises(ValueError, match=r"L1, D multiples of 128 \(got "
                           + refused.strip("()") + r"\)"):
            tat._check_shapes("fused_trunk_attention_pool", h, wf, wa)
        return
    smem = tat.trunk_tile_smem(1024, fin, l1, d, dtype)
    assert smem <= tat._SMEM_LIMIT == 232448
    tat._check_shapes("fused_trunk_attention_pool", h, wf, wa, need_dh=True)
    if dtype == torch.bfloat16:  # the mixing trunk: 3 stages of bag, partner, Wf; staging
        assert smem >= 1024 + 3 * (24 + 3 * 128 * 64 * 2) + 2 * 64 * 128 * 2


@pytest.mark.parametrize("n,fin,l1,d", [
    (1024, 512, 512, 256),   # the main path's shape (bench.py)
    (1024, 512, 512, 384),   # CLAM "big"
    (1024, 1024, 512, 256),  # ResNet-50 features
    (3072, 512, 512, 256),   # the heatmap's largest bag on K2 (f32)
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_trunk_plans_fit(n, fin, l1, d, dtype):
    plans = tat.trunk_plans(l1, d, dtype)
    least, stage = (2, 4 * 128 * 64 * 2) if dtype == torch.float32 else (3, 2 * 128 * 64 * 2)
    for kernel, (stages, nbytes) in plans.items():
        assert least <= stages <= 6 and nbytes <= tat._SMEM_LIMIT, kernel
        if kernel != "trunk_wg" or dtype == torch.float32:  # a stage: A's and B's slices
            assert nbytes >= 1024 + stages * (stage + 24), kernel
    assert tat.trunk_tile_smem(n, fin, l1, d, dtype) == max(
        max(nb for _, nb in plans.values()), 4 * (n + 32))
    h, wf, wa = _operands(n, fin, l1, d, dtype)
    tat._check_shapes("fused_trunk_attention_pool", h, wf, wa, need_dh=True)


def _fma_tiles_smem(n, fin, l1, d):
    """The f32 FMA tiles' widest block (32-row tiles, 128-column passes,
    32-deep B slices in f32, rows padded by one), which K2/K3's f32 route
    took before its warpgroup kernels, and the pool pass's ``n + 32``
    floats."""
    trunk = 32 * (fin + 1) + 32 * (l1 + 1) + 32 * 128
    gates = 32 * (l1 + 1) + 2 * 32 * (d + 1) + 32 * 128 + 2 * 32 + d + 32
    return max(4 * trunk, 4 * gates, 4 * (n + 32))


@pytest.mark.parametrize("l1", [128, 256, 512, 1024])
def test_f32_route_takes_every_shape_the_fma_tiles_took(l1):
    for fin in range(64, 2049, 64):
        for d in range(128, 1025, 128):
            for n in (1, 1000, 3072, 50000):
                if _fma_tiles_smem(n, fin, l1, d) <= tat._SMEM_LIMIT:
                    assert tat.trunk_tile_smem(n, fin, l1, d, torch.float32) <= tat._SMEM_LIMIT, \
                        (n, fin, l1, d)

