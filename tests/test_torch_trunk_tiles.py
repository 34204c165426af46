"""K2/K3's shape rules on the CPU: the shared memory their tiles take and the
shapes the wrapper refuses.

``trunk_tile_smem`` reckons the bytes of the widest block of the bf16
warpgroup kernels (128-row tiles; a TMA ring of 16 KB slices of 128 x 64
bf16, three slices a stage in the mixing trunk and two elsewhere, as many
stages as fit up to 6 and at least 3, each with three 8-byte barriers,
beside 1,024 bytes of alignment, two 16 KB output staging tiles and the
kernels' f32 arrays) and of the f32 FMA kernels; every width the port's
CLAM sizes give must fit one H100 block's 232,448 bytes. ``_check_shapes`` raises, naming
the shape, on an L1 or D that is not a multiple of 128 (the kernels' column
passes), on the meta device: no data and no card needed.
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
