"""K2/K3's shape rules on the CPU: the shared memory their tiles take and the
shapes the wrapper refuses.

``trunk_tile_smem`` reckons the bytes of the widest block of the bf16
tensor-core kernels (64-row tiles, bf16 A tiles padded by 8, a 2-stage B
ring of 64-deep slices) and of the f32 FMA kernels; every width the port's CLAM sizes give
must fit one H100 block's 232,448 bytes. ``_check_shapes`` raises, naming
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
    if dtype == torch.bfloat16:  # the trunk kernel: the mixed bag's tile, B ring, row sums
        assert smem >= 2 * 64 * (fin + 8) + 2 * 2 * 64 * 136 + 4 * 64 * 4
