"""K7's shape rules and dx's bf16 split on the CPU.

``pool_plans`` reckons K7's launch plans (``csrc/attention_pool.cu``):
persistent warpgroup kernels over 128-row tiles, each a ring of TMA stages
beside its staging and arrays, in bf16 and in float32 (each operand as two
bf16 planes); ``pool_tile_smem`` takes the widest. Every width the port
gives K7 (ABMIL at D 128, CLAM "small" at 256, "big" at 384) must fit one
H100 block's 232,448 bytes with a ring of at least 3 stages in bf16 and 2
in float32.
``_check_pool_shapes`` raises, naming the shape, on what the tiles cannot
take, on the meta device: no data and no card needed. It takes every width,
as the JAX kernels do: the wrappers zero-pad F and D to multiples of 128
(``pad_pool_widths``), and the rule reckons the padded widths. K7b's own rule
(``pool_bwd_tile_smem``, ``_check_pool_shapes(backward=True)``) counts only
its blocks' tiles, so it takes the heatmap's largest bag and longer ones,
which K7f's softmax pass refuses. ``split_bf16``: three bf16 products of the
planes stand in for an f32 product to 1e-5, where one bf16 product does not.
"""

import numpy as np
import pytest
import torch

from murcl_tpu_torch.ops import attention as tat

NAME = "gated_attention_pool"


def _operands(n, f, d, dtype):
    return torch.empty(2, n, f, dtype=dtype, device="meta"), torch.empty(f, d, device="meta")


@pytest.mark.parametrize("f", [512, 1024])
@pytest.mark.parametrize("d", [128, 256, 384])
def test_pool_tiles_fit(f, d):
    smem = tat.pool_tile_smem(1024, f, d, torch.bfloat16)
    assert smem <= tat._SMEM_LIMIT == 232448
    # the gates backward's ring (3 stages of a 128-row x slice and a W
    # slice) beside two warpgroups' hi and lo staging, and the dx kernel's
    # 3 stages of the dz planes' and W's slices (gated: streamed)
    assert smem >= 1024 + 3 * (2 * 128 * 64 * 2 + 24) + 4 * 64 * 128 * 2
    assert smem >= 1024 + 3 * (4 * 128 * 64 * 2 + 24)
    tat._check_pool_shapes(NAME, *_operands(1024, f, d, torch.bfloat16))


def test_two_blocks_per_sm_at_clam_small():
    """The 128-row plan runs one persistent block per SM (it was two blocks
    of 64-row tiles): every bf16 K7 kernel's TMA ring holds at least 3
    stages at F 512 and 1024 and every width, gated or not, within one
    block's shared memory."""
    for f in (512, 1024):
        for d in (128, 256, 384):
            for gated in (True, False):
                plans = tat.pool_plans(f, d, gated, torch.bfloat16)
                for kernel, (stages, nbytes) in plans.items():
                    assert stages >= 3 and nbytes <= tat._SMEM_LIMIT, (f, d, gated, kernel)


@pytest.mark.parametrize("f", [512, 1024])
@pytest.mark.parametrize("d", [128, 256, 384])
def test_f32_plans_fit(f, d):
    """The float32 route (the supervised CLIs' default) runs the same
    kernels with stages of 64 KB (x's and W's hi and lo slices): every f32
    kernel's ring holds at least 2 stages at F 512 and 1024 and every width,
    gated or not, within one block's shared memory. At CLAM "big" (gated, D
    384) the gates backward keeps its partials per warpgroup, where eight
    warps' copies would leave it one stage."""
    for gated in (True, False):
        for kernel, (stages, nbytes) in tat.pool_plans(f, d, gated, torch.float32).items():
            assert stages >= 2 and nbytes <= tat._SMEM_LIMIT, (f, d, gated, kernel)
    tat._check_pool_shapes(NAME, *_operands(1024, f, d, torch.float32))
    tat._check_pool_shapes(NAME + " backward", *_operands(1024, f, d, torch.float32),
                           backward=True)


@pytest.mark.parametrize("f", [512, 1024])
@pytest.mark.parametrize("d", [896, 1024])
def test_wide_bf16_keeps_partials_per_warpgroup(f, d):
    """From D 896 in bf16, eight warps' copies of the gates backward's
    partials (27 D floats with ba, bb and wc) leave less than 2 stages: the
    plan keeps one copy per warpgroup (9 D floats), as the f32 route does
    at D 384 (``bwd_plan`` in ``csrc/attention_pool.cu``), and both ops'
    checks take the shape."""
    stage = 2 * tat._WG_SLICE
    per_warp = tat._wg_plan(stage, 2 * tat._WG_OUT, 4 * (3 + 8 * 3) * d, 2)
    assert per_warp[1] > tat._SMEM_LIMIT
    for gated in (True, False):
        plans = tat.pool_plans(f, d, gated, torch.bfloat16)
        assert plans["pool_gates_bwd_wg"] == tat._wg_plan(stage, 2 * tat._WG_OUT,
                                                          4 * (3 + 2 * 3) * d, 2)
        for kernel, (stages, nbytes) in plans.items():
            assert stages >= 2 and nbytes <= tat._SMEM_LIMIT, (gated, kernel)
    tat._check_pool_shapes(NAME, *_operands(1024, f, d, torch.bfloat16))
    tat._check_pool_shapes(NAME + " backward", *_operands(1024, f, d, torch.bfloat16),
                           backward=True)


@pytest.mark.parametrize("n,f,d,dtype", [
    (1024, 448, 256, torch.bfloat16), (1024, 512, 192, torch.bfloat16),
    (1024, 512, 96, torch.float32),
    # the JAX package's PPO learning check (scripts/ppo_sanity.py: L 32, D 8)
    (1024, 32, 8, torch.float32), (1024, 32, 8, torch.bfloat16),
])
def test_check_shapes_take_any_width(n, f, d, dtype):
    """The JAX kernels take any F and D (their blocks span the arrays' whole
    widths); K7's and K8's wrappers zero-pad to the kernels' multiples of
    128 (``pad_pool_widths``), so K7f's, K7b's and K8's rules take every
    such width, reckoned at the padded widths."""
    x, wa = _operands(n, f, d, dtype)
    tat._check_pool_shapes(NAME, x, wa)
    tat._check_pool_shapes(NAME + " backward", x, wa, backward=True)
    tat._check_tiled_shapes("attention_pool_tiled", x, wa)
    fp, dp = -(-f // 128) * 128, -(-d // 128) * 128
    assert tat.pool_tile_smem(n, fp, dp, dtype) <= tat._SMEM_LIMIT
    v = torch.empty(d, device="meta")
    xp, wap, bap, wbp, bbp, wcp = tat.pad_pool_widths(x, wa, v, wa, v, v)
    assert xp.shape == (2, n, fp) and wap.shape == wbp.shape == (fp, dp)
    assert bap.shape == bbp.shape == wcp.shape == (dp,)


@pytest.mark.parametrize("n,f,d,dtype,match", [
    (60000, 512, 256, torch.bfloat16, r"240128 bytes .* \(N, F, D\) = \(60000, 512, 256\)"),
    # refused by the 64-row tiles (an x tile of 4096 columns), taken by the
    # 128-row plan, which holds no term in F but a row of gm
    (1024, 4096, 256, torch.bfloat16, None),
    (1024, 512, 256, torch.float16, r"float32 or bfloat16"),
    # f32's gates backward leaves 1 stage from D 896, even with its
    # partials per warpgroup
    (1024, 512, 1024, torch.float32, r"238680 bytes .* \(N, F, D\) = \(1024, 512, 1024\)"),
])
def test_check_pool_shapes_refuses(n, f, d, dtype, match):
    if match is None:
        tat._check_pool_shapes(NAME, *_operands(n, f, d, dtype))
        return
    with pytest.raises(ValueError, match=match):
        tat._check_pool_shapes(NAME, *_operands(n, f, d, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n", [(1, 60416), (2, 100000)])
def test_backward_check_takes_long_bags(b, n, dtype):
    """K8's op differentiates the heatmap's largest bag (and longer) on the
    card, as the JAX package's XLA backward does."""
    x, wa = torch.empty(b, n, 512, dtype=dtype, device="meta"), torch.empty(512, 256,
                                                                          device="meta")
    tat._check_pool_shapes(NAME + " backward", x, wa, backward=True)
    assert tat.pool_bwd_tile_smem(512, 256, dtype) <= tat._SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_forward_check_still_refuses_past_its_pool_pass(dtype):
    x, wa = torch.empty(1, 60416, 512, dtype=dtype, device="meta"), torch.empty(512, 256,
                                                                              device="meta")
    with pytest.raises(ValueError, match=r"241792 bytes .* \(N, F, D\) = \(60416, 512, 256\)"):
        tat._check_pool_shapes(NAME, x, wa)


@pytest.mark.parametrize("f,d,dtype", [(4096, 256, torch.bfloat16), (2048, 256, torch.float32)])
def test_backward_check_refuses_wide_tiles(f, d, dtype):
    """No plan holds an x tile of F columns: the bf16 plan (refused at F
    4096 by the 64-row tiles) and, since the f32 route runs the same
    warpgroup kernels, the f32 plan (refused at F 2048 by the FMA tiles,
    whose block held an f32 x tile of 32 rows x F columns) take both; only
    a row of ``gm`` per warpgroup grows with F."""
    x, wa = _operands(1024, f, d, dtype)
    tat._check_pool_shapes(NAME + " backward", x, wa, backward=True)


def test_split_bf16_three_products_match_f32():
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.standard_normal((1024, 256), dtype=np.float32))
    w = torch.tensor(rng.standard_normal((256, 512), dtype=np.float32))
    want = a.double() @ w.double()
    (ah, al), (wh, wl) = tat.split_bf16(a), tat.split_bf16(w)
    for t in (ah, al, wh, wl):
        assert t.dtype == torch.bfloat16
    assert bool(((ah.float() + al.float() - a).abs() <= 2**-16 * a.abs()).all())
    f = lambda t: t.float()  # noqa: E731  products of bf16 values are exact in f32
    three = f(ah) @ f(wh) + f(ah) @ f(wl) + f(al) @ f(wh)
    one = f(ah) @ f(wh)

    def rel(x):
        return float((x.double() - want).norm() / want.norm())

    assert rel(three) <= 1e-5, rel(three)
    assert rel(one) > 1e-3, rel(one)


@pytest.mark.parametrize("which", ["pool", "trunk"])
def test_kernel_args_write_out_a_broadcast_mask(which):
    """A mask of shape (1, N) broadcast over B bags reaches the kernels as
    (B, N): they read bag b's row at b * N (a (1, N) buffer there was read
    past its end); a (B, N) mask passes as it is."""
    b, n, f, d = 3, 40, 128, 128
    x = torch.zeros(b, n, f, dtype=torch.bfloat16)
    w = [torch.zeros(f, d), torch.zeros(d), torch.zeros(f, d), torch.zeros(d), torch.zeros(d)]
    mask = torch.arange(n)[None, :] < n - 5
    for m in (mask, mask.expand(b, n).clone()):
        if which == "pool":
            ops, _ = tat._pool_args("K7", x, *w, m, 0.0, 0, True)
        else:
            ops, _ = tat._cuda_args(x, torch.zeros(f, f), torch.zeros(f), *w, m, None, None,
                                    0.0, 0)
        assert ops["mask"].shape == (b, n) and ops["mask"].is_contiguous()
        assert torch.equal(ops["mask"], mask.expand(b, n))
