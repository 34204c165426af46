"""K8's and K1's grid and tile rules on the CPU, with no card.

K8 runs in two parts (``csrc/attention_tiled.cu``): its gate pass is K7f's
gate kernel, whose launch plan ``tiled_plans`` takes from ``pool_plans`` at
the widths zero-padded to multiples of 128, and a bytes-bound chunk pass of
``tiled_chunk`` rows a block, whose shared memory (each row's rounded ``e``
and each 32-row half's rescale, ``tiled_chunk_smem``) lets eight blocks share
an SM. Every width the port gives K8 must fit one H100 block's 232,448
bytes, and ``_check_tiled_shapes`` refuses what does not, naming the shape,
on the meta device. In f32 the gate products are three bf16 products of
``split_bf16``'s planes, W's laid out by ``w_planes``; a CPU mirror matches
an f64 product to 1e-5, where one bf16 product does not. The twin
``attention_pool_tiled_plain`` rounds ``e`` at the running max of each
chunk's 32-row halves, as the chunk pass does: it matches a row-by-row walk
in the kernel's order, in f64, to 1e-6, and in bf16 differs from rounding at
each chunk's final max. ``tiled_chunk`` gives whole 64-row tiles per block,
and K1's planner ``compact_plan`` splits a few bags' slots so that its grid
fills one wave of the card, its slices tiling the slots exactly in whole
tiles, orders the bags by slide past one wave, and keeps its tile ring within
a block's shared memory in both dtypes.
"""

import numpy as np
import pytest
import torch

from murcl_tpu_torch.ops import attention as tat
from murcl_tpu_torch.ops.compact import SMEM_LIMIT, compact_plan

NAME = "attention_pool_tiled"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256, 384])
@pytest.mark.parametrize("f", [512, 1024])
def test_tiled_plans_fit(f, d, dtype):
    """At the heatmap's largest bag: the gate pass is K7f's gate kernel at
    the same widths, with a ring of at least 2 stages in f32 and 3 in bf16;
    the chunk pass holds 64 rows' ``e`` and two rescales."""
    plans = tat.tiled_plans(1, 60416, f, d, dtype)
    assert set(plans) == {"pool_gates_fwd_wg", "chunk_kernel"}
    gates = plans["pool_gates_fwd_wg"]
    assert gates == tat.pool_plans(f, d, True, dtype)["pool_gates_fwd_wg"]
    assert gates[0] >= (2 if dtype == torch.float32 else 3)
    assert plans["chunk_kernel"] == (None, 4 * (64 + 2))
    assert max(nb for _, nb in plans.values()) <= tat._SMEM_LIMIT == 232448
    x = torch.empty(1, 60416, f, dtype=dtype, device="meta")
    tat._check_tiled_shapes(NAME, x, torch.empty(f, d, device="meta"))


@pytest.mark.parametrize("b,n", [(1, 60416), (1, 12288)])
def test_chunk_pass_in_one_wave(b, n):
    """The chunk pass at the heatmap's bags: eight 256-thread blocks share an
    SM (their shared memory and the 1 KB the card reserves per block within
    its 228 KB, 2,048 threads), and the grid of 64-row chunks is one wave
    of them over 132 SMs."""
    chunk = tat.tiled_chunk(b, n)
    assert chunk == 64
    assert 8 * (tat.tiled_chunk_smem(chunk) + 1024) <= 228 * 1024
    assert b * -(-n // chunk) <= 8 * 132


@pytest.mark.parametrize("n,f,d,dtype,match", [
    # the gate pass's ring: one f32 stage beside 3 D floats of ba, bb, wc
    (60416, 512, 8192, torch.float32, r"234584 bytes .* \(N, F, D\) = \(60416, 512, 8192\)"),
    (60416, 512, 10752, torch.bfloat16,
     r"232560 bytes .* \(N, F, D\) = \(60416, 512, 10752\)"),
    # the chunk pass: past one wave its chunks grow with the bag
    (60_000_000, 512, 256, torch.float32,
     r"234168 bytes .* \(N, F, D\) = \(60000000, 512, 256\)"),
    (60416, 512, 256, torch.float16, r"float32 or bfloat16"),
])
def test_check_tiled_shapes_refuses(n, f, d, dtype, match):
    with pytest.raises(ValueError, match=match):
        tat._check_tiled_shapes(NAME, torch.empty(1, n, f, dtype=dtype, device="meta"),
                                torch.empty(f, d, device="meta"))


@pytest.mark.parametrize("f", [512, 1024])
def test_three_bf16_products_over_w_planes_match_f64(f):
    """The gate pass's f32 pre-activation: x's ``hi`` and ``lo`` planes
    against ``w_planes``' ``Whi`` rows (the first F) and ``Wlo`` rows (the
    next F), ``hi Whi + hi Wlo + lo Whi``, summed in f32."""
    rng = np.random.default_rng(0)
    x = torch.tensor(np.abs(rng.standard_normal((256, f), dtype=np.float32)))
    w = torch.tensor(rng.standard_normal((f, 256), dtype=np.float32) * f ** -0.5)
    want = x.double() @ w.double()
    planes = tat.w_planes(w)
    assert planes.shape == (2 * f, 256) and planes.dtype == torch.bfloat16
    whi, wlo = planes[:f].float(), planes[f:].float()  # bf16 values, exact in f32
    hi, lo = (t.float() for t in tat.split_bf16(x))
    got = hi @ whi + hi @ wlo + lo @ whi
    one = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()

    def rel(t):
        return float((t.double() - want).norm() / want.norm())

    assert rel(got) <= 1e-5, rel(got)
    assert rel(one) > 1e-3, rel(one)


def _walk(x, s, mask, chunk, dt, at_running_max=True):
    """M of K8's chunk pass and merge, row by row in f64: per chunk, one
    32-row half at a time, the running max, each ``e`` rounded to ``dt`` at
    its half's running max (or, with ``at_running_max=False``, at the
    chunk's final max), the sums rescaled on a new max; then the chunks
    merged."""
    b, n, f = x.shape
    rnd = lambda v: float(torch.tensor(v, dtype=torch.float32).to(dt).float())  # noqa: E731
    out = np.zeros((b, f))
    for i in range(b):
        parts = []
        for c0 in range(0, n, chunk):
            rows = [r for r in range(c0, min(n, c0 + chunk)) if mask[i, r]]
            final = max((float(s[i, r]) for r in rows), default=-1e30)
            mx, total, acc = -1e30, 0.0, np.zeros(f)
            for h0 in range(c0, min(n, c0 + chunk), 32):
                half = [r for r in rows if h0 <= r < h0 + 32]
                new = max([mx] + [float(s[i, r]) for r in half])
                corr = np.exp(mx - new)
                acc, total = acc * corr, total * corr
                for r in half:
                    e = np.exp(float(s[i, r]) - new)
                    total += e
                    if at_running_max:
                        w = rnd(e)
                    else:  # rounded at the final max, then on the running max's scale
                        w = rnd(np.exp(float(s[i, r]) - final)) * np.exp(final - new)
                    acc += w * x[i, r].double().numpy()
                mx = new
            parts.append((mx, total, acc))
        top = max(p[0] for p in parts)
        num = sum(np.exp(p[0] - top) * p[2] for p in parts)
        out[i] = num / sum(np.exp(p[0] - top) * p[1] for p in parts)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,lengths", [(150, [150, 40]), (64, [64, 23]), (200, [97, 200])])
def test_twin_rounds_e_at_the_32_row_running_max(dtype, n, lengths):
    """The twin's M against the chunk pass's walk in f64 (1e-6: the twin
    sums in f32, over 32-row tiles); in bf16 the walk that rounds ``e`` at
    each chunk's final max instead differs from it by more (about 2^-9 an
    ``e``)."""
    rng = np.random.default_rng(len(lengths) + n)
    f, d = 16, 8
    w = [torch.tensor(rng.normal(size=sh).astype(np.float32) * sc)
         for sh, sc in (((f, d), 0.4), ((d,), 0.1), ((f, d), 0.4), ((d,), 0.1), ((d,), 2.0))]
    bc = torch.tensor(0.05)
    x = torch.tensor(np.abs(rng.normal(size=(len(lengths), n, f))).astype(np.float32)).to(dtype)
    mask = torch.arange(n)[None, :] < torch.tensor(lengths)[:, None]
    m, _, s = tat.attention_pool_tiled_plain(x, *w, bc, mask)
    chunk = tat.tiled_chunk(len(lengths), n)
    want = _walk(x, s, mask, chunk, dtype)
    rel = float(np.linalg.norm(m.double().numpy() - want) / np.linalg.norm(want))
    assert rel <= 1e-6, rel
    if dtype == torch.bfloat16:
        other = _walk(x, s, mask, chunk, dtype, at_running_max=False)
        assert float(np.linalg.norm(other - want) / np.linalg.norm(want)) > 1e-5


@pytest.mark.parametrize("b,n,rows", [(1, 60416, 64), (1, 12288, 64), (4, 12288, 64),
                                      (2, 100000, 128), (1, 1, 64)])
def test_tiled_chunk(b, n, rows):
    """One 64-row tile per block until the grid holds 8 blocks per SM."""
    chunk = tat.tiled_chunk(b, n)
    assert chunk == rows and chunk % 64 == 0
    assert chunk == 64 or b * -(-n // chunk) >= 8 * 132


@pytest.mark.parametrize("batch,feat,row_bytes,slices", [
    (64, 1024, 1024, 2), (64, 1024, 2048, 2), (128, 1024, 1024, 1), (256, 1024, 1024, 1),
    (256, 1024, 2048, 1), (384, 1024, 1024, 1), (1536, 1024, 1024, 1), (1536, 1024, 2048, 1),
    (1, 1024, 1024, 16), (1, 1024, 2048, 32), (64, 1000, 1024, 2), (64, 100, 400, 2),
    (64, 1024, 400, 2), (1, 10000, 1024, 79)])
def test_compact_slot_slices(batch, feat, row_bytes, slices):
    """K1's slices of a bag's slots: as many as fill one wave of blocks (one
    block of 256 threads per SM at these rows) where the bags are few, one a
    bag where they are many; whole tiles but the last; the slices tile the
    slots exactly; past one wave the bags go in slide order."""
    plan = compact_plan(batch, feat, row_bytes)
    per, n = plan.slot_slice, plan.slices
    assert n == slices and per % plan.rows == 0 and per <= 4096 + 64
    ranges = [(i * per, min(feat, (i + 1) * per)) for i in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == feat
    assert all(a < b for a, b in ranges) and all(ranges[i][1] == ranges[i + 1][0]
                                                 for i in range(n - 1))
    assert batch * n <= 132 or n == 1  # one wave where the bags are few
    assert plan.by_slide == (batch * n > 132)


def test_k5_shape_fills_the_card():
    """At a supervised step's 64 bags of 1024 slots: a block on all but 4 of
    the 132 SMs in one wave, each bag in two slices; at 256, 384 and 1536
    bags (MuRCL stages 2/3, supervised stage 1, MuRCL stage 1): one block per
    bag, the bags in slide order."""
    for row_bytes in (1024, 2048):
        plan = compact_plan(64, 1024, row_bytes)
        assert 64 * plan.slices == 128 and not plan.by_slide
        for batch in (256, 384, 1536):
            plan = compact_plan(batch, 1024, row_bytes)
            assert plan.slot_slice == 1024 and plan.slices == 1 and plan.by_slide


@pytest.mark.parametrize("dtype,d", [(dt, d) for dt in (torch.float32, torch.bfloat16)
                                     for d in (32, 100, 512, 1024, 2048, 4096, 16384)
                                     if d * (4 if dt == torch.float32 else 2) % 16 == 0])
@pytest.mark.parametrize("batch,feat", [(64, 1024), (1536, 1024), (1, 10240)])
def test_compact_plan_fits(batch, feat, d, dtype):
    """The ring of tiles, the slot table and the barriers fit a block's
    232,448 bytes in both dtypes; the ring keeps about 128 KB of loads in
    flight (or all that fits), at least 2 tiles; a tile is at most 64 rows
    and about 64 KB; at D 512 one block a SM (three 64 KB tiles). Rows of
    whole 16-byte vectors only (the wrapper refuses others: bf16 at D 100)."""
    row_bytes = d * torch.empty((), dtype=dtype).element_size()
    plan = compact_plan(batch, feat, row_bytes)
    tile = plan.rows * row_bytes
    assert plan.smem == 128 + -(-4 * plan.slot_slice // 128) * 128 + plan.ring * tile
    assert plan.smem <= SMEM_LIMIT == 232448
    assert 2 <= plan.ring <= 8 and 1 <= plan.rows <= 64
    assert (plan.ring - 1) * tile >= 131072 or plan.ring == 8 or \
        plan.smem + tile > SMEM_LIMIT
    assert tile <= 65536 or plan.rows == 1
    if d == 512:
        assert tile == 65536 and plan.ring == 3 and 2 * (plan.smem + 1024) > 233472
