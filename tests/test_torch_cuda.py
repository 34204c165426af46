"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips, with its reason, where there is no CUDA
device (the kernels build with nvcc on first use and have no CPU mode). Run
on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Shapes are small; ``chip_smoke.py`` checks the main path's full shapes.
Tolerances: K1 and K6 bitwise; K4 1e-5 (also at 256 x 128 and d = 100),
K4b's dz bitwise between two runs; K2/K3 (gated or not, with or without the
bags' gradient), K7 and K8 relative Frobenius 1e-4 in f32 (sum
order, f32 atomics) and 2e-2 in bf16 (a one-ulp bf16 flip where an f32 sum
in another order crosses a rounding boundary; the bf16 products of K2/K3 and
K7 run on the tensor cores, whose sums run in yet another order). K2/K3 and
K7 also at N = 1000 with live lengths 1, 63, 65 and 1000, and D = 384; K2/K3
at the edges of their 128-row tiles in bf16 and f32 (lengths 1, 63, 65,
127, 129 and 1000; Fin 192 and 1024; D 384; gated and ungated, with and
without dh, mixed and unmixed, dropout 0 and 0.25) and, f32, on the
heatmap's largest bag of 3,072 padded patches; K7 also at ABMIL's D 128 with F
512, in f32 (three bf16 products per product) at dropout 0 and 0.25 too,
its dx bitwise in two runs in both dtypes, and its f32 weight gradients at
ABMIL's full stage-1 shape (1536, 1024, 512), where the tensor cores' f32
sums run longest. K7 also at widths that are not multiples of 128, which
the wrappers zero-pad: (F, D) = (32, 8), the JAX PPO check's, and (512,
64), in both dtypes at dropout 0 and 0.25. K8
(whose gate pass is K7f's gate kernel: in f32 three bf16 products per
product on the tensor cores) also at F 1024 and D 384 and at the padded
widths (32, 8) and (448, 192), with a bag that ends mid-tile and one whose
later chunks are all masked; one backward through K8's op at the heatmap's
largest bag, (1, 60416, 512) f32, past K7f's softmax pass. K1 also
at 64 bags of 1000 slots, split over slot slices whose last is partial, and
bitwise on the cases of ``tests/torch_compact_cases.py`` in both dtypes, at
8 bags and at 200, past one wave, where the bags go in slide order.
The streaming feed (not a kernel, but its pinned buffers, side-stream copy
and prefetch thread exist only on the card): each staged batch bitwise the
CPU's staging of it, in f32 and bf16 banks, while the consumer's stream
lags behind the producer; the producer's error reaches the caller; and
repeated whole-split stages (the evaluations) hold one pinned buffer.
The PPO learning check (``murcl_tpu_torch/scripts/ppo_sanity.py``) runs
once at ABMIL's widths through the kernels in f32 (``chip_smoke.py`` runs
it at the JAX script's). K2/K3 also at Fin 1000 (mixed) and, with dh, Fin
192, which the wrappers zero-pad to the kernels' widths. The K2/K3
ablations (the ports of the JAX package's TPU probes,
``murcl_tpu_torch/scripts/dbg_*.py``) each against its twin at (64, 1024,
512) -> 512 -> 256, dropout 0.25, in both dtypes at the K2/K3 tolerances,
the gradients a variant skips exact zeros (lean2's dWf and dbf in bf16 at
1e-3, and dWf further from the production kernel's than from its twin's),
K2's pre-lean kernel bitwise
its lean one; the overlap probe's four modes against their twins (2e-2 on
the column sums: bf16 chains) and bitwise against each other where they
share sums.
K2/K3 at L1 200 and D 100, which the wrappers zero-pad to 256 and 128
(``pad_trunk_widths``, the dropout hashed at the logical widths), against the
twin at the logical widths, in both dtypes at dropout 0 and 0.25. The
gate-mask writer (``ops/gate_masks.py``) bitwise against its twin; each
variant of the one-hot compaction probes (``ops/compact_probes.py``) against
its twin on windows of 512 rows, bags whose slides end at 512 and 300 rows,
bitwise but ``noonehot`` (its row sums in f32 are taken in another order:
1e-2 relative Frobenius), one launch under its own name.
"""

import pytest
import torch

from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.ops.attention import (attention_pool_tiled, attention_pool_tiled_plain,
                                           fused_trunk_attention_pool, fused_trunk_plain_bwd,
                                           fused_trunk_plain_fwd, gated_attention_pool,
                                           gated_attention_pool_plain_bwd,
                                           gated_attention_pool_plain_fwd)
from murcl_tpu_torch.ops.compact import gather_compact, gather_compact_plain
from murcl_tpu_torch.ops.mixup import apply_mix, mixup_rows
from murcl_tpu_torch.ops.ntxent import (_bwd_cuda, _fwd_cuda, nt_xent, nt_xent_plain,
                                        nt_xent_plain_bwd, nt_xent_plain_fwd)
from murcl_tpu_torch.ops.select import select_ranks
from torch_compact_cases import CASES, compact_case

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("dtype,view", [(torch.float32, torch.int32),
                                        (torch.bfloat16, torch.int16)])
def test_compaction_bitwise(dev, dtype, view):
    gen = torch.Generator().manual_seed(0)
    feats, clusters = [], []
    for _ in range(6):
        n = int(torch.randint(20, 300, (), generator=gen))
        feats.append(torch.randn(n, 64, generator=gen).numpy())
        a = torch.randint(0, 4, (n,), generator=gen)
        clusters.append([torch.nonzero(a == c)[:, 0].tolist() for c in range(4)])
    bank = bank_from_arrays(feats, clusters, [0] * 6).to(dev, dtype)
    ids = torch.tensor([0, 1, 2, 3, 4, 5, 5, 0], device=dev)
    actions = torch.rand(8, 4, generator=gen).to(dev)
    ranks, offs, _ = select_ranks(ids, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                  actions, bank.patch_cluster, bank.patch_pos, 128)
    nump = bank.num_patches[ids]
    before = _cuda.LAUNCHES["compact"]
    got = gather_compact(bank.feats, offs, ranks, 128, nump)
    assert _cuda.LAUNCHES["compact"] == before + 1
    want = gather_compact_plain(bank.feats, offs, ranks, 128, nump)
    assert torch.equal(got.view(view), want.view(view))


def test_compaction_slot_slices_bitwise(dev):
    """64 bags of 1000 slots: 2 slices of 512 slots per bag, the last of 488
    (seven tiles of 64 bf16 rows and one of 40)."""
    from murcl_tpu_torch.ops.compact import compact_plan

    gen = torch.Generator().manual_seed(1)
    feats, clusters = [], []
    for _ in range(8):
        n = int(torch.randint(900, 2000, (), generator=gen))
        feats.append(torch.randn(n, 256, generator=gen).numpy())
        a = torch.randint(0, 5, (n,), generator=gen)
        clusters.append([torch.nonzero(a == c)[:, 0].tolist() for c in range(5)])
    bank = bank_from_arrays(feats, clusters, [0] * 8).to(dev, torch.bfloat16)
    ids = torch.arange(64, device=dev) % 8
    actions = torch.rand(64, 5, generator=gen).to(dev)
    ranks, offs, _ = select_ranks(ids, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                  actions, bank.patch_cluster, bank.patch_pos, 1000)
    plan = compact_plan(64, 1000, 512)
    assert (plan.slot_slice, plan.slices, plan.rows) == (512, 2, 64)
    nump = bank.num_patches[ids]
    got = gather_compact(bank.feats, offs, ranks, 1000, nump)
    want = gather_compact_plain(bank.feats, offs, ranks, 1000, nump)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("bags", [8, 200])
@pytest.mark.parametrize("case,dtype,view", [
    (c, dt, v) for c in CASES for dt, v in ((torch.float32, torch.int32),
                                            (torch.bfloat16, torch.int16))
    if not (c == "rows400" and dt == torch.bfloat16)])  # 200-byte rows: refused
def test_compaction_cases_bitwise(dev, case, dtype, view, bags):
    """K1 on the cases of ``tests/torch_compact_cases.py`` (a ragged last
    tile, 400-byte f32 rows, num_patches below nmax 4096, bags with no live
    rank, every slot live in a permuted order) at D 128, bitwise against the
    twin; at 200 bags past one wave, the bags in slide order (the order
    kernel first). One launch a call."""
    from murcl_tpu_torch.ops.compact import compact_plan

    bank, offs, ranks, nump, feat = compact_case(case, d=128, bags=bags, seed=bags)
    bank = torch.from_numpy(bank).to(dev, dtype)
    offs, ranks, nump = (torch.from_numpy(x).to(dev) for x in (offs, ranks, nump))
    plan = compact_plan(bags, feat, bank.shape[1] * bank.element_size())
    assert plan.by_slide == (bags == 200)
    before = _cuda.LAUNCHES["compact"]
    got = gather_compact(bank, offs, ranks, feat, nump)
    assert _cuda.LAUNCHES["compact"] == before + 1
    want = gather_compact_plain(bank, offs, ranks, feat, nump)
    assert torch.equal(got.view(view), want.view(view))


def _ntxent_views(dev, b, d, zero_row, seed=1):
    gen = torch.Generator(device=dev).manual_seed(seed)
    zi = torch.randn(b, d, generator=gen, device=dev)
    zj = torch.randn(b, d, generator=gen, device=dev)
    if zero_row:
        zi[b // 2] = 0.0
    return zi, zj


@pytest.mark.parametrize("zero_row", [False, True])
@pytest.mark.parametrize("b,d", [(1, 8), (32, 64), (128, 128), (256, 128), (100, 100)])
def test_ntxent_matches_plain(dev, b, d, zero_row):
    """K4f and K4b against the plain pair (the backward from the kernel's
    residual, g = 1/6 as the engine's sum / T), then the op's autograd
    against autograd of nt_xent_plain."""
    zi, zj = _ntxent_views(dev, b, d, zero_row)
    before = dict(_cuda.LAUNCHES)
    loss, stats = _fwd_cuda(zi, zj, 0.5)
    want, want_stats = nt_xent_plain_fwd(zi, zj, 0.5)
    assert _cuda.LAUNCHES["ntxent_fwd"] == before["ntxent_fwd"] + 1
    assert abs(float(loss - want)) <= 1e-5
    torch.testing.assert_close(stats, want_stats, atol=1e-5, rtol=1e-5)
    g = torch.tensor(1 / 6, device=dev)
    got = _bwd_cuda(zi, zj, 0.5, stats, g)
    assert _cuda.LAUNCHES["ntxent_bwd"] == before["ntxent_bwd"] + 1
    for gk, gp in zip(got, nt_xent_plain_bwd(zi, zj, 0.5, stats, g)):
        torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-5)

    outs = []
    for fn in (nt_xent, nt_xent_plain):
        a, c = zi.clone().requires_grad_(True), zj.clone().requires_grad_(True)
        lv = fn(a, c, 0.5)
        lv.backward()
        outs.append((lv, a.grad, c.grad))
    (lk, gik, gjk), (lp, gip, gjp) = outs
    assert abs(float((lk - lp).detach())) <= 1e-5
    for gk, gp in ((gik, gip), (gjk, gjp)):
        torch.testing.assert_close(gk, gp, atol=1e-5, rtol=1e-5)


def test_ntxent_backward_bitwise_twice(dev):
    """K4b sums in a fixed order, without atomics: two runs, the same bits."""
    zi, zj = _ntxent_views(dev, 128, 128, True, seed=2)
    _, stats = _fwd_cuda(zi, zj, 0.5)
    g = torch.tensor(1 / 6, device=dev)
    first, second = _bwd_cuda(zi, zj, 0.5, stats, g), _bwd_cuda(zi, zj, 0.5, stats, g)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("dtype,rate,tol", [(torch.float32, 0.0, 1e-4),
                                            (torch.bfloat16, 0.0, 2e-2),
                                            (torch.bfloat16, 0.25, 2e-2)])
@pytest.mark.parametrize("n,lengths,fin", [(100, [100, 90, 64, 33, 100, 1], 128),
                                           # neither the 64-row tile nor the masked tail
                                           # divides N
                                           (1000, [1, 63, 65, 1000, 999, 640], 128),
                                           # Fin % 128 != 0: dWf on 64-row output tiles
                                           (100, [100, 90, 64, 33, 100, 1], 192)])
def test_fused_trunk_matches_plain(dev, dtype, rate, tol, n, lengths, fin):
    gen = torch.Generator(device=dev).manual_seed(2)
    b, l1, d = 6, 128, 128

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(fin, l1, sc=fin ** -0.5), r(l1, sc=0.1), r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1),
         r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1), r(d, sc=d ** -0.5), r((), sc=0.1)]
    h = r(b, n, fin).to(dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    perm = torch.randperm(b, generator=gen, device=dev)
    lam = 0.9 + 0.1 * torch.rand(b, generator=gen, device=dev)
    cots = [r(b, l1), r(b, n, sc=0.1), r(b, n, sc=0.01)]
    ws = [x.clone().requires_grad_(True) for x in w]
    outs = fused_trunk_attention_pool(h, *ws, mask=mask, dropout=rate, seed=5,
                                      mix=(perm, lam))
    torch.autograd.backward(outs, cots)
    m, p, s = fused_trunk_plain_fwd(h, *w, mask, rate, 5, perm, lam)
    want = [m, p, s, *fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, rate, 5, perm, lam)]
    got = [o.detach() for o in outs] + [x.grad for x in ws]
    for name, g, wv in zip(["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc",
                            "dbc"], got, want):
        assert _rel(g, wv) <= tol, name


# live lengths around K7's 128-row tiles: a bag's tail rows are zeros to
# the tile, and no row of the next bag enters it
TILE_EDGES = [1, 63, 65, 127, 129, 1000]


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,rate,tol", [(torch.float32, 0.0, 1e-4),
                                            (torch.float32, 0.25, 1e-4),
                                            (torch.bfloat16, 0.0, 2e-2),
                                            (torch.bfloat16, 0.25, 2e-2)])
@pytest.mark.parametrize("n,f,d,lengths", [(100, 256, 128, [100, 90, 33, 64, 1]),
                                           # CLAM "big"; neither the 64-row tile nor the
                                           # masked tail divides N
                                           (1000, 512, 384, [1000, 999, 63, 65, 640]),
                                           # ABMIL's width
                                           (200, 512, 128, [200, 130, 64, 1, 199]),
                                           # the 128-row tiles' edges, at F 1024 and
                                           # every attention width
                                           (1000, 1024, 128, TILE_EDGES),
                                           (1000, 1024, 256, TILE_EDGES),
                                           (1000, 512, 384, TILE_EDGES)])
def test_attention_pool_matches_plain(dev, gated, dtype, rate, tol, n, f, d, lengths):
    _check_pool_op(dev, gated, dtype, rate, tol, n, f, d, lengths)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,rate,tol", [(torch.float32, 0.0, 1e-4),
                                            (torch.float32, 0.25, 1e-4),
                                            (torch.bfloat16, 0.0, 2e-2),
                                            (torch.bfloat16, 0.25, 2e-2)])
@pytest.mark.parametrize("f,d", [(32, 8), (512, 64)])
def test_attention_pool_padded_widths(dev, gated, dtype, rate, tol, f, d):
    """Widths the op zero-pads to multiples of 128: the JAX PPO check's (32,
    8) and ABMIL at --D 64. ``dbc`` sums ``ds = p (dp - c) + gs`` over every
    row, and its first part sums to zero, so the sum may nearly cancel: it
    alone is held to ``tol`` of ``sum |ds|``, the scale of its rounding
    error; every other output as elsewhere."""
    _check_pool_op(dev, gated, dtype, rate, tol, 300, f, d, [300, 129, 1, 64, 255],
                   dbc_over_abs_ds=True)


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("d", [896, 1024])
def test_attention_pool_bf16_wide_attention(dev, gated, rate, d):
    """bf16 from D 896: eight warps' copies of the gates backward's partials
    would leave it less than 2 stages, so each warpgroup keeps one copy, as
    f32 does at D 384. Both ops launch and hold to the plain twin."""
    _check_pool_op(dev, gated, torch.bfloat16, rate, 2e-2, 300, 512, d, [300, 129, 1, 64, 255])


def _check_pool_op(dev, gated, dtype, rate, tol, n, f, d, lengths, dbc_over_abs_ds=False):
    """K7f and K7b through the op, one launch each, against the plain twin:
    every output within ``tol``, ungated dwb and dbb zero. With
    ``dbc_over_abs_ds``, dbc's error is held to ``tol`` of the twin's
    ``sum |ds|`` in place of its own size."""
    gen = torch.Generator(device=dev).manual_seed(3)
    b = len(lengths)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(f, d, sc=f ** -0.5), r(d, sc=0.1), r(f, d, sc=f ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = r(b, n, f).to(dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    cots = [r(b, f), r(b, n, sc=0.1), r(b, n, sc=0.01)]
    xg = x.clone().requires_grad_(True)
    ws = [v.clone().requires_grad_(True) for v in w]
    before = dict(_cuda.LAUNCHES)
    outs = gated_attention_pool(xg, *ws, mask=mask, gated=gated, dropout=rate, seed=9)
    torch.autograd.backward(outs, cots)
    assert _cuda.LAUNCHES["attention_pool_fwd"] == before["attention_pool_fwd"] + 1
    assert _cuda.LAUNCHES["attention_pool_bwd"] == before["attention_pool_bwd"] + 1
    m, p, s = gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, 9)
    want = [m, p, s, *gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots, gated, rate,
                                                      9)]
    got = [o.detach() for o in outs] + [xg.grad] + [v.grad for v in ws]
    names = ["M", "p", "s", "dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    for name, g, wv in zip(names, got, want):
        if not gated and name in ("dwb", "dbb"):
            assert not g.any(), name
            continue
        if name == "dbc" and dbc_over_abs_ds:
            gm, gp, gs = cots
            dp = torch.einsum("bnf,bf->bn", x.float(), gm.to(dtype).float()) + gp
            ds = torch.where(mask, p * (dp - (p * dp).sum(-1, keepdim=True)), 0.0) + gs
            assert float((g - wv).abs()) <= tol * float(ds.abs().sum()), name
            continue
        assert _rel(g, wv) <= tol, name


def _pool_case(dev, b, n, f, d, seed=3, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(f, d, sc=f ** -0.5), r(d, sc=0.1), r(f, d, sc=f ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(b, n, f)).to(dtype)
    cots = [r(b, f), r(b, n, sc=0.1), r(b, n, sc=0.01)]
    return x, w, cots


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("d", [128, 256, 384])
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 1e-4)])
def test_attention_pool_backward_dx_bitwise_twice(dev, gated, d, rate, dtype, tol):
    """K7b's dx has no atomics on its path: two runs on the same inputs give
    the same bits, at every attention width, over bags that end mid-tile,
    in bf16 and in f32 (three bf16 products per product)."""
    from murcl_tpu_torch.ops.attention import _pool_bwd_cuda, _pool_fwd_cuda

    n = 1000
    x, w, cots = _pool_case(dev, len(TILE_EDGES), n, 1024, d, dtype=dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor(TILE_EDGES, device=dev)[:, None]
    p = _pool_fwd_cuda(x, *w, mask, gated, rate, 4)[1]
    first = _pool_bwd_cuda(x, *w[:5], mask, p, *cots, gated, rate, 4)
    second = _pool_bwd_cuda(x, *w[:5], mask, p, *cots, gated, rate, 4)
    assert torch.equal(first[0], second[0])
    want = gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots, gated, rate, 4)
    assert _rel(first[0], want[0]) <= tol


def test_attention_pool_f32_weight_grads_at_abmil_shape(dev):
    """K7b in f32 at ABMIL's stage-1 shape, (1536, 1024, 512) ungated at D
    128 (R = 1,572,864 rows): dWa's three-product sums over each row split
    stay within 1e-4 of the f32 twin, as every other output does."""
    from murcl_tpu_torch.ops.attention import _pool_bwd_cuda, _pool_fwd_cuda

    b, n = 1536, 1024
    x, w, cots = _pool_case(dev, b, n, 512, 128, seed=5, dtype=torch.float32)
    mask = torch.ones(b, n, dtype=torch.bool, device=dev)
    p = _pool_fwd_cuda(x, *w, mask, False, 0.0, 0)[1]
    got = _pool_bwd_cuda(x, *w[:5], mask, p, *cots, False, 0.0, 0)
    want = gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots, False)
    for name, g, wv in zip(["dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"], got, want):
        if name in ("dwb", "dbb"):
            assert not g.any(), name
            continue
        assert _rel(g, wv) <= 1e-4, name


@pytest.mark.parametrize("b,n", [(1, 60416), (2, 100000)])
def test_attention_pool_backward_long_bags_bf16(dev, b, n):
    """K7b in bf16 at the heatmap's largest bag and longer: no block holds a
    term in N."""
    from murcl_tpu_torch.ops.attention import _pool_bwd_cuda

    f, d = 512, 256
    x, w, cots = _pool_case(dev, b, n, f, d)
    mask = torch.arange(n, device=dev)[None, :] < n - 416
    p = gated_attention_pool_plain_fwd(x, *w, mask)[1]
    got = _pool_bwd_cuda(x, *w[:5], mask, p, *cots, True, 0.0, 0)
    want = gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots)
    for name, g, wv in zip(["dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"], got, want):
        assert _rel(g, wv) <= 2e-2, name


@pytest.mark.parametrize("dtype,view", [(torch.float32, torch.int32),
                                        (torch.bfloat16, torch.int16)])
@pytest.mark.parametrize("shape", [(12, 100, 128), (6, 7, 33)])  # the second: scalar tail
def test_mixup_rows_bitwise(dev, dtype, view, shape):
    gen = torch.Generator(device=dev).manual_seed(4)
    x = (torch.randn(*shape, generator=gen, device=dev) * 3).to(dtype)
    b = shape[0]
    perm = torch.cat([torch.randperm(b // 2, generator=gen, device=dev),
                      torch.randperm(b - b // 2, generator=gen, device=dev) + b // 2])
    lam = 0.9 + 0.1 * torch.rand(b, generator=gen, device=dev)
    before = _cuda.LAUNCHES["mixup_rows"]
    got = mixup_rows(x, perm, lam)
    assert _cuda.LAUNCHES["mixup_rows"] == before + 1
    want = apply_mix(x, perm, lam)
    assert torch.equal(got.view(view), want.view(view))


@pytest.mark.parametrize("gated,need_dh", [(False, False), (False, True), (True, True)])
@pytest.mark.parametrize("dtype,rate,tol", [(torch.float32, 0.0, 1e-4),
                                            (torch.bfloat16, 0.0, 2e-2),
                                            (torch.bfloat16, 0.25, 2e-2)])
@pytest.mark.parametrize("d", [128, 384])  # 384: CLAM "big"'s attention width
def test_fused_trunk_modes_match_plain(dev, gated, need_dh, dtype, rate, tol, d):
    gen = torch.Generator(device=dev).manual_seed(5)
    b, n, fin, l1 = 5, 100, 128, 128

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(fin, l1, sc=fin ** -0.5), r(l1, sc=0.1), r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1),
         r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1), r(d, sc=d ** -0.5), r((), sc=0.1)]
    h = r(b, n, fin).to(dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor([100, 64, 33, 100, 1],
                                                              device=dev)[:, None]
    cots = [r(b, l1), r(b, n, sc=0.1), r(b, n, sc=0.01)]
    hg = h.clone().requires_grad_(need_dh)
    ws = [x.clone().requires_grad_(True) for x in w]
    outs = fused_trunk_attention_pool(hg, *ws, mask=mask, dropout=rate, seed=6, gated=gated)
    torch.autograd.backward(outs, cots)
    m, p, s = fused_trunk_plain_fwd(h, *w, mask, rate, 6, gated=gated)
    grads = fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, rate, 6, gated=gated,
                                  need_dh=need_dh)
    names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    got = [o.detach() for o in outs] + [x.grad for x in ws]
    want = [m, p, s, *grads[:8]]
    if need_dh:
        names.append("dh")
        got.append(hg.grad)
        want.append(grads[8])
    for name, g, wv in zip(names, got, want):
        if not gated and name in ("dwb", "dbb"):
            assert not g.any(), name
            continue
        assert _rel(g, wv) <= tol, name


# K2/K3's warpgroup kernels (128-row tiles, wgmma fed by TMA; in f32 three
# bf16 products of each operand's planes) at their edges: N that neither
# the 128-row tile nor the mask divides, Fin 192 (a 64-column slice past the
# last 128-row dWf tile) and 1024, D 384, gated and ungated, the bags'
# gradient, mixed and unmixed
_WG_LENGTHS = [1, 63, 65, 127, 129, 1000]
_WG_EDGES = [
    (192, 128, 128, True, False, True),
    (1024, 512, 256, True, False, True),
    (1024, 512, 384, False, True, False),
    (256, 256, 384, True, True, False),
    (192, 512, 384, False, False, True),
]


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("fin,l1,d,gated,need_dh,mixed", _WG_EDGES)
def test_fused_trunk_wg_edges_match_plain(dev, rate, fin, l1, d, gated, need_dh, mixed):
    _fused_edges(dev, torch.bfloat16, 2e-2, rate, fin, l1, d, gated, need_dh, mixed)


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("fin,l1,d,gated,need_dh,mixed", _WG_EDGES)
def test_fused_trunk_f32_edges_match_plain(dev, rate, fin, l1, d, gated, need_dh, mixed):
    _fused_edges(dev, torch.float32, 1e-4, rate, fin, l1, d, gated, need_dh, mixed)


@pytest.mark.parametrize("gated", [True, False])
def test_fused_trunk_f32_heatmap_bag(dev, gated):
    # the heatmap's largest bag on K2 in f32: 3,072 padded patches, 2,000 live
    _fused_edges(dev, torch.float32, 1e-4, 0.0, 512, 512, 256, gated, False, False,
                 lengths=[2000], n=3072)


def _fused_edges(dev, dtype, tol, rate, fin, l1, d, gated, need_dh, mixed,
                 lengths=_WG_LENGTHS, n=1000):
    gen = torch.Generator(device=dev).manual_seed(8)
    b = len(lengths)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(fin, l1, sc=fin ** -0.5), r(l1, sc=0.1), r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1),
         r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1), r(d, sc=d ** -0.5), r((), sc=0.1)]
    h = r(b, n, fin).to(dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    perm = torch.randperm(b, generator=gen, device=dev)
    lam = 0.9 + 0.1 * torch.rand(b, generator=gen, device=dev)
    mix = (perm, lam) if mixed else None
    cots = [r(b, l1), r(b, n, sc=0.1), r(b, n, sc=0.01)]
    hg = h.clone().requires_grad_(need_dh)
    ws = [x.clone().requires_grad_(True) for x in w]
    before = dict(_cuda.LAUNCHES)
    outs = fused_trunk_attention_pool(hg, *ws, mask=mask, dropout=rate, seed=7, mix=mix,
                                      gated=gated)
    torch.autograd.backward(outs, cots)
    assert _cuda.LAUNCHES["fused_trunk_fwd"] == before["fused_trunk_fwd"] + 1
    assert _cuda.LAUNCHES["fused_trunk_bwd"] == before["fused_trunk_bwd"] + 1
    pm = (perm, lam) if mixed else (None, None)
    m, p, s = fused_trunk_plain_fwd(h, *w, mask, rate, 7, *pm, gated=gated)
    grads = fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, rate, 7, *pm, gated=gated,
                                  need_dh=need_dh)
    names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    got = [o.detach() for o in outs] + [x.grad for x in ws]
    want = [m, p, s, *grads[:8]]
    if need_dh:
        names.append("dh")
        got.append(hg.grad)
        want.append(grads[8])
    for name, g, wv in zip(names, got, want):
        if not gated and name in ("dwb", "dbb"):
            assert not g.any(), name
            continue
        assert _rel(g, wv) <= tol, name


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,n", [(1, 3000), (4, 700)])
def test_attention_pool_tiled_matches_plain(dev, gated, dtype, tol, b, n):
    """K8 (chunks of 64 rows, a ragged last one) against its twin, with a
    masked tail; one backward through the op (K7b) in f32."""
    gen = torch.Generator(device=dev).manual_seed(7)
    f, d = 256, 128

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(f, d, sc=f ** -0.5), r(d, sc=0.1), r(f, d, sc=f ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(b, n, f)).to(dtype)
    lengths = torch.tensor([n - 37, n // 3, 1, n][:b], device=dev)
    mask = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    xg = x.clone().requires_grad_(dtype == torch.float32)
    before = dict(_cuda.LAUNCHES)
    outs = attention_pool_tiled(xg, *w, mask=mask, gated=gated)
    assert _cuda.LAUNCHES["attention_pool_tiled"] == before["attention_pool_tiled"] + 1
    want = attention_pool_tiled_plain(x, *w, mask, gated)
    for name, g, wv in zip("Mps", outs, want):
        assert _rel(g.detach(), wv) <= tol, name
    if dtype == torch.float32:
        cots = [r(b, f), r(b, n, sc=0.1), r(b, n, sc=0.01)]
        torch.autograd.backward(outs, cots)
        assert _cuda.LAUNCHES["attention_pool_bwd"] == before["attention_pool_bwd"] + 1
        dx = gated_attention_pool_plain_bwd(x, *w[:5], mask, want[1], *cots, gated)[0]
        assert _rel(xg.grad, dx) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("f,d,gated", [(1024, 128, True), (512, 384, True), (1024, 256, False),
                                       (32, 8, True), (448, 192, False)])
def test_attention_pool_tiled_widths(dev, dtype, tol, f, d, gated):
    """K8 at F 1024 and D 384, and at widths the wrapper zero-pads to
    multiples of 128: bags of 5000 rows (78 full 64-row chunks and a 8-row
    one), one live for 4100 rows (mid-chunk), one for 65 (its later chunks
    all masked)."""
    gen = torch.Generator(device=dev).manual_seed(9)

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    n = 5000
    w = [r(f, d, sc=f ** -0.5), r(d, sc=0.1), r(f, d, sc=f ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(3, n, f)).to(dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor([n, 4100, 65], device=dev)[:, None]
    got = attention_pool_tiled(x, *w, mask=mask, gated=gated)
    want = attention_pool_tiled_plain(x, *w, mask, gated)
    for name, g, wv in zip("Mps", got, want):
        assert _rel(g, wv) <= tol, name


def test_attention_pool_tiled_backward_at_the_largest_heatmap_bag(dev):
    """(1, 60416, 512) f32: K7b's blocks hold no term in N, so the op's
    backward runs where K7f's softmax pass could not."""
    gen = torch.Generator(device=dev).manual_seed(3)
    n, f, d = 60416, 512, 256

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(f, d, sc=f ** -0.5), r(d, sc=0.1), r(f, d, sc=f ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(1, n, f))
    mask = torch.arange(n, device=dev)[None, :] < 60000
    xg = x.clone().requires_grad_(True)
    ws = [v.clone().requires_grad_(True) for v in w]
    before = _cuda.LAUNCHES["attention_pool_bwd"]
    outs = attention_pool_tiled(xg, *ws, mask=mask)
    cots = [r(1, f), r(1, n, sc=0.1), r(1, n, sc=0.01)]
    torch.autograd.backward(outs, cots)
    assert _cuda.LAUNCHES["attention_pool_bwd"] == before + 1
    p = attention_pool_tiled_plain(x, *w, mask)[1]
    want = gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots)
    for name, g, wv in zip(["dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"],
                           [xg.grad] + [v.grad for v in ws], want):
        assert _rel(g, wv) <= 1e-4, name


@pytest.mark.parametrize("f,d", [(512, 256), (1024, 128), (128, 384)])
def test_split_planes_bitwise(dev, f, d):
    """K7's and K8's f32 weights split on the card: the bits of
    ``w_planes``."""
    from murcl_tpu_torch.ops.attention import _w_planes_cuda, w_planes

    w = torch.randn(f, d, generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    got = _w_planes_cuda("split", w)
    assert torch.equal(got.view(torch.int16), w_planes(w).view(torch.int16))


@pytest.mark.parametrize("variant", ["ycbcr444", "ycbcr420", "rgb"])
def test_nvjpeg_against_the_fixture(dev, variant):
    """nvJPEG's decode of the committed tiles against PIL's, within
    ``FIXTURE_BOUND``; then a JPEG-tiled TIFF of those tiles through
    ``TiffSlide`` on the card, within the same bound of PIL's pixels."""
    import numpy as np

    from murcl_tpu_torch.data.synthetic import write_jpeg_fixture_tiff
    from murcl_tpu_torch.preprocess.nvjpeg import FIXTURE_BOUND, NvJpegDecoder, load_fixture
    from murcl_tpu_torch.preprocess.slide_io import TiffSlide

    fx = load_fixture()[variant]
    top, mean = FIXTURE_BOUND[variant]
    dec = NvJpegDecoder(dev)
    try:
        for stream, want in zip(fx["streams"], fx["decoded"]):
            got = dec(fx["tables"][:-2] + stream[2:], fx["photometric"])
            diff = np.abs(got.astype(int) - want)
            assert got.shape == want.shape
            assert diff.max() <= top and diff.mean() <= mean, (diff.max(), diff.mean())
        assert dec.decoded == 4
    finally:
        dec.close()
    import tempfile
    from pathlib import Path

    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / f"{variant}.tif"
        img = write_jpeg_fixture_tiff(path, variant, repeat=2)
        slide = TiffSlide(path, device=dev)
        got = slide.read_region((10, 5), 0, (170, 100))
        diff = np.abs(got[:91, :, :3].astype(int) - img[5:, 10:180])
        assert diff.max() <= top and diff.mean() <= mean, (diff.max(), diff.mean())
        assert (got[91:] == 0).all() and slide._jpeg.decoded == 8
        slide.close()


def test_nvjpeg_against_the_256_fixture(dev):
    """nvJPEG's decode of the committed 256-pixel YCbCr 4:2:0 tiles (a
    slide's tile size) against PIL's, within ``FIXTURE_BOUND``; then a
    JPEG-tiled pyramid of them through ``TiffSlide`` on the card, every
    level within the same bound."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from murcl_tpu_torch.data.synthetic import write_jpeg_fixture_tiff
    from murcl_tpu_torch.preprocess.nvjpeg import (FIXTURE_256, FIXTURE_BOUND, NvJpegDecoder,
                                                   load_fixture)
    from murcl_tpu_torch.preprocess.slide_io import TiffSlide

    fx = load_fixture(FIXTURE_256)["ycbcr420"]
    top, mean = FIXTURE_BOUND["ycbcr420"]
    dec = NvJpegDecoder(dev)
    try:
        for stream, want in zip(fx["streams"], fx["decoded"]):
            got = dec(fx["tables"][:-2] + stream[2:], fx["photometric"])
            diff = np.abs(got.astype(int) - want)
            assert got.shape == want.shape == (256, 256, 3)
            assert diff.max() <= top and diff.mean() <= mean, (diff.max(), diff.mean())
    finally:
        dec.close()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "pyramid.svs"
        img = write_jpeg_fixture_tiff(path, "ycbcr420", fixture=FIXTURE_256, size=(2048, 1024),
                                      downsamples=(1, 4))
        slide = TiffSlide(path, device=dev)
        assert slide.level_dimensions == ((2048, 1024), (512, 256))
        for level, want in ((0, img), (1, img[:256, :512])):
            got = slide.read_region((0, 0), level, slide.level_dimensions[level])[..., :3]
            diff = np.abs(got.astype(int) - want)
            assert diff.max() <= top and diff.mean() <= mean, (level, diff.max(), diff.mean())
        slide.close()


@pytest.mark.parametrize("h, w, fv, fh", [(256, 256, 2, 2), (255, 97, 2, 2), (64, 33, 1, 2),
                                          (31, 64, 2, 1), (48, 40, 1, 1), (1, 7, 2, 2)])
def test_ycc_to_rgb_kernel_against_its_twin(dev, h, w, fv, fh):
    """``csrc/ycc_rgb.cu`` (libjpeg's upsampling and colour conversion on
    nvJPEG's planes) bit for bit with its plain twin, over every chroma
    layout and odd sizes, one launch counted per call."""
    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.preprocess.nvjpeg import ycc_to_rgb, ycc_to_rgb_plain

    g = torch.Generator(device=dev).manual_seed(h * w)
    ch, cw = -(-h // fv), -(-w // fh)
    y = torch.randint(0, 256, (h, w), generator=g, device=dev, dtype=torch.uint8)
    cb, cr = (torch.randint(0, 256, (ch, cw), generator=g, device=dev, dtype=torch.uint8)
              for _ in range(2))
    before = _cuda.LAUNCHES["ycc_to_rgb"]
    got = ycc_to_rgb(y, cb, cr)
    assert _cuda.LAUNCHES["ycc_to_rgb"] == before + 1
    assert torch.equal(got, ycc_to_rgb_plain(y, cb, cr))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_streaming_feed_on_the_card(dev, tmp_path, dtype):
    import numpy as np

    from murcl_tpu_torch.data.streaming import StreamingBank
    from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset

    ds = generate_synthetic_dataset(tmp_path, num_slides=9, dim=64, num_clusters=4,
                                    min_patches=50, max_patches=400)
    host = StreamingBank(ds["data_csv"], dtype=dtype, max_patches=512)
    stream = StreamingBank(ds["data_csv"], device=dev, dtype=dtype, max_patches=512)
    view = torch.int32 if dtype == torch.float32 else torch.int16
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 9, size=n) for n in (3, 12, 5, 20, 2, 16, 7)]  # buffers grow
    for (bank, sid), ids in zip(stream.iter_epoch(batches), batches):
        torch.cuda._sleep(20_000_000)  # the step lags; the producer stages ahead
        want, want_sid = host.stage(ids)
        assert torch.equal(bank.feats.cpu().view(view), want.feats.view(view))
        for name in ("offsets", "num_patches", "cluster_sizes", "patch_cluster", "patch_pos",
                     "labels"):
            assert torch.equal(getattr(bank, name).cpu(), getattr(want, name)), name
        assert torch.equal(sid.cpu(), want_sid) and bank.patch_cluster.shape[1] == 512
    assert all("events" in rec for rec in stream.stage_log)

    def failing(ids, k):
        raise OSError("feature file vanished")

    stream._stage = failing
    with pytest.raises(OSError, match="vanished"):
        next(stream.iter_epoch(batches))


def test_whole_split_stages_reuse_one_pinned_buffer(dev, tmp_path):
    """Evaluations stage their whole split with ``stage``: two of them leave
    one pinned buffer of the split's rows, and each gives the host's bits."""
    from murcl_tpu_torch.data.streaming import StreamingBank
    from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset

    ds = generate_synthetic_dataset(tmp_path, num_slides=6, dim=64, num_clusters=4,
                                    min_patches=50, max_patches=400)
    want, _ = StreamingBank(ds["data_csv"]).stage(range(6))
    stream = StreamingBank(ds["data_csv"], device=dev)
    for _ in range(2):
        bank, _ = stream.stage(range(6))
        assert torch.equal(bank.feats.cpu(), want.feats)
    torch.cuda.synchronize()
    held = [b for b in stream._buffers if b is not None]
    assert len(held) == 1 and held[0].shape == want.feats.shape and held[0].is_pinned()


def test_data_parallel_step_on_one_card(dev, tmp_path):
    """Two ranks on ``cuda:0`` over gloo (they share the card): one MuRCL
    CLAM_SB stage-1 step (K1, K2/K3, K4 on each rank; Fin 64, CLAM small, f32,
    b = 3 per rank) equals the single-process step fed the ranks' draws
    concatenated, the mixup partners kept in each rank's block: loss within
    rtol 1e-5, weights after the Adam step within rtol 1e-4 plus 1e-6, the
    score bias (true gradient 0) within the rate of its start; the two
    ranks' weights bitwise equal."""
    import numpy as np
    from torch_dp_ranks import ALPHA, LR, K, T, run_case, run_cases

    from murcl_tpu_torch.models import CLAM_SB, FullLayer
    from murcl_tpu_torch.ops.mixup import mixup_factors
    from murcl_tpu_torch.parallel import Ranks, launch

    n, b, dim = 2, 3, 64
    rng = np.random.default_rng(0)
    feats, clusters = [], []
    for _ in range(8):
        rows = int(rng.integers(30, 80))
        feats.append(rng.normal(size=(rows, dim)).astype(np.float32))
        a = rng.integers(0, K, size=rows)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    torch.manual_seed(0)
    model = CLAM_SB(in_dim=dim, gate=True, size_arg="small", dropout=0.0, n_classes=8,
                    subtyping=True)
    fc = FullLayer(feature_num=512, hidden_state_dim=32, class_num=8)
    gen = torch.Generator().manual_seed(1)
    draws = []
    for _ in range(n):
        mix = [mixup_factors(gen, b, ALPHA) for _ in range(T * 2)]
        draws.append({"actions": torch.rand((T, 2, b, K), generator=gen),
                      "mix": (torch.stack([m[0] for m in mix]), torch.stack([m[1] for m in mix]))})
    case = {"kind": "contrastive", "arch": "CLAM_SB", "stage": 1, "dim": dim, "size": "small",
            "feats": feats, "clusters": clusters, "labels": [0] * 8,
            "ids": rng.permutation(8)[:n * b], "model": model.state_dict(),
            "fc": fc.state_dict(), "policy": None, "draws": draws}
    got = launch(n, run_cases, [case], device=dev, run_dir=tmp_path)
    outs = [value[0] for value, _ in got]
    for _, launches in got:
        assert all(launches[k] > 0 for k in ("compact", "fused_trunk_fwd", "fused_trunk_bwd",
                                             "ntxent_fwd", "ntxent_bwd")), launches
    single = dict(case, draws=[{
        "actions": torch.cat([d["actions"] for d in draws], dim=2),
        "mix": (torch.cat([d["mix"][0] for d in draws], dim=1),
                torch.cat([d["mix"][1] + r * b for r, d in enumerate(draws)], dim=1))}])
    want = run_case(Ranks(device=dev), single)
    np.testing.assert_allclose(float(outs[0]["loss"]), float(want["loss"]), rtol=1e-5)
    for part in ("model", "fc"):
        for k, v in want[part].items():
            assert torch.equal(outs[0][part][k], outs[1][part][k]), (part, k)
            if k.endswith("attention_c.bias"):
                assert float((v - case["model"][k]).abs().max()) <= 1.01 * LR
                continue
            np.testing.assert_allclose(outs[0][part][k].numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=f"{part}.{k}")


def test_ppo_sanity_on_card(dev):
    """The PPO learning check at ABMIL's widths (dim 512, L 512, D 128)
    through the kernels in f32: the JAX script's keys, K1, K7f and K7b
    launched and nothing else, finite readings, stage 1 learning and both
    confidences above 0.75 (the PPO directions are rounding's at these widths:
    ``murcl_tpu_torch/scripts/ppo_sanity.py``)."""
    import math

    from murcl_tpu_torch.scripts import ppo_sanity

    _cuda.reset_launch_counts()
    s = ppo_sanity.run(dev, dim=512, L=512, D=128)
    launched = {k for k, v in _cuda.LAUNCHES.items() if v}
    assert launched == {"compact", "attention_pool_fwd", "attention_pool_bwd"}, _cuda.LAUNCHES
    report = s.report()
    assert len(report) == 9 and len(report["rewards_per_epoch"]) == ppo_sanity.EPOCHS
    assert all(math.isfinite(v) for v in [*s.stage1_losses, *s.rewards, *s.actions])
    assert sum(s.stage1_losses[-10:]) < 0.5 * sum(s.stage1_losses[:10])
    assert min(s.conf_random, s.conf_policy) > 0.75, report


# K2/K3 at feature widths their kernels do not take, zero-padded by the
# wrappers (pad_trunk_fin): Fin 1000 to 1024, and with the bags' gradient
# Fin 192 to 256 (dh's 128-column passes), dh and dWf sliced back
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fin,need_dh,mixed", [(1000, False, True), (192, True, False)])
def test_fused_trunk_padded_fin_matches_plain(dev, rate, dtype, tol, fin, need_dh, mixed):
    _fused_edges(dev, dtype, tol, rate, fin, 256, 128, True, need_dh, mixed,
                 lengths=[1000, 129, 1], n=1000)


ABLATE_SHAPE = (64, 1024, 512, 512, 256)  # B, N, Fin, L1, D
BWD_GRADS = ["dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
# the gradients each ablation of K3 leaves zero (the passes it skips)
BWD_ZERO = {"full": (), "nodrop": (), "prelean": (), "lean2": (),
            "nowgrad": ("dwf", "dbf", "dwa", "dba", "dwb", "dbb"), "nodx": ("dwf", "dbf"),
            "recompute": ("dwf", "dbf", "dwa", "dba", "dwb", "dbb")}


def _ablate_inputs(dev, dtype):
    """The JAX probes' operands at B 64, with a cotangent of the scores of
    scale 0.01: at the probes' gs = 0, dbc sums p (dp - c), which cancels
    to rounding noise whatever computes it."""
    from murcl_tpu_torch.scripts.probes import trunk_inputs

    h, w, mask, p, (gm, gp, _) = trunk_inputs(ABLATE_SHAPE, dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    return h, w, mask, p, (gm, gp, torch.randn(p.shape, generator=gen, device=dev) * 0.01)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("variant", list(BWD_ZERO))
def test_trunk_bwd_ablations_match_twins(dev, dtype, tol, variant):
    """Each ablation of K3 against its twin at dropout 0.25, on the JAX
    probes' inputs at B 64: the kept gradients within the K2/K3 tolerance,
    the skipped ones exact zeros; one launch under its own name."""
    from murcl_tpu_torch.ops.attention import fused_trunk_ablate_bwd

    h, w, mask, p, cots = _ablate_inputs(dev, dtype)
    before = dict(_cuda.LAUNCHES)
    got = fused_trunk_ablate_bwd(variant, h, *w[:7], mask, p, *cots, 0.25, 7)
    changed = {k for k, v in _cuda.LAUNCHES.items() if v != before[k]}
    assert changed == {f"trunk_bwd_{variant}"}
    want = fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, 0.25, 7, variant=variant)
    # lean2 in bf16: dWf and dbf, which its one rounding of dx moves, held
    # between that move and the kernel's noise against its twin, and dWf
    # further from the production kernel's than from the twin's
    lean2 = variant == "lean2" and dtype == torch.bfloat16
    for name, g, wv in zip(BWD_GRADS, got, want):
        if name in BWD_ZERO[variant]:
            assert not g.any() and not wv.any(), name
            continue
        lim = 1e-3 if lean2 and name in ("dwf", "dbf") else tol
        assert _rel(g, wv) <= lim, (name, _rel(g, wv))
    if lean2:
        prod = fused_trunk_ablate_bwd("full", h, *w[:7], mask, p, *cots, 0.25, 7)
        assert _rel(got[0], prod[0]) > 2 * _rel(got[0], want[0])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_trunk_fwd_ablations_match_twins(dev, dtype, tol):
    """K2's lean (production) and pre-lean kernels against their twins, and
    against each other bitwise (products by exact 1 or 0)."""
    from murcl_tpu_torch.ops.attention import fused_trunk_ablate_fwd

    h, w, mask, _, _ = _ablate_inputs(dev, dtype)
    outs = {}
    for variant in ("lean", "prelean"):
        outs[variant] = fused_trunk_ablate_fwd(variant, h, *w, mask, 0.25, 7)
        want = fused_trunk_plain_fwd(h, *w, mask, 0.25, 7, lean=variant == "lean")
        for name, g, wv in zip("Mps", outs[variant], want):
            assert _rel(g, wv) <= tol, (variant, name)
    for g, wv in zip(outs["lean"], outs["prelean"]):
        assert torch.equal(g, wv)


def test_overlap_modes_match_twins(dev):
    """The overlap probe's four modes against their twins (bf16 chains: the
    kernel's tanhf, sigmoidf and product sums round apart from torch's, 2e-2
    relative on the column sums), and the modes' shared sums bitwise: dep's
    m is mxu's, indep's (m, v) are (mxu's m, vpu's v)."""
    from murcl_tpu_torch.ops.overlap import MODES, overlap_plain, wgmma_overlap
    from murcl_tpu_torch.scripts.dbg_mxu_vpu_overlap import inputs

    x, y, w = inputs(dev, 6, 256)
    got = {}
    for mode in MODES:
        before = _cuda.LAUNCHES[f"overlap_{mode}"]
        got[mode] = wgmma_overlap(mode, x, y, w)
        assert _cuda.LAUNCHES[f"overlap_{mode}"] == before + 1
        for name, g, wv in zip("mv", got[mode], overlap_plain(mode, x, y, w)):
            assert _rel(g, wv) <= 2e-2, (mode, name, _rel(g, wv))
    assert torch.equal(got["dep"][0], got["mxu"][0])
    assert torch.equal(got["indep"][0], got["mxu"][0])
    assert torch.equal(got["indep"][1], got["vpu"][1])


# K2/K3 at L1 and D that are not multiples of 128: zero-padded by the
# wrappers, the dropout hashed at the logical widths, the outputs sliced back,
# against the twin at the logical widths
@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("fin,gated,need_dh,mixed", [(512, True, False, True),
                                                     (192, True, True, False),
                                                     (512, False, False, False)])
def test_fused_trunk_padded_widths_match_plain(dev, rate, dtype, tol, fin, gated, need_dh,
                                               mixed):
    _fused_edges(dev, dtype, tol, rate, fin, 200, 100, gated, need_dh, mixed,
                 lengths=[1000, 129, 1], n=1000)


@pytest.mark.parametrize("b,n,d", [(3, 70, 40), (8, 256, 256)])
def test_gate_masks_match_twin(dev, b, n, d):
    from murcl_tpu_torch.ops.gate_masks import gate_keep_masks, gate_keep_masks_plain

    before = _cuda.LAUNCHES["gate_masks"]
    got = gate_keep_masks(11, 0.25, b, n, d, dev)
    assert _cuda.LAUNCHES["gate_masks"] == before + 1
    for g, wv in zip(got, gate_keep_masks_plain(11, 0.25, b, n, d, dev)):
        assert g.dtype == torch.bool and torch.equal(g, wv)


def _onehot_inputs(dev, script):
    """Windows of 512 rows at D 128, feat 384: 6 bags (compact), or 2 slides
    x 4 repeats (grouped); slides end at 512 and 300 rows, the ranks past
    them -1."""
    from murcl_tpu_torch.scripts.probes import compact_inputs

    slides = 0 if script == "compact" else 2
    b = 6 if script == "compact" else 8
    bank, offs, ranks, nump = compact_inputs(b, 512, 128, 384, dev, slides=slides)
    ends = torch.tensor([512, 300], device=dev)[torch.arange(b, device=dev) % 2]
    ranks = torch.where(torch.arange(512, device=dev)[None, :] < ends[:, None], ranks, -1)
    return bank, offs, ranks.contiguous(), ends, slides


_ONEHOT = [(s, v) for s, vs in (("compact", ("full", "dmafloor", "normw", "bf16acc", "leanoh",
                                             "bf16lean")),
                                ("grouped", ("full", "dmafloor", "normw", "noonehot", "leanoh",
                                             "chunk16")),
                                ("gate", ("copy", "nolive", "noinner", "nogate"))) for v in vs]


@pytest.mark.parametrize("script,variant", _ONEHOT)
def test_onehot_compaction_probes_match_twins(dev, script, variant):
    from murcl_tpu_torch.ops.compact_probes import (KEEPS_RESULT, PROBES, onehot_compact,
                                                    onehot_compact_plain)

    bank, offs, ranks, nump, slides = _onehot_inputs(dev, script)
    name = f"onehot_{script}_{variant}"
    before = _cuda.LAUNCHES[name]
    got = onehot_compact(script, variant, bank, offs, ranks, 384, nump, slides)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name] == before + 1
    want = onehot_compact_plain(PROBES[script][variant], bank, offs, ranks, 384, nump, slides)
    if variant == "noonehot":
        assert _rel(got.float(), want.float()) <= 1e-2
    else:
        assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    if (script, variant) in KEEPS_RESULT:
        assert torch.equal(got, gather_compact_plain(bank, offs, ranks, 384, nump))
