"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Marked ``cuda``: each test skips, with its reason, where there is no CUDA
device (the kernels build with nvcc on first use and have no CPU mode). Run
on a GPU machine with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
Shapes are small; ``chip_smoke.py`` checks the main path's full shapes.
Tolerances: K1 bitwise; K4 1e-5; K2/K3 relative Frobenius 1e-4 in f32
(sum order, f32 atomics) and 2e-2 in bf16 (a one-ulp bf16 flip where an f32
sum in another order crosses a rounding boundary).
"""

import pytest
import torch

from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.ops.attention import (fused_trunk_attention_pool, fused_trunk_plain_bwd,
                                           fused_trunk_plain_fwd)
from murcl_tpu_torch.ops.compact import gather_compact, gather_compact_plain
from murcl_tpu_torch.ops.ntxent import nt_xent, nt_xent_plain
from murcl_tpu_torch.ops.select import select_ranks

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


@pytest.mark.parametrize("zero_row", [False, True])
def test_ntxent_matches_plain(dev, zero_row):
    gen = torch.Generator(device=dev).manual_seed(1)
    zi = torch.randn(32, 64, generator=gen, device=dev)
    zj = torch.randn(32, 64, generator=gen, device=dev)
    if zero_row:
        zi[2] = 0.0
    outs = []
    for fn in (nt_xent, nt_xent_plain):
        a, b = zi.clone().requires_grad_(True), zj.clone().requires_grad_(True)
        loss = fn(a, b, 0.5)
        loss.backward()
        outs.append((loss, a.grad, b.grad))
    (lk, gik, gjk), (lp, gip, gjp) = outs
    assert abs(float((lk - lp).detach())) <= 1e-5
    for g, w in ((gik, gip), (gjk, gjp)):
        torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype,rate,tol", [(torch.float32, 0.0, 1e-4),
                                            (torch.bfloat16, 0.0, 2e-2),
                                            (torch.bfloat16, 0.25, 2e-2)])
def test_fused_trunk_matches_plain(dev, dtype, rate, tol):
    gen = torch.Generator(device=dev).manual_seed(2)
    b, n, fin, l1, d = 6, 100, 128, 128, 128

    def r(*s, sc=1.0):
        return torch.randn(*s, generator=gen, device=dev) * sc

    w = [r(fin, l1, sc=fin ** -0.5), r(l1, sc=0.1), r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1),
         r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1), r(d, sc=d ** -0.5), r((), sc=0.1)]
    h = r(b, n, fin).to(dtype)
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor([100, 90, 64, 33, 100, 1],
                                                              device=dev)[:, None]
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
