"""K2/K3's float32 route, as arithmetic on the CPU, against the JAX package.

On the card the f32 route of the fused trunk (``csrc/fused_trunk.cu`` with
T = float) takes every f32 product as three bf16 products of the operands'
planes (:func:`split_bf16`: ``hi hi + hi lo + lo hi``, summed in f32), and
writes each tile that goes through device memory (xc, ``[dza | dzb]``, dz)
as its two planes: ``M = p @ (xc_hi + xc_lo)``, the bias gradients sum
``hi + lo``, relu' reads ``xc_hi > 0``. The trunk's pre-activations whose
``|z|`` lies within ``2**-15 ||h row|| ||Wf column||`` of 0 are taken again
as f32 products (the kernel's ``refine``): without that, relu's kink
flips on a few of them and dWf and dh miss 1e-4 (``test_refine_is_needed``).
``_x3_fwd`` and ``_x3_bwd`` take
the same products in the kernels' order of operations, in plain torch, and
are held against the JAX package's f32 fused trunk (its Pallas kernels in
interpret mode, as ``tests/test_torch_fused_modes.py`` runs them) on the
same numpy-seeded weights and bags: M, p, s, the 8 weight gradients and dh
to a relative Frobenius error of 1e-4, the tolerance ``chip_smoke.py``
holds the f32 kernels to. Gated and ungated, mixed and unmixed, the bags'
gradient (unmixed), bags of 256-384 rows with masked tails, widths 512 ->
256 -> 128, dropout 0 (the TPU draws its masks from its own PRNG). The
model is the design's check before any card run; the kernels themselves
are held against the plain twins on the card (``tests/test_torch_cuda.py``
``-k f32``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu_torch.ops.attention import split_bf16
from murcl_tpu_torch.ops.mixup import apply_mix

B, FIN, L1, D = 3, 512, 256, 128
NAMES = ["wf", "bf", "wa", "ba", "wb", "bb", "wc", "bc"]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gap.pl, "pallas_call", interp)


def _mm3(a, b):
    """``a @ b`` as the f32 route's products take it: three bf16 products of
    the operands' planes, summed in f32."""
    ah, al = (t.float() for t in split_bf16(a))
    bh, bl = (t.float() for t in split_bf16(b))
    return ah @ bh + ah @ bl + al @ bh


def _planes(t):
    """``t`` as it comes back from its two planes: ``hi + lo``."""
    hi, lo = split_bf16(t)
    return hi.float() + lo.float()


def _trunk(h, w, mix, gated, refine=True):
    """The forward's recompute: the (mixed) bags, xc, a and g (None
    ungated)."""
    wf, bf, wa, ba, wb, bb = w[:6]
    hm = apply_mix(h, *mix) if mix is not None else h
    z = _mm3(hm, wf)
    if refine:  # near relu's kink, the f32 product
        near = (z + bf).abs() <= 2.0 ** -15 * hm.norm(dim=-1, keepdim=True) * wf.norm(dim=0)
        z = torch.where(near, hm @ wf, z)
    xc = torch.relu(z + bf)
    a = torch.tanh(_mm3(xc, wa) + ba)
    g = torch.sigmoid(_mm3(xc, wb) + bb) if gated else None
    return hm, xc, a, g


def _x3_fwd(h, w, mask, mix, gated):
    _, xc, a, g = _trunk(h, w, mix, gated)
    u = a * g if gated else a
    s = u @ w[6] + w[7]
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
    m = torch.einsum("bn,bnl->bl", p, _planes(xc))
    return m, p, s


def _x3_bwd(h, w, mask, p, cots, mix, gated, need_dh, refine=True):
    wf, wa, wb, wc = w[0], w[2], w[4], w[6]
    gm, gp, gs = cots
    hm, xc, a, g = _trunk(h, w, mix, gated, refine)
    u = a * g if gated else a
    dp = (xc * gm[:, None, :]).sum(-1) + gp  # the trunk pass's f32 xc
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros_like(ds)) + gs
    dbc, dwc = ds.sum(), torch.einsum("bnd,bn->d", u, ds)
    du = ds[..., None] * wc
    dza = (du * g if gated else du) * (1 - a * a)
    acc = _mm3(dza, wa.T)  # dx's products, gate b's into the same accumulator
    dzb = None
    if gated:
        dzb = du * a * g * (1 - g)
        acc = acc + _mm3(dzb, wb.T)
    dx = p[..., None] * gm[:, None, :] + acc
    dz = dx * (split_bf16(xc)[0] > 0).float()  # relu' from xc's hi plane
    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dwf, dbf = _mm3(flat(hm).T, flat(dz)), flat(_planes(dz)).sum(0)
    dwa, dba = _mm3(flat(xc).T, flat(dza)), flat(_planes(dza)).sum(0)
    if gated:
        dwb, dbb = _mm3(flat(xc).T, flat(dzb)), flat(_planes(dzb)).sum(0)
    else:
        dwb, dbb = torch.zeros_like(dwa), torch.zeros_like(dba)
    grads = [dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc]
    return grads + [_mm3(dz, wf.T)] if need_dh else grads


def _inputs(seed, n):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    weights = [f(FIN, L1, sc=FIN ** -0.5), f(L1, sc=0.1), f(L1, D, sc=L1 ** -0.5),
               f(D, sc=0.1), f(L1, D, sc=L1 ** -0.5), f(D, sc=0.1), f(D, sc=D ** -0.5),
               np.float32(0.1)]
    h = f(B, n, FIN)
    mask = np.arange(n)[None, :] < np.array([n, n - 77, 129])[:, None]
    perm = np.array([2, 0, 1])
    lam = (0.9 + 0.1 * rng.random(B)).astype(np.float32)
    # s's cotangent with a mean of 0.01: dbc sums it and the terms p (dp - c),
    # which cancel within each bag, so a draw of zero mean can leave dbc near
    # 0, where the f32 reference's own error (about 7e-7 against float64 here)
    # exceeds 1e-4 of it
    cots = [f(B, L1), f(B, n, sc=0.1), f(B, n, sc=0.01) + np.float32(0.01)]
    return h, weights, mask, (perm, lam), cots


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_run(h, weights, mask, cots, mix, gated, need_dh):
    jmix = None if mix is None else (jnp.asarray(mix[0]), jnp.asarray(mix[1]))

    def fwd(hh, *w):
        return gap.fused_trunk_attention_pool(hh, *w, mask=jnp.asarray(mask), impl="pallas",
                                              gated=gated, input_grad=need_dh, mix=jmix)

    def run(hh, ws):
        outs, vjp = jax.vjp(fwd, hh, *ws)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))

    hh, ws = jnp.asarray(h), [jnp.asarray(w) for w in weights]
    compiled = jax.jit(run).lower(hh, ws).compile(
        compiler_options={"xla_allow_excess_precision": False})
    outs, grads = compiled(hh, ws)
    return [np.asarray(o) for o in outs], [np.asarray(g) for g in grads]


@pytest.mark.parametrize("gated,mixed,need_dh,n", [
    (True, True, False, 384),   # the main path's mode: gated, mixed
    (False, True, False, 256),  # ungated CLAM, mixed
    (True, False, True, 320),   # a CLAM differentiated with respect to its bags
    (False, False, True, 384),
])
def test_three_bf16_products_match_jax_f32(interpret_pallas, gated, mixed, need_dh, n):
    h, weights, mask, mix, cots = _inputs(3, n)
    mix = mix if mixed else None
    want, gwant = _jax_run(h, weights, mask, cots, mix, gated, need_dh)
    ht, wt, mt = torch.tensor(h), [torch.tensor(x) for x in weights], torch.tensor(mask)
    tmix = None if mix is None else (torch.tensor(mix[0]), torch.tensor(mix[1]))
    got = _x3_fwd(ht, wt, mt, tmix, gated)
    ggot = _x3_bwd(ht, wt, mt, got[1], [torch.tensor(c) for c in cots], tmix, gated, need_dh)
    for name, g, w in zip("Mps", got, want):
        assert _rel(g, w) <= 1e-4, name
    for name, g, w in zip(NAMES, ggot, gwant[1:]):
        if not gated and name in ("wb", "bb"):
            assert not g.any() and not w.any(), name
            continue
        assert _rel(g.reshape(np.shape(w)), w) <= 1e-4, name
    if need_dh:
        assert np.abs(gwant[0]).max() > 0
        assert _rel(ggot[8], gwant[0]) <= 1e-4, "dh"


def test_three_bf16_products_beat_one():
    # the planes are what makes the tolerance: a single bf16 product misses
    # 1e-4 by far where three hold it (the design's reason for three)
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.normal(size=(256, FIN)).astype(np.float32))
    b = torch.tensor((rng.normal(size=(FIN, L1)) * FIN ** -0.5).astype(np.float32))
    exact = (a.double() @ b.double()).numpy()
    one = a.bfloat16().float() @ b.bfloat16().float()
    assert _rel(_mm3(a, b), exact) <= 2e-5
    assert _rel(one, exact) > 1e-3


def test_refine_is_needed():
    # against the f32 plain twin on 24 bags of 1024 rows at the main path's
    # widths: without the refine, the three products' error near z = 0 flips
    # relu' on about 20 elements and dWf misses 1e-4; with it, it holds
    from murcl_tpu_torch.ops.attention import fused_trunk_plain_bwd, fused_trunk_plain_fwd

    gen = torch.Generator().manual_seed(8)
    r = lambda *s, sc=1.0: torch.randn(*s, generator=gen) * sc  # noqa: E731
    fin = l1 = 512
    w = [r(fin, l1, sc=fin ** -0.5), r(l1, sc=0.1), r(l1, 256, sc=l1 ** -0.5),
         r(256, sc=0.1), r(l1, 256, sc=l1 ** -0.5), r(256, sc=0.1), r(256, sc=1 / 16),
         r((), sc=0.1)]
    h, mask = r(24, 1024, fin), torch.ones(24, 1024, dtype=torch.bool)
    cots = [r(24, l1), r(24, 1024, sc=0.1), r(24, 1024, sc=0.01)]
    _, p, _ = fused_trunk_plain_fwd(h, *w, mask)
    want = fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, need_dh=True)
    rels = [_rel(_x3_bwd(h, w, mask, p, cots, None, True, True, refine)[k], want[k])
            for refine in (False, True) for k in (0, 8)]
    assert min(rels[:2]) > 1e-4 and max(rels[2:]) <= 1e-5
