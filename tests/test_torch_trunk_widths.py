"""K2/K3's padded route on the CPU: widths Fin, L1 and D that the kernels do not take.

The JAX kernel takes the whole ``(1, n, fin)`` block at any Fin; the port's
warpgroup kernels take Fin in multiples of 64 (the trunk's k-slices), and of
128 with the bags' gradient (dh's column passes). Their wrappers zero-pad
h's last axis and Wf's rows (``pad_trunk_fin``), run, and slice dWf and dh
back. Here the same route runs through the plain twins: pad, run the twins
at the padded Fin, slice. At dropout 0 it gives every output and gradient of
the JAX package's XLA route (``fused_trunk_attention_pool(impl="xla")``,
``jax.vjp``) within 1e-6 relative Frobenius in f32, at Fin 32, 100 and 1000
and, with dh, at Fin 192; at dropout 0.25 it gives the twin at the logical
Fin within 1e-6 (the trunk's keep bits are hashed over (N, L1), which the
padding does not touch). Padding adds exact zeros, but sums over more
columns may block differently on the CPU, so bitwise outputs are not asked
for. The scores' cotangent is of unit scale: ``dbc`` sums ``ds = p (dp -
c) + gs``, whose first part cancels (``tests/test_torch_pool_widths.py``).
The widths the feature extractors give copy nothing.

L1 and D likewise (``pad_trunk_widths``): the kernels take them in
multiples of 128, so the wrappers zero-pad Wf's columns and ``bf`` to L1,
Wa's and Wb's rows to L1 and columns to D, and ``ba``, ``bb`` and ``wc`` to
D, and slice M and the gradients back; the kernels hash the dropout at the
logical L1 and D, as the twins do with ``hash_l1`` and ``hash_d``. Through
the twins at L1 200, D 100 (and L1 48, D 16, the ``_case`` widths): at
dropout 0 every output and gradient equals the JAX package's XLA route
within 1e-6 relative Frobenius in f32, and M's, dWf's, dbf's and the gate
weights' padded parts are exact zeros; at dropout 0.25 the padded route
gives the twin at the logical widths within 1e-6, and the keep bits of
streams 0, 1 and 2 hashed at the padded widths with the logical strides
equal the logical widths' bits on the real columns. The CLIs' 512 -> 256
and 512 -> 384 copy nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu_torch.ops import attention as tat

NAMES = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc", "dh"]
SEED = 99


def _case(fin, b=3, n=40, l1=48, d=16):
    rng = np.random.default_rng(fin)
    t = lambda *shape, sc=1.0: (rng.normal(size=shape) * sc).astype(np.float32)  # noqa: E731
    w = [t(fin, l1, sc=fin ** -0.5), t(l1, sc=0.1), t(l1, d, sc=l1 ** -0.5), t(d, sc=0.1),
         t(l1, d, sc=l1 ** -0.5), t(d, sc=0.1), t(d, sc=d ** -0.5), np.float32(0.05)]
    h = t(b, n, fin)
    mask = np.arange(n)[None, :] < np.array([n, 23, 1][:b])[:, None]
    cots = [t(b, l1), t(b, n, sc=0.1), t(b, n)]
    return h, w, mask, cots


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _padded_route(h, w, mask, cots, need_dh, rate=0.0):
    """The wrappers' route through the twins: ``[M, p, s, 8 grads(, dh)]``
    at the logical Fin, and the padded parts of dWf and dh."""
    fin = h.shape[-1]
    ht, wt = torch.tensor(h), [torch.tensor(x) for x in w]
    hp, wfp = tat.pad_trunk_fin(ht, wt[0], need_dh)
    assert hp.shape[-1] == tat.trunk_fin(fin, need_dh) and wfp.shape[0] == hp.shape[-1]
    m, p, s = tat.fused_trunk_plain_fwd(hp, wfp, *wt[1:], torch.tensor(mask), rate, SEED)
    grads = tat.fused_trunk_plain_bwd(hp, wfp, *wt[1:7], torch.tensor(mask), p,
                                      *[torch.tensor(c) for c in cots], rate, SEED,
                                      need_dh=need_dh)
    out = [m, p, s, grads[0][:fin], *grads[1:8]] + ([grads[8][..., :fin]] if need_dh else [])
    pads = [grads[0][fin:]] + ([grads[8][..., fin:]] if need_dh else [])
    return [x.numpy() for x in out], pads


def _jax_route(h, w, mask, cots, need_dh):
    def fwd(hh, *ws):
        return gap.fused_trunk_attention_pool(hh, *ws, mask=jnp.asarray(mask), impl="xla",
                                              input_grad=need_dh)

    outs, vjp = jax.vjp(fwd, jnp.asarray(h), *[jnp.asarray(x) for x in w])
    grads = vjp(tuple(jnp.asarray(c) for c in cots))
    return [np.asarray(o) for o in outs] + [np.asarray(g) for g in grads[1:]] + (
        [np.asarray(grads[0])] if need_dh else [])


@pytest.mark.parametrize("fin,need_dh", [(32, False), (100, False), (1000, False),
                                         (192, True)])
def test_padded_route_matches_jax_xla(fin, need_dh):
    h, w, mask, cots = _case(fin)
    got, pads = _padded_route(h, w, mask, cots, need_dh)
    want = _jax_route(h, w, mask, cots, need_dh)
    for pad in pads:  # the padded rows of dWf and columns of dh are exact zeros
        assert not pad.any()
    for name, g, wv in zip(NAMES, got, want):
        assert _rel(g.reshape(np.shape(wv)), wv) <= 1e-6, (name, _rel(g, wv))


@pytest.mark.parametrize("fin,need_dh", [(100, False), (192, True)])
def test_padded_route_keeps_the_dropout_units(fin, need_dh):
    h, w, mask, cots = _case(fin)
    got, pads = _padded_route(h, w, mask, cots, need_dh, rate=0.25)
    ht, wt, mt = torch.tensor(h), [torch.tensor(x) for x in w], torch.tensor(mask)
    m, p, s = tat.fused_trunk_plain_fwd(ht, *wt, mt, 0.25, SEED)
    want = [m, p, s, *tat.fused_trunk_plain_bwd(ht, *wt[:7], mt, p,
                                                *[torch.tensor(c) for c in cots], 0.25, SEED,
                                                need_dh=need_dh)]
    for pad in pads:
        assert not pad.any()
    for name, g, wv in zip(NAMES, got, want):
        assert _rel(g, wv.float().numpy()) <= 1e-6, (name, _rel(g, wv.float().numpy()))


@pytest.mark.parametrize("fin,need_dh,padded", [(512, False, 512), (2048, True, 2048),
                                                (32, False, 64), (100, True, 128),
                                                (1000, False, 1024), (192, True, 256),
                                                (192, False, 192)])
def test_trunk_fin(fin, need_dh, padded):
    assert tat.trunk_fin(fin, need_dh) == padded
    h, wf = torch.zeros(1, 2, fin), torch.zeros(fin, 128)
    hp, wfp = tat.pad_trunk_fin(h, wf, need_dh)
    assert hp.shape == (1, 2, padded) and wfp.shape == (padded, 128)
    if padded == fin:  # no copy where the width is already so
        assert hp is h and wfp is wf


def _widths_route(h, w, mask, cots, need_dh, rate=0.0):
    """The wrappers' route for L1 and D (and Fin) through the twins:
    ``[M, p, s, 8 grads(, dh)]`` at the logical widths, and the padded
    parts of M and of the weight gradients."""
    fin, (l1, d) = h.shape[-1], w[2].shape
    ht, wt = torch.tensor(h), [torch.tensor(x) for x in w]
    hp, wfp = tat.pad_trunk_fin(ht, wt[0], need_dh)
    wfp, bfp, wap, bap, wbp, bbp, wcp = tat.pad_trunk_widths(wfp, *wt[1:7])
    lp, dp = wap.shape
    assert (lp, dp) == (-(-l1 // 128) * 128, -(-d // 128) * 128) and wfp.shape[1] == lp
    pw = [wfp, bfp, wap, bap, wbp, bbp, wcp]
    gm, gp, gs = (torch.tensor(c) for c in cots)
    gm = torch.nn.functional.pad(gm, (0, lp - l1))
    kw = dict(hash_l1=l1, hash_d=d)
    mt = torch.tensor(mask)
    m, p, s = tat.fused_trunk_plain_fwd(hp, *pw, wt[7], mt, rate, SEED, **kw)
    g = tat.fused_trunk_plain_bwd(hp, *pw, mt, p, gm, gp, gs, rate, SEED, need_dh=need_dh, **kw)
    out = [m[:, :l1], p, s, g[0][:fin, :l1], g[1][:l1], g[2][:l1, :d], g[3][:d], g[4][:l1, :d],
           g[5][:d], g[6][:d], g[7]] + ([g[8][..., :fin]] if need_dh else [])
    pads = [m[:, l1:], g[0][:, l1:], g[0][fin:], g[1][l1:], g[2][l1:], g[2][:, d:], g[3][d:],
            g[4][l1:], g[4][:, d:], g[5][d:], g[6][d:]]
    return [x.numpy() for x in out], pads


WIDTHS = [(32, 200, 100, False), (100, 48, 16, False), (192, 200, 100, True)]


@pytest.mark.parametrize("fin,l1,d,need_dh", WIDTHS)
def test_padded_widths_match_jax_xla(fin, l1, d, need_dh):
    h, w, mask, cots = _case(fin, l1=l1, d=d)
    got, pads = _widths_route(h, w, mask, cots, need_dh)
    want = _jax_route(h, w, mask, cots, need_dh)
    for pad in pads:  # what the padded units touch is an exact zero
        assert not pad.any()
    for name, g, wv in zip(NAMES, got, want):
        assert _rel(g.reshape(np.shape(wv)), wv) <= 1e-6, (name, _rel(g, wv))


@pytest.mark.parametrize("fin,l1,d,need_dh", WIDTHS)
def test_padded_widths_keep_the_dropout_units(fin, l1, d, need_dh):
    h, w, mask, cots = _case(fin, l1=l1, d=d)
    b, n = mask.shape
    bags = torch.arange(b)
    lp, dp = -(-l1 // 128) * 128, -(-d // 128) * 128
    for stream, width, padded in ((0, l1, lp), (1, d, dp), (2, d, dp)):
        kept = tat._keep_bits(SEED, bags, n, padded, stream, stride=width)[..., :width]
        assert torch.equal(kept, tat._keep_bits(SEED, bags, n, width, stream)), stream
    got, pads = _widths_route(h, w, mask, cots, need_dh, rate=0.25)
    ht, wt, mt = torch.tensor(h), [torch.tensor(x) for x in w], torch.tensor(mask)
    m, p, s = tat.fused_trunk_plain_fwd(ht, *wt, mt, 0.25, SEED)
    want = [m, p, s, *tat.fused_trunk_plain_bwd(ht, *wt[:7], mt, p,
                                                *[torch.tensor(c) for c in cots], 0.25, SEED,
                                                need_dh=need_dh)]
    for pad in pads:
        assert not pad.any()
    for name, g, wv in zip(NAMES, got, want):
        assert _rel(g, wv.float().numpy()) <= 1e-6, (name, _rel(g, wv.float().numpy()))


@pytest.mark.parametrize("l1,d", [(512, 256), (512, 384)])
def test_cli_widths_copy_nothing(l1, d):
    w = [torch.zeros(64, l1), torch.zeros(l1), torch.zeros(l1, d), torch.zeros(d),
         torch.zeros(l1, d), torch.zeros(d), torch.zeros(d)]
    assert all(a is b for a, b in zip(tat.pad_trunk_widths(*w), w))
