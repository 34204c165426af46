"""K2/K3's padded route on the CPU: bag widths Fin that the kernels do not take.

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
