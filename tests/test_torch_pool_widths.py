"""K7's and K8's padded route on the CPU: widths that are not multiples of 128.

The JAX kernels take any F and D; the port's kernels take multiples of 128,
and their wrappers zero-pad the rest (``pad_pool_widths``: x's columns and
W's rows to F's multiple, W's columns, ``ba``, ``bb`` and ``wc`` to D's),
run, and slice M, dx and the weight gradients back. Here the same route runs
through the plain twins: pad, run the twin with the dropout hash at the
logical D (``hash_width``, as the kernels take it), slice. Against the twin
at the logical widths it keeps exactly the same units (the keep bits of
streams 1 and 2 bitwise equal on the real columns) and gives every output
and gradient within 1e-6 relative in f32, at dropout 0 and 0.25: padding
adds exact zeros, but sums over more columns may block differently on the
CPU, so bitwise outputs are not asked for. The scores' cotangent is of
unit scale: ``dbc`` sums ``ds = p (dp - c) + gs``, whose first part sums to
zero, so with a small ``gs`` one ulp of ``s`` reads as a large relative
error in ``dbc`` and ``dba`` whatever the route (9e-6 at 0.01). K8's twin
likewise, forward.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from murcl_tpu_torch.ops import attention as tat

NAMES = ["M", "p", "s", "dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
SEED = 1234


def _case(f, d, b=3, n=70):
    rng = np.random.default_rng(f * 1000 + d)
    t = lambda *shape, sc=1.0: torch.tensor((rng.normal(size=shape) * sc)  # noqa: E731
                                            .astype(np.float32))
    w = [t(f, d, sc=f ** -0.5), t(d, sc=0.1), t(f, d, sc=f ** -0.5), t(d, sc=0.1),
         t(d, sc=d ** -0.5), t(sc=0.1)]
    x = torch.relu(t(b, n, f))
    mask = torch.arange(n)[None, :] < torch.tensor([n, 41, 1][:b])[:, None]
    cots = [t(b, f), t(b, n, sc=0.1), t(b, n)]
    return x, w, mask, cots


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("f,d", [(32, 8), (512, 96), (448, 192)])
def test_padded_route_matches_the_twin(f, d, gated, rate):
    x, w, mask, cots = _case(f, d)
    b, n, _ = x.shape
    m, p, s = tat.gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, SEED)
    want = [m, p, s, *tat.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots, gated,
                                                          rate, SEED)]

    xp, wa, ba, wb, bb, wc = tat.pad_pool_widths(x, *w[:5])
    fp, dp = wa.shape
    assert (fp, dp) == (-(-f // 128) * 128, -(-d // 128) * 128) and xp.shape == (b, n, fp)
    mp, pp, sp = tat.gated_attention_pool_plain_fwd(xp, wa, ba, wb, bb, wc, w[5], mask, gated,
                                                    rate, SEED, hash_width=d)
    dx, dwa, dba, dwb, dbb, dwc, dbc = tat.gated_attention_pool_plain_bwd(
        xp, wa, ba, wb, bb, wc, mask, pp, F.pad(cots[0], (0, fp - f)), *cots[1:], gated, rate,
        SEED, hash_width=d)
    # the padded columns of every output are exact zeros
    for t, keep in ((mp, f), (dx, f), (dba, d), (dbb, d), (dwc, d)):
        assert not t[..., keep:].any()
    assert not dwa[f:].any() and not dwa[:, d:].any()
    got = [mp[:, :f], pp, sp, dx[..., :f], dwa[:f, :d], dba[:d], dwb[:f, :d], dbb[:d], dwc[:d],
           dbc]
    for name, g, wv in zip(NAMES, got, want):
        if not gated and name in ("dwb", "dbb"):
            assert not g.any() and not wv.any(), name
            continue
        assert _rel(g, wv) <= 1e-6, (name, _rel(g, wv))

    bags = torch.arange(b)
    for stream in (1, 2):
        padded = tat._keep_bits(SEED, bags, n, dp, stream, stride=d)[..., :d]
        assert torch.equal(padded, tat._keep_bits(SEED, bags, n, d, stream))
    if rate:
        keep = tat._keep_scale(SEED, rate, b, n, dp, 1, x.device, torch.float32, d)[..., :d]
        assert torch.equal(keep, tat._keep_scale(SEED, rate, b, n, d, 1, x.device,
                                                 torch.float32))


@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("f,d", [(32, 8), (448, 192)])
def test_tiled_padded_route_matches_the_twin(f, d, gated):
    x, w, mask, _ = _case(f, d, b=2, n=150)
    want = tat.attention_pool_tiled_plain(x, *w, mask, gated)
    xp, *wp = tat.pad_pool_widths(x, *w[:5])
    m, p, s = tat.attention_pool_tiled_plain(xp, *wp, w[5], mask, gated)
    assert not m[:, f:].any()
    for name, g, wv in zip("Mps", (m[:, :f], p, s), want):
        assert _rel(g, wv) <= 1e-6, (name, _rel(g, wv))
