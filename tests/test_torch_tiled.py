"""K8's plain twin (``attention_pool_tiled_plain``), the 6 MiB route rule and
CLAM_SB's full-slide route against the JAX package.

The JAX side runs its Pallas kernels in interpret mode. f32: M, p and s to
1e-5, the gradient through K7b's twin against JAX's custom-vjp gradient to
2e-5 (``tests/test_attention_pallas.py:244-252``). bf16, with XLA told not
to keep excess precision: s and p to 1e-5 (relative Frobenius); M to 1e-5
where the JAX tile equals the twin's 32-row tile and the bag is one chunk,
so both round ``e`` at the same running maxima, and to 1e-3 otherwise: the
TPU kernel takes its running max over the whole bag, the port per chunk, so
an ``e`` may round to a neighbouring bf16 value (2^-8 relative; 8e-5 on M
here).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu_torch.engine.weights import params_from_jax
from murcl_tpu_torch.models import CLAM_SB
from murcl_tpu_torch.ops import attention as tat

F, D = 16, 8
NAMES = ["dx", "wa", "ba", "wb", "bb", "wc", "bc"]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gap.pl, "pallas_call", interp)


def _inputs(seed, lengths, n):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    weights = [f(F, D, sc=0.4), f(D, sc=0.1), f(F, D, sc=0.4), f(D, sc=0.1), f(D, sc=0.4),
               np.float32(0.05)]
    x = np.abs(f(len(lengths), n, F))  # a trunk output: post-relu
    mask = np.arange(n)[None, :] < np.asarray(lengths)[:, None]
    return x, weights, mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_tiled(x, weights, mask, gated, tile, dtype):
    def run(xx, ws):
        return gap.attention_pool_tiled(xx, *ws, mask=jnp.asarray(mask), gated=gated, tile=tile)

    xx = jnp.asarray(x, dtype)
    ws = [jnp.asarray(w) for w in weights]
    compiled = jax.jit(run).lower(xx, ws).compile(
        compiler_options={"xla_allow_excess_precision": False})
    return [np.asarray(o, np.float32) for o in compiled(xx, ws)]


def _torch_tiled(x, weights, mask, gated, dtype):
    outs = tat.attention_pool_tiled(torch.tensor(x).to(dtype), *map(torch.tensor, weights),
                                    mask=torch.tensor(mask), gated=gated)
    return [o.numpy() for o in outs]


# N = 150: three chunks of 64 rows, the last ragged; bag 1's rows 40.. are
# masked, so its last two chunks are all masked (l_c = 0)
@pytest.mark.parametrize("gated", [True, False])
def test_twin_matches_jax_f32(interpret_pallas, gated):
    x, weights, mask = _inputs(0, [150, 40], 150)
    want = _jax_tiled(x, weights, mask, gated, 16, jnp.float32)
    got = _torch_tiled(x, weights, mask, gated, torch.float32)
    for name, w, g in zip("Mps", want, got):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("n,lengths,tile,m_tol", [(64, [64, 23], 32, 1e-5),
                                                  (150, [150, 97], 16, 1e-3)])
def test_twin_matches_jax_bf16(interpret_pallas, n, lengths, tile, m_tol):
    x, weights, mask = _inputs(1, lengths, n)
    want = _jax_tiled(x, weights, mask, True, tile, jnp.bfloat16)
    got = _torch_tiled(x, weights, mask, True, torch.bfloat16)
    assert _rel(got[0], want[0]) <= m_tol
    assert _rel(got[1], want[1]) <= 1e-5 and _rel(got[2], want[2]) <= 1e-5


@pytest.mark.parametrize("gated", [True, False])
def test_gradient_matches_jax_custom_vjp(interpret_pallas, gated):
    x, weights, mask = _inputs(2, [150, 77], 150)
    rng = np.random.default_rng(3)
    cots = [rng.normal(size=s).astype(np.float32) for s in ((2, F), (2, 150), (2, 150))]

    def fwd(xx, *ws):
        return gap.attention_pool_tiled(xx, *ws, mask=jnp.asarray(mask), gated=gated, tile=16)

    _, vjp = jax.vjp(fwd, jnp.asarray(x), *map(jnp.asarray, weights))
    want = vjp(tuple(map(jnp.asarray, cots)))

    xt = torch.tensor(x, requires_grad=True)
    ws = [torch.tensor(w, requires_grad=True) for w in weights]
    outs = tat.attention_pool_tiled(xt, *ws, mask=torch.tensor(mask), gated=gated)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    for name, w, g in zip(NAMES, want, [xt.grad] + [v.grad for v in ws]):
        np.testing.assert_allclose(g.numpy().reshape(np.shape(w)), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


def _spy(monkeypatch, name):
    calls = []
    orig = getattr(tat, name)

    def spy(*a, **k):
        calls.append(a[0].shape)
        return orig(*a, **k)

    monkeypatch.setattr(tat, name, spy)
    return calls


def _pool_spy(monkeypatch):
    """Calls of K7's op (``_AttentionPool.apply``)."""
    calls = []
    orig = tat._AttentionPool

    def apply(*a):
        calls.append(a[0].shape)
        return orig.apply(*a)

    monkeypatch.setattr(tat, "_AttentionPool", SimpleNamespace(apply=apply))
    return calls


@pytest.mark.parametrize("dropout", [0.0, 0.25])
def test_bag_over_6mib_routes_by_dropout(monkeypatch, dropout):
    """(1, 3200, 512) f32 is 6.25 MiB: K8 at dropout 0, K7's op at 0.25."""
    tiled, pooled = _spy(monkeypatch, "attention_pool_tiled"), _pool_spy(monkeypatch)
    rng = np.random.default_rng(4)
    x = torch.tensor(np.abs(rng.normal(size=(1, 3200, 512))).astype(np.float32))
    w = [torch.tensor(rng.normal(size=s).astype(np.float32) * 0.05)
         for s in ((512, D), (D,), (512, D), (D,), (D,))] + [torch.tensor(0.1)]
    m, _, s = tat.gated_attention_pool(x, *w, dropout=dropout, seed=3)
    assert (len(tiled), len(pooled)) == ((1, 0) if dropout == 0 else (0, 1))
    want = tat.gated_attention_pool_plain_fwd(x, *w, torch.ones(1, 3200, dtype=torch.bool),
                                              True, dropout, 3)
    np.testing.assert_allclose(m.numpy(), want[0].numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), want[2].numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_bags_keep_their_route(monkeypatch, dtype):
    """The MuRCL/RLMIL paths' bags (1024 x 512 each) take K2 through CLAM
    and K7 through the pool, in bf16 and f32, at dropout 0 and 0.25."""
    tiled = _spy(monkeypatch, "attention_pool_tiled")
    fused, pooled = _spy(monkeypatch, "fused_trunk_attention_pool"), _pool_spy(monkeypatch)
    monkeypatch.setattr("murcl_tpu_torch.models.clam.fused_trunk_attention_pool",
                        tat.fused_trunk_attention_pool)
    h = torch.randn(2, 1024, 512, generator=torch.Generator().manual_seed(0)).to(dtype)
    for rate in (0.0, 0.25):
        model = CLAM_SB(in_dim=512, dropout=rate)
        model.eval()
        with torch.no_grad():
            model(h)
        model.train()
        with torch.no_grad():
            model(h)
            model(h, instance_eval=True, label=torch.tensor([0, 1]))
    assert not tiled and len(fused) == 4 and len(pooled) == 2


def test_clam_full_slide_route_matches_jax(interpret_pallas, monkeypatch):
    """CLAM_SB (dim 16, small, gated) on a 40-patch bag (K2's route in
    both packages) and a 4,000-patch bag padded to 4,096 (trunk output 8
    MiB: the plain trunk, then K8 in both), f32, eval: M and the scores."""
    tiled, fused = _spy(monkeypatch, "attention_pool_tiled"), []
    orig_fused = tat.fused_trunk_attention_pool

    def fused_spy(*a, **k):
        fused.append(a[0].shape)
        return orig_fused(*a, **k)

    monkeypatch.setattr("murcl_tpu_torch.models.clam.fused_trunk_attention_pool", fused_spy)
    kw = dict(in_dim=16, gate=True, size_arg="small", dropout=0.25, k_sample=8, n_classes=2,
              subtyping=True)
    jmodel = JaxCLAM(attn_impl="pallas", attn_gate_math="exact", **kw)
    rng = np.random.default_rng(5)
    params = None
    model = CLAM_SB(**kw).eval()
    for n, length in ((40, 40), (4096, 4000)):
        h = np.zeros((1, n, 16), np.float32)
        h[0, :length] = rng.normal(size=(length, 16))
        mask = np.arange(n)[None, :] < length
        if params is None:
            params = JaxCLAM(**kw).init(jax.random.PRNGKey(0), jnp.asarray(h))
            model.load_state_dict(params_from_jax(params)[0])
        jm, jaux = jmodel.apply(params, jnp.asarray(h), mask=jnp.asarray(mask))
        with torch.no_grad():
            m, aux = model(torch.tensor(h), mask=torch.tensor(mask))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(aux["attention"].numpy(), np.asarray(jaux["attention"]),
                                   rtol=1e-5, atol=1e-5)
    assert fused == [(1, 40, 16)] and tiled == [(1, 4096, 512)]
