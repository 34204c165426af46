"""K2/K3's ungated and input-gradient modes (plain twins) and ungated CLAM_SB vs the JAX package.

The fused op's plain twins with ``gated=False``, and with the bags'
gradient (the TPU kernel's ``need_dh=True``, unmixed), against the Pallas
kernels ``_make_fused_trunk_fwd_kernel`` / ``_make_fused_trunk_bwd_kernel``
in interpret mode, XLA told not to keep excess precision: M, p, s, dh and
the 8 weight grads to a relative Frobenius error of 1e-5 in f32 and in bf16
(the twins round where the kernels do; f32 sums run in another order).
With ``mix`` a bag that requires grad is refused, gated or not. Ungated
CLAM_SB against JAX ``CLAM_SB(gate=False)`` on the same weights, f32,
dropout 0: the fused default route (with a mask) and the instance-eval
route (without: the bottom-k of a masked bag ties among its p = 0 rows, and
``jax.lax.top_k`` and ``torch.topk`` break ties differently), outputs to
rtol 1e-5 and every live parameter's gradient to rtol 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.models.clam as jax_clam
import murcl_tpu.ops.attention_pallas as gap
import murcl_tpu_torch.models.clam as torch_clam
from murcl_tpu.engine.torch_import import export_model_state
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu_torch.engine.optim import fill_missing_grads
from murcl_tpu_torch.engine.weights import jax_from_params, params_from_jax
from murcl_tpu_torch.models import CLAM_SB
from murcl_tpu_torch.ops import attention as tat

B, N, FIN, L1, D = 4, 16, 8, 16, 8
NAMES = ["wf", "bf", "wa", "ba", "wb", "bb", "wc", "bc"]


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gap.pl, "pallas_call", interp)


@pytest.fixture()
def tiny_clam(monkeypatch):
    monkeypatch.setitem(jax_clam.SIZE_DICT, "tiny", (32, 16))
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (32, 16))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: (rng.normal(size=s) * sc).astype(np.float32)  # noqa: E731
    weights = [f(FIN, L1, sc=0.3), f(L1, sc=0.1), f(L1, D, sc=0.3), f(D, sc=0.1),
               f(L1, D, sc=0.3), f(D, sc=0.1), f(D, sc=0.3), np.float32(0.05)]
    h = f(B, N, FIN)
    mask = np.arange(N)[None, :] < np.array([16, 10, 5, 16])[:, None]
    cots = [f(B, L1), f(B, N), f(B, N)]
    return h, weights, mask, cots


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _jax_run(h, weights, mask, cots, dtype, gated, need_dh):
    def run(hh, ws):
        def fwd(hh, *w):
            return gap.fused_trunk_attention_pool(
                hh, *w, mask=jnp.asarray(mask), impl="pallas", gated=gated,
                input_grad=need_dh)

        outs, vjp = jax.vjp(fwd, hh, *ws)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))

    hh, ws = jnp.asarray(h, dtype), [jnp.asarray(w) for w in weights]
    compiled = jax.jit(run).lower(hh, ws).compile(
        compiler_options={"xla_allow_excess_precision": False})
    outs, grads = compiled(hh, ws)
    return ([np.asarray(o, np.float32) for o in outs],
            [np.asarray(g, np.float32) for g in grads])


def _torch_run(h, weights, mask, cots, dtype, gated, need_dh):
    ht = torch.tensor(h).to(dtype).requires_grad_(need_dh)
    w = [torch.tensor(x, requires_grad=True) for x in weights]
    outs = tat.fused_trunk_attention_pool(ht, *w, mask=torch.tensor(mask), gated=gated)
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    grads = [ht.grad.float().numpy() if need_dh else None] + [x.grad.numpy() for x in w]
    return [o.detach().numpy() for o in outs], grads


@pytest.mark.parametrize("dtype,jdtype", [(torch.float32, jnp.float32),
                                          (torch.bfloat16, jnp.bfloat16)])
@pytest.mark.parametrize("gated,need_dh", [(False, False), (False, True), (True, True)])
def test_plain_matches_pallas_interpret(interpret_pallas, dtype, jdtype, gated, need_dh):
    h, weights, mask, cots = _inputs(0)
    want, gwant = _jax_run(h, weights, mask, cots, jdtype, gated, need_dh)
    got, ggot = _torch_run(h, weights, mask, cots, dtype, gated, need_dh)
    for name, w, g in zip("Mps", want, got):
        assert _rel(g, w) <= 1e-5, name
    if need_dh:
        assert _rel(ggot[0], gwant[0]) <= 1e-5, "dh"
        assert np.abs(gwant[0]).max() > 0
    for name, w, g in zip(NAMES, gwant[1:], ggot[1:]):
        if not gated and name in ("wb", "bb"):
            assert not g.any() and not w.any(), name  # inert inputs of the ungated op
            continue
        assert _rel(g.reshape(np.shape(w)), w) <= 1e-5, name


@pytest.mark.parametrize("gated", [True, False])
def test_mixed_bags_requiring_grad_are_refused(gated):
    h, weights, mask, _ = _inputs(1)
    mix = (torch.tensor([1, 0, 3, 2]), torch.full((B,), 0.95))
    with pytest.raises(ValueError, match="no gradient for the bags"):
        tat.fused_trunk_attention_pool(torch.tensor(h, requires_grad=True),
                                       *[torch.tensor(x) for x in weights], mix=mix,
                                       gated=gated)


def test_plain_bwd_dh_is_last_and_optional():
    h, weights, mask, cots = _inputs(2)
    ht, w, m = torch.tensor(h), [torch.tensor(x) for x in weights], torch.tensor(mask)
    _, p, _ = tat.fused_trunk_plain_fwd(ht, *w, m)
    args = (ht, *w[:7], m, p, *[torch.tensor(c) for c in cots])
    without = tat.fused_trunk_plain_bwd(*args)
    with_dh = tat.fused_trunk_plain_bwd(*args, need_dh=True)
    assert len(without) == 8 and len(with_dh) == 9
    for a, b in zip(without, with_dh):
        assert torch.equal(a, b)
    assert with_dh[8].shape == ht.shape


def _clam_setup(seed):
    kw = dict(in_dim=FIN, gate=False, size_arg="tiny", dropout=0.0, k_sample=3, n_classes=3,
              subtyping=True)
    jm = JaxCLAM(**kw)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((B, N, FIN)))
    model = CLAM_SB(**kw)
    sd, _ = params_from_jax(params)
    model.load_state_dict(sd)
    return jm, params, model


def test_ungated_clam_weights_round_trip(tiny_clam):
    _, params, model = _clam_setup(0)
    keys = set(model.state_dict())
    assert {"attention_net.3.module.0.weight", "attention_net.3.module.3.weight"} <= keys
    assert not any("attention_b" in k for k in keys)
    back, _ = jax_from_params({f"encoder.{k}": v for k, v in model.state_dict().items()})
    wl, wt = jax.tree_util.tree_flatten(params)
    gl, gt = jax.tree_util.tree_flatten(back)
    assert wt == gt
    for a, b in zip(wl, gl):
        np.testing.assert_array_equal(np.asarray(a), b)
    # the trunk and classifier keys are those of the JAX bridge's export
    ref = export_model_state(params, "CLAM_SB")
    for k in ("attention_net.0.weight", "classifiers.weight", "instance_classifiers.2.bias"):
        np.testing.assert_array_equal(model.state_dict()[k].numpy(), ref[k])


@pytest.mark.parametrize("instance_eval", [False, True])
def test_ungated_clam_matches_jax(tiny_clam, instance_eval):
    jm, params, model = _clam_setup(1)
    rng = np.random.default_rng(1)
    h = rng.normal(size=(B, N, FIN)).astype(np.float32)
    label = np.array([0, 2, 1, 2])
    mask = np.arange(N)[None, :] < np.array([16, 12, 9, 16])[:, None]
    if instance_eval:
        mask = np.ones_like(mask)
    cot_m = rng.normal(size=(B, 32)).astype(np.float32)

    def loss_fn(p):
        m, aux = jm.apply(p, jnp.asarray(h), label=jnp.asarray(label),
                          instance_eval=instance_eval, mask=jnp.asarray(mask))
        loss = jnp.sum(m * cot_m) + jnp.sum(aux["attention"] * 0.1)
        if instance_eval:
            loss = loss + jnp.sum(aux["instance_loss"])
        return loss, (m, aux)

    (_, (jm_out, jaux)), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    m, aux = model(torch.tensor(h), mask=torch.tensor(mask), instance_eval=instance_eval,
                   label=torch.tensor(label) if instance_eval else None)
    loss = (m * torch.tensor(cot_m)).sum() + (aux["attention"] * 0.1).sum()
    if instance_eval:
        loss = loss + aux["instance_loss"].sum()
        np.testing.assert_allclose(aux["instance_loss"].detach().numpy(),
                                   np.asarray(jaux["instance_loss"]), rtol=1e-5, atol=1e-6)
    loss.backward()
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm_out), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(aux["attention"].detach().numpy(),
                               np.asarray(jaux["attention"]), rtol=1e-5, atol=1e-6)
    gwant, _ = params_from_jax(jgrads)
    # dead heads (classifiers; instance classifiers off that route): as engine.optim.step
    fill_missing_grads(model.parameters())
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gwant[name].numpy(), rtol=1e-4, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("gate", [True, False])
def test_clam_bag_gradient_matches_jax(tiny_clam, gate):
    """A CLAM_SB differentiated with respect to its bags (JAX's default
    ``attn_input_grad=True``); a bag that needs no gradient gets none."""
    kw = dict(in_dim=FIN, gate=gate, size_arg="tiny", dropout=0.0, n_classes=2)
    jm = JaxCLAM(**kw)
    params = jm.init(jax.random.PRNGKey(3), jnp.zeros((B, N, FIN)))
    model = CLAM_SB(**kw)
    model.load_state_dict(params_from_jax(params)[0])
    rng = np.random.default_rng(3)
    h = rng.normal(size=(B, N, FIN)).astype(np.float32)
    cot = rng.normal(size=(B, 32)).astype(np.float32)
    jgrad = jax.grad(lambda x: jnp.sum(jm.apply(params, x)[0] * cot))(jnp.asarray(h))
    ht = torch.tensor(h, requires_grad=True)
    (model(ht)[0] * torch.tensor(cot)).sum().backward()
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-6)
    ht = torch.tensor(h)
    (model(ht)[0] * torch.tensor(cot)).sum().backward()
    assert ht.grad is None and model.attention_net[0].weight.grad is not None
