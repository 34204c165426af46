"""Port's ABMIL vs the JAX ``ABMIL`` on the same weights.

Weights move with ``params_from_jax(arch="ABMIL")``. f32 against the XLA
route: the bag embedding, attention and logits to 1e-5 absolute / 1e-4
relative, and every parameter's gradient under random cotangents on all
three outputs to the same tolerance, unmasked and with a mask. bf16 against
the JAX model with ``attn_impl="pallas"`` in interpret mode (K7 ungated):
outputs and weight gradients to a relative Frobenius error of 1e-2 (they
agree bit for bit at this size); the bias gradients, each a sum of B x N
bf16 terms that XLA on the CPU and torch accumulate in another order and
precision, to 3e-2; the attention's last bias has a true gradient of 0 (the
softmax is shift-invariant), so both packages' rounding noise is only
bounded. The ``state_dict`` follows ``murcl_tpu.engine.torch_import``'s
``ABMIL_MAP`` both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu.engine.torch_import import export_model_state, import_model_state
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu_torch.engine.weights import jax_from_params, params_from_jax
from murcl_tpu_torch.models import ABMIL, CL, build_aggregator

B, N, DIM, L, D, OUT = 3, 20, 16, 32, 8, 6


@pytest.fixture()
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call

    def interp(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(gap.pl, "pallas_call", interp)


def _setup(seed, impl="xla"):
    jm = JaxABMIL(dim_in=DIM, L=L, D=D, dim_out=OUT, attn_impl=impl)
    params = jm.init(jax.random.PRNGKey(seed), jnp.zeros((B, N, DIM)))
    model = ABMIL(dim_in=DIM, L=L, D=D, dim_out=OUT)
    sd, _ = params_from_jax(params, arch="ABMIL")
    model.load_state_dict(sd)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, DIM)).astype(np.float32)
    cots = [rng.normal(size=(B, L)).astype(np.float32),
            rng.normal(size=(B, OUT)).astype(np.float32),
            rng.normal(size=(B, N)).astype(np.float32)]
    return jm, params, model.eval(), x, cots


def _jax_run(jm, params, x, mask, cots, dtype, options=None):
    def run(p):
        def fwd(pp):
            out, aux = jm.apply(pp, jnp.asarray(x, dtype),
                                mask=None if mask is None else jnp.asarray(mask))
            return out, aux["logits"], aux["attention"]

        outs, vjp = jax.vjp(fwd, p)
        return outs, vjp(tuple(jnp.asarray(c) for c in cots))[0]

    compiled = jax.jit(run).lower(params).compile(compiler_options=options)
    outs, grads = compiled(params)
    return [np.asarray(o, np.float32) for o in outs], params_from_jax(grads, arch="ABMIL")[0]


def _torch_run(model, x, mask, cots, dtype):
    model.zero_grad(set_to_none=True)
    out, aux = model(torch.tensor(x).to(dtype), mask=None if mask is None else torch.tensor(mask))
    outs = [out, aux["logits"], aux["attention"]]
    torch.autograd.backward(outs, [torch.tensor(c) for c in cots])
    return [o.detach().float().numpy() for o in outs], dict(model.named_parameters())


@pytest.mark.parametrize("masked", [False, True])
def test_forward_and_grads_match_jax_f32(masked):
    jm, params, model, x, cots = _setup(0)
    mask = (np.arange(N)[None, :] < np.array([20, 11, 4])[:, None]) if masked else None
    want, gwant = _jax_run(jm, params, x, mask, cots, jnp.float32)
    got, named = _torch_run(model, x, mask, cots, torch.float32)
    for name, w, g in zip(("out", "logits", "attention"), want, got):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-5, err_msg=name)
    assert set(named) == set(gwant)
    for name, p in named.items():
        np.testing.assert_allclose(p.grad.numpy(), gwant[name].numpy(), rtol=1e-4, atol=1e-5,
                                   err_msg=name)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_bf16_matches_pallas_interpret(interpret_pallas):
    jm, params, model, x, cots = _setup(1, impl="pallas")
    want, gwant = _jax_run(jm, params, x, None, cots, jnp.bfloat16)
    got, named = _torch_run(model, x, None, cots, torch.bfloat16)
    for name, w, g in zip(("out", "logits", "attention"), want, got):
        assert _rel(g, w) <= 1e-2, name
    for name, p in named.items():
        if name == "attention.2.bias":
            assert abs(float(p.grad)) <= 1e-3 and abs(float(gwant[name])) <= 1e-3
            continue
        tol = 3e-2 if name.endswith("bias") else 1e-2
        assert _rel(p.grad.numpy(), gwant[name].numpy()) <= tol, name


def test_state_dict_follows_abmil_map():
    _, params, model, _, _ = _setup(2)
    ref = export_model_state(params, "ABMIL")
    sd = model.state_dict()
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v)
    # a CL-wrapped state dict imports to the same tree (the encoder. prefix goes)
    back = import_model_state(CL(model).state_dict(), "ABMIL")
    mine, _ = jax_from_params(CL(model).state_dict(), arch="ABMIL")
    for tree in (back, mine):
        wl, wt = jax.tree_util.tree_flatten(params)
        gl, gt = jax.tree_util.tree_flatten(tree)
        assert wt == gt
        for a, b in zip(wl, gl):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_build_aggregator_and_dropout():
    model, width = build_aggregator("ABMIL", dim_in=DIM, num_classes=OUT,
                                    arch_setting={"L": L, "D": D, "dropout": 0.5})
    assert isinstance(model, ABMIL) and width == L and model.fc.out_features == OUT
    x = torch.randn(B, N, DIM)
    model.train()
    a, _ = model(x, generator=torch.Generator().manual_seed(4))
    b, _ = model(x, generator=torch.Generator().manual_seed(4))
    c, _ = model(x, generator=torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(x)[0], model(x)[0])
    with pytest.raises(NotImplementedError):
        ABMIL(dim_in=DIM, K=2)
