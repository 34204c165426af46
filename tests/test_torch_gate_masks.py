"""K7's gate keep masks (the port of ``scripts/tpu_smoke.py``'s mask writer) on
the CPU, against K7's own keep and against the JAX script's rebuild.

``ops/gate_masks.py`` ``gate_keep_masks_plain`` (the twin of
``csrc/gate_masks.cu``) gives the keep bits of K7's gates a and b, hash
streams 1 and 2:

- each mask is K7's plain route's keep multiplier ``_keep_scale(...) != 0``;
- at the script's shape and seed, ``(8, 256, 256)`` at seed 3, each keeps
  within 0.02 of 0.75;
- d/dwc of ``sum(M^2)`` through the port's plain ``gated_attention_pool``
  (dropout 0.25, seed 3) equals the JAX script's rebuild
  (``tpu_smoke.py:115-124``, restated here in jnp with
  ``precision="highest"``) fed the port's masks, within 1e-5 relative (the
  largest difference over the largest entry) in f32: the same masks, two
  f32 computations that sum in different orders;
- ``murcl_tpu_torch/scripts/dropout_smoke.py`` runs end to end with
  ``--device cpu``, its masks the twin's, and without a card its default
  device raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu_torch.ops import attention as tat
from murcl_tpu_torch.ops.gate_masks import gate_keep_masks, gate_keep_masks_plain
from murcl_tpu_torch.scripts import dropout_smoke


@pytest.mark.parametrize("b,n,d", [(3, 70, 40), (2, 33, 100)])
def test_masks_are_k7s_keep(b, n, d):
    ka, kb = gate_keep_masks_plain(5, 0.25, b, n, d)
    assert ka.shape == kb.shape == (b, n, d) and ka.dtype == torch.bool
    for stream, mask in ((1, ka), (2, kb)):
        keep = tat._keep_scale(5, 0.25, b, n, d, stream, torch.device("cpu"), torch.float32)
        assert torch.equal(mask, keep != 0), stream
    assert not torch.equal(ka, kb)
    assert all(torch.equal(x, y) for x, y in zip(gate_keep_masks(5, 0.25, b, n, d, "cpu"),
                                                  (ka, kb)))


def test_keep_rate_at_the_scripts_shape():
    b, n, _, d = dropout_smoke.SHAPE
    for mask in gate_keep_masks_plain(dropout_smoke.MASK_SEED, dropout_smoke.RATE, b, n, d):
        assert abs(float(mask.float().mean()) - 0.75) < 0.02


def _jax_rebuild_grad(x, wa, ba, wb, bb, wc, bc, ka, kb, rate):
    """``tpu_smoke.py``'s ``xla_loss`` (a closure of its ``main()``), restated:
    d/dwc of ``sum(m^2)`` of the gated pool with the masks ``ka``, ``kb``."""
    j = lambda t: jnp.asarray(t.numpy())  # noqa: E731
    x, wa, ba, wb, bb, wc, bc, ka, kb = map(j, (x, wa, ba, wb, bb, wc, bc, ka, kb))
    scale = 1.0 / (1.0 - rate)

    def xla_loss(wc_):
        a = jnp.tanh(jnp.einsum("bnf,fd->bnd", x, wa, precision="highest") + ba)
        g_ = jax.nn.sigmoid(jnp.einsum("bnf,fd->bnd", x, wb, precision="highest") + bb)
        a = jnp.where(ka, a * scale, 0.0)
        g_ = jnp.where(kb, g_ * scale, 0.0)
        s = jnp.einsum("bnd,d->bn", a * g_, wc_, precision="highest") + bc
        p = jax.nn.softmax(s, axis=-1)
        m = jnp.einsum("bn,bnf->bf", p, x, precision="highest")
        return jnp.sum(m * m)

    return np.asarray(jax.grad(xla_loss)(wc))


def test_wc_grad_matches_jax_rebuild():
    shape = dropout_smoke.SHAPE
    b, n, _, d = shape
    rate, seed = dropout_smoke.RATE, dropout_smoke.MASK_SEED
    x, wa, ba, wb, bb, wc, bc = dropout_smoke.inputs(shape, torch.device("cpu"))
    ka, kb = gate_keep_masks_plain(seed, rate, b, n, d)
    want = _jax_rebuild_grad(x, wa, ba, wb, bb, wc, bc, ka, kb, rate)
    w = wc.clone().requires_grad_(True)
    m = tat.gated_attention_pool(x, wa, ba, wb, bb, w, bc, gated=True, dropout=rate, seed=seed)[0]
    (got,) = torch.autograd.grad((m * m).sum(), w)
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel


def test_script_runs_on_cpu(capsys):
    shape = (2, 64, 32, 16)
    outs = {}
    res = dropout_smoke.run("cpu", shape, reps=1, outs=outs)
    assert res["deterministic"] and res["seed_sensitive"] and res["grad_rel"] < 1e-2
    assert set(res) == {"ms", "keep_rate", "grad_rel", "deterministic", "seed_sensitive"}
    want = gate_keep_masks_plain(dropout_smoke.MASK_SEED, dropout_smoke.RATE, 2, 64, 16)
    assert all(torch.equal(g, wv) for g, wv in zip(outs["masks"], want))
    assert "rebuild with its masks" in capsys.readouterr().out


def test_default_device_is_the_card():
    assert dropout_smoke.parse_args([]).device == "cuda:0"
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dropout_smoke.run()
