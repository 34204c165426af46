"""The port of ``scripts/dbg_step.py`` (``murcl_tpu_torch/scripts/dbg_step.py``)
on the CPU, at a small size: 4 slides of 96 patches, D 32, feat 64, batch 8,
T 2.

It runs end to end with ``--device cpu`` (the plain twins, timed by the
host's clock) and prints the JAX script's four lines and the full step as
one synchronised call. Its (c) piece's last selection equals the JAX
package's ``select_feats`` on the same bank and actions, as
``tests/test_torch_dbg_select.py`` holds it; its (d) piece's pooled
output, attention and scores at dropout 0 in f32 equal JAX's
``fused_trunk_attention_pool_xla`` on the model's weights carried across by
``engine/weights.py``, within the relative Frobenius error of 1e-5 that
``tests/test_torch_fused_modes.py`` holds K2's twin to. Without a card its
default device raises: no fallback.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.ops.attention_pallas import fused_trunk_attention_pool_xla
from murcl_tpu.ops.select import select_feats as jax_select_feats
from murcl_tpu_torch.engine.weights import jax_from_params
from murcl_tpu_torch.scripts import dbg_step

SHAPE = (4, 96, 32, 64, 8, 2)


@pytest.fixture(scope="module")
def ran():
    outs = {}
    res = dbg_step.run("cpu", SHAPE, k=1, outs=outs)
    return res, outs


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_runs_on_cpu(ran, capsys):
    res, outs = ran
    assert set(res) == {*dbg_step.PIECES, "full_one_ms"} and all(v > 0 for v in res.values())
    assert all(np.isfinite(v) for v in outs["losses"].values())
    res2 = dbg_step.run("cpu", SHAPE, k=1)
    out = capsys.readouterr().out
    for line in ("full train step:", "forward-only rollout:", "(backward ~",
                 "4x selection+mixup:", "2x fused fwd kernel 2B:", "one call then a sync",
                 "CPU, plain twins"):
        assert line in out
    assert set(res2) == set(res)


def test_selection_is_jax_select_feats(ran):
    _, outs = ran
    slides, patches, d, feat, b, _ = SHAPE
    rng = np.random.default_rng(0)
    feats, clusters = [], []
    for _ in range(slides):
        feats.append(rng.normal(size=(patches, d)).astype(np.float32))
        a = rng.integers(0, dbg_step.K, size=patches)
        clusters.append([[int(j) for j in np.where(a == c)[0]] for c in range(dbg_step.K)])
    jb = jax_bank_from_arrays(feats, clusters, [i % 2 for i in range(slides)]).device(
        dtype=jnp.bfloat16)
    both = np.concatenate([outs["ids"].numpy()] * 2).astype(np.int32)
    want = jax_select_feats(jb.feats, jnp.asarray(both), jb.offsets, jb.num_patches,
                            jb.cluster_tables, jb.cluster_sizes,
                            jnp.asarray(outs["actions"].numpy()), feat_size=feat,
                            max_patches=jb.max_patches)
    assert outs["select"].shape == (2 * b, feat, d)
    # equal values (JAX's empty slots may be -0.0)
    np.testing.assert_array_equal(outs["select"].float().numpy(),
                                  np.asarray(want).astype(np.float32))


def test_fused_forward_is_jax_xla(ran):
    _, outs = ran
    x = outs["x"].float()
    m, p, s = dbg_step.fused_forwards(x, outs["weights"], 1, dropout=0.0)[1]
    tree = jax_from_params(outs["model"].state_dict())[0]["params"]
    fc, at = tree["fc"], tree["attn"]
    jm, jp, js = fused_trunk_attention_pool_xla(
        jnp.asarray(x.numpy()), fc["kernel"], fc["bias"], at["wa"], at["ba"], at["wb"],
        at["bb"], at["wc"][:, 0], at["bc"][0], gated=True, dropout=0.0)
    for got, want in ((m, jm), (p, jp), (s, js)):
        assert _rel(got.detach().numpy(), want) <= 1e-5


def test_default_device_is_the_card():
    args = dbg_step.parse_args([])
    assert args.device == "cuda:0" and tuple(args.shape) == dbg_step.SHAPE and args.k == 8
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dbg_step.run()
