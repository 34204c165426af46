"""The port of ``scripts/dbg_select.py`` (``murcl_tpu_torch/scripts/dbg_select.py``)
on the CPU, at a small size: 4 slides of 96 patches, D 32, feat 64, 8 bags, T 2.

It runs end to end with ``--device cpu`` (the plain twins, timed by the
host's clock) and times every piece; its bank is the JAX script's (the same
``np.random.default_rng(0)`` draws, in bf16); the last ``select`` step's
output equals the JAX package's ``select_feats`` on the same bank and
actions (its empty slots may be -0.0 there), and its ``compact`` output is
bitwise JAX's golden compaction of the first selection; the gather and the mixup keep the selection's rows. Without
a card its default device raises: no fallback to the CPU.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.ops.compact_pallas import gather_compact_xla
from murcl_tpu.ops.select import select_feats as jax_select_feats
from murcl_tpu.ops.select import select_ranks as jax_select_ranks
from murcl_tpu_torch.scripts import dbg_select

SHAPE = (4, 96, 32, 64, 8, 2)


def _jax_bank(slides, patches, d):
    """The JAX script's bank, drawn as ``scripts/dbg_select.py`` draws it."""
    rng = np.random.default_rng(0)
    feats, clusters = [], []
    for _ in range(slides):
        feats.append(rng.normal(size=(patches, d)).astype(np.float32))
        a = rng.integers(0, dbg_select.K, size=patches)
        clusters.append([[int(j) for j in np.where(a == c)[0]] for c in range(dbg_select.K)])
    return jax_bank_from_arrays(feats, clusters, [0] * slides).device(dtype=jnp.bfloat16)


def _bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(ml_dtypes.bfloat16).view(np.int16)


def test_runs_on_cpu_against_jax(capsys):
    outs = {}
    times = dbg_select.run("cpu", SHAPE, reps=1, outs=outs)
    assert set(times) == set(dbg_select.PIECES) and all(v > 0 for v in times.values())
    out = capsys.readouterr().out
    assert all(f"2x {p}" in out for p in dbg_select.PIECES) and "CPU, plain twins" in out
    slides, patches, d, feat, b, _ = SHAPE
    bank, ids = outs["bank"], outs["ids"]
    jb = _jax_bank(slides, patches, d)
    np.testing.assert_array_equal(_bf16_bits(bank.feats), _bf16_bits(jb.feats[:bank.feats.shape[0]]))
    jids = jnp.asarray(ids.numpy(), jnp.int32)
    want = jax_select_feats(jb.feats, jids, jb.offsets, jb.num_patches, jb.cluster_tables,
                            jb.cluster_sizes, jnp.asarray(outs["actions"].numpy()),
                            feat_size=feat, max_patches=jb.max_patches)
    assert outs["select"].shape == (b, feat, d)
    # equal values: JAX's select_feats zeroes empty slots by a product with
    # the valid mask, which gives -0.0 where row 0 is negative
    np.testing.assert_array_equal(outs["select"].float().numpy(),
                                  np.asarray(want).astype(np.float32))
    # K1 alone on the first selection's ranks against JAX's golden
    ranks, offs, _ = jax_select_ranks(jids, jb.offsets, jb.num_patches, jb.cluster_sizes,
                                      jnp.asarray(outs["first_actions"].numpy()),
                                      jb.patch_cluster, jb.patch_pos, feat_size=feat)
    np.testing.assert_array_equal(_bf16_bits(outs["compact"]),
                                  _bf16_bits(gather_compact_xla(jb.feats, offs, ranks, feat)))
    # the gather's and the mixup's inputs: the first selection's rows, bank
    # row 0 in its empty slots (as the JAX script takes them)
    x0, empty = outs["x0"], (outs["compact"] == 0).all(-1)
    assert torch.equal(x0[~empty], outs["compact"][~empty])
    assert (x0[empty] == bank.feats[0]).all() and outs["gather"].shape == (b * feat, d)
    lam, perm = outs["mix"]
    assert torch.equal(outs["mixup"], (lam[:, None, None].to(x0.dtype) * x0
                                       + (1.0 - lam[:, None, None]).to(x0.dtype) * x0[perm]))


def test_default_device_is_the_card():
    assert dbg_select.parse_args([]).device == "cuda:0"
    assert tuple(dbg_select.parse_args([]).shape) == dbg_select.SHAPE
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dbg_select.run()
