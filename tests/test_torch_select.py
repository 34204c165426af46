"""Port's sub-bag selection and plain compaction vs the JAX package.

``select_ranks`` is bitwise equal to JAX's under the same actions; the
plain compaction is bitwise equal to ``gather_compact_xla`` in f32 and
bf16, including truncation (feat_size below the selection) and zero
padding (feat_size above it), and on the cases K1's tiles must get right
(``tests/torch_compact_cases.py``: a ragged last tile at feat 1000, 400-byte
rows, ``num_patches`` below nmax 4096, bags with no live rank, every slot
live in a permuted order), where JAX's golden takes the ranks past
``num_patches`` as unselected.
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.ops.compact_pallas import gather_compact_xla
from murcl_tpu.ops.select import select_ranks as jax_select_ranks
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.ops.compact import gather_compact
from murcl_tpu_torch.ops.select import select_feats, select_ranks
from torch_compact_cases import CASES, compact_case, golden_ranks

DIM, K = 16, 4


def _slides(seed, n_slides=6, min_n=10, max_n=120):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(n_slides):
        n = int(rng.integers(min_n, max_n + 1))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    return rng, feats, clusters


@pytest.mark.parametrize("seed,feat_size", [(0, 32), (1, 64), (2, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ranks_and_compaction_match_jax(seed, feat_size, dtype):
    rng, feats, clusters = _slides(seed)
    labels = [0] * len(feats)
    jbank = jax_bank_from_arrays(feats, clusters, labels)
    tbank = bank_from_arrays(feats, clusters, labels)
    ids = np.concatenate([np.arange(len(feats)), rng.integers(0, len(feats), 4)])
    actions = rng.random((len(ids), K)).astype(np.float32)

    jranks, joffs, jvalid = jax_select_ranks(
        jnp.asarray(ids, jnp.int32), jbank.offsets, jbank.num_patches,
        jbank.cluster_sizes, jnp.asarray(actions), jbank.patch_cluster,
        jbank.patch_pos, feat_size=feat_size)
    tranks, toffs, tvalid = select_ranks(
        torch.tensor(ids), tbank.offsets, tbank.num_patches, tbank.cluster_sizes,
        torch.tensor(actions), tbank.patch_cluster, tbank.patch_pos, feat_size)
    jr = np.asarray(jranks)
    n_max = tbank.max_patches
    np.testing.assert_array_equal(tranks.numpy(), jr[:, :n_max])
    assert (jr[:, n_max:] == -1).all()  # the JAX bank pads Nmax to 256
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    # some bag truncates and some zero-pads at this feat_size
    counts = (jr >= 0).sum(1)
    assert feat_size in (32, 64) or (counts < feat_size).any()

    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(gather_compact_xla(jbank.feats.astype(jdt), joffs, jranks,
                                         feat_size))
    tdt = getattr(torch, dtype)
    got = gather_compact(tbank.feats.to(tdt), toffs, tranks, feat_size,
                         tbank.num_patches[torch.tensor(ids)])
    if dtype == "bfloat16":
        got = got.view(torch.int16).numpy()
        want = want.view(ml_dtypes.bfloat16).view(np.int16)
    else:
        got = got.numpy().view(np.int32)
        want = want.view(np.int32)
    np.testing.assert_array_equal(got, want)

    sel = select_feats(tbank.to("cpu", tdt), torch.tensor(ids),
                       torch.tensor(actions), feat_size)
    assert torch.equal(sel, gather_compact(tbank.feats.to(tdt), toffs, tranks,
                                           feat_size, tbank.num_patches[torch.tensor(ids)]))


def test_cuda_path_never_falls_back():
    """A non-CPU tensor goes to the kernel wrapper, which raises here."""
    _, feats, clusters = _slides(3, n_slides=2)
    bank = bank_from_arrays(feats, clusters, [0, 1])
    ranks = torch.zeros((2, bank.max_patches), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        gather_compact(bank.feats.to("meta"), bank.offsets, ranks, 8,
                       bank.num_patches)


def _bits(x, dtype):
    if dtype == "bfloat16":
        return np.asarray(x).view(ml_dtypes.bfloat16).view(np.int16) \
            if isinstance(x, np.ndarray) else x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int32) if isinstance(x, np.ndarray) \
        else x.numpy().view(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_compaction_cases_match_jax(case, dtype):
    bank, offs, ranks, nump, feat = compact_case(case)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(gather_compact_xla(jnp.asarray(bank).astype(jdt), jnp.asarray(offs),
                                         jnp.asarray(golden_ranks(ranks, nump)), feat))
    got = gather_compact(torch.from_numpy(bank).to(getattr(torch, dtype)),
                         torch.from_numpy(offs), torch.from_numpy(ranks), feat,
                         torch.from_numpy(nump))
    assert got.shape == (len(offs), feat, bank.shape[1])
    np.testing.assert_array_equal(_bits(got, dtype), _bits(want, dtype))
    zero_slots = (got == 0).all(-1)
    if case == "empty":
        assert zero_slots[:2].all() and not zero_slots[2:].all()
    if case == "full":
        assert not zero_slots.any()
