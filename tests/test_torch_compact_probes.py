"""The one-hot compaction probes' twins on the CPU, against the JAX package.

``ops/compact_probes.py`` holds the plain twin of each variant of the ports
of ``scripts/dbg_compact_ablate.py``, ``dbg_grouped_ablate.py`` and
``dbg_grouped_gate.py`` (``onehot_compact_plain``, the one-hot formulation
walked tile by tile as the JAX kernels' loops walk it). Here, at a small
shape (4 slides x 4 repeats of 512-row windows, feat 384, D 64, tile 128,
slides ending at 512, 300, 512 and 129 rows, their later ranks -1; feat 384
because the JAX kernels' band needs feat > 256):

- each twin that keeps the result equals, bitwise, the JAX package's golden
  ``gather_compact_xla`` and its Pallas kernels in interpret mode, as
  ``tests/test_compact_pallas.py`` runs them: the tiled banded kernel
  (``variant="tiled", band="on", tile=128``) bag by bag, and the grouped
  kernel (``repeat=4``) at groups 2 and 4 with ``ragged_gate`` on and off;
  the grouped twins at both groups;
- ``normw``, ``noonehot`` and ``dmafloor``, which compute something else,
  equal the JAX scripts' kernel bodies restated in jnp (``make_kernel``'s,
  closures of each script's ``main()``; the TPU-only scripts cannot be run
  here): ``normw`` and ``dmafloor`` bitwise, ``noonehot`` within 1e-2
  relative Frobenius (its tile sums of 128 rows in f32 are rounded to bf16
  and added in bf16: a sum taken in another order can round one ulp apart);
- each script runs end to end with ``--device cpu``, every variant's output
  its twin's, and without a card its default device raises.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu.ops.compact_pallas import gather_compact, gather_compact_xla
from murcl_tpu_torch.ops import compact_probes as cp
from murcl_tpu_torch.ops.compact import gather_compact_plain
from murcl_tpu_torch.scripts import dbg_compact_ablate, dbg_grouped_ablate, dbg_grouped_gate

S, REPEAT, NMAX, D, FEAT, TILE = 4, 4, 512, 64, 384, 128
B = S * REPEAT
ENDS = [512, 300, 512, 129]  # each slide's patch count


@pytest.fixture(scope="module")
def data():
    """The scripts' kind of operands at the small shape: a bf16 bank of 64
    windows and one more, the bags of ``REPEAT`` repeats of ``S`` slides, a
    Bernoulli(feat / nmax) selection inside each slide's patches, its cumsum
    cut at feat."""
    rng = np.random.default_rng(3)
    bank = torch.from_numpy(rng.normal(size=(65 * NMAX, D)) * 0.3).to(torch.bfloat16)
    offs = np.tile(rng.integers(0, 64, size=S) * NMAX, REPEAT)
    nump = np.tile(ENDS, REPEAT)
    sel = (rng.random((B, NMAX)) < FEAT / NMAX) & (np.arange(NMAX)[None, :] < nump[:, None])
    ranks = np.where(sel, np.cumsum(sel, axis=1) - 1, -1)
    ranks = np.where(ranks >= FEAT, -1, ranks).astype(np.int32)
    return bank, torch.from_numpy(offs), torch.from_numpy(ranks), torch.from_numpy(nump)


def _jax(bank):
    return jnp.asarray(bank.float().numpy()).astype(jnp.bfloat16)


@pytest.fixture(scope="module")
def jax_outputs(data):
    """The golden and the JAX Pallas kernels (interpret mode) on ``data``."""
    bank, offs, ranks, nump = data
    args = (_jax(bank), jnp.asarray(offs.numpy(), jnp.int32), jnp.asarray(ranks.numpy()), FEAT)
    n = jnp.asarray(nump.numpy(), jnp.int32)
    outs = {"golden": gather_compact_xla(*args),
            "tiled": gather_compact(*args, num_patches=n, interpret=True, variant="tiled",
                                    band="on", tile=TILE)}
    for group in (2, 4):
        for gate in ("on", "off"):
            outs[f"grouped g{group} {gate}"] = gather_compact(
                *args, num_patches=n, interpret=True, variant="tiled", band="on", tile=TILE,
                repeat=REPEAT, group=group, ragged_gate=gate)
    return {k: np.asarray(v.astype(jnp.float32)) for k, v in outs.items()}


KEPT = sorted(cp.KEEPS_RESULT)


@pytest.mark.parametrize("script,variant", KEPT)
def test_result_preserving_twins_match_jax_kernels(data, jax_outputs, script, variant):
    bank, offs, ranks, nump = data
    probe = cp.PROBES[script][variant]
    groups = (probe.group,) if probe.group == 1 else (2, 4)
    for group in groups:
        twin = cp.onehot_compact_plain(dataclasses.replace(probe, group=group), bank, offs,
                                       ranks, FEAT, nump, S)
        got = twin.float().numpy()
        assert np.array_equal(got, jax_outputs["golden"]), group
        for key, want in jax_outputs.items():
            if key == "tiled" or key.startswith(f"grouped g{group}"):
                assert np.array_equal(got, want), (group, key)
        assert torch.equal(twin, gather_compact_plain(bank, offs, ranks, FEAT, nump))


def _restated(script, mode, bank, offs, ranks, nump, chunk_tiles):
    """The JAX scripts' kernel bodies (``make_kernel`` in
    ``dbg_compact_ablate.py`` and ``dbg_grouped_ablate.py``), restated in
    jnp bag by bag: the bag-wise one with its per-tile gate and an f32
    accumulator, the grouped one without gates into its bf16 output block,
    the window read at the group's first bag."""
    bank = _jax(bank)
    offs, ranks, nump = offs.numpy(), ranks.numpy(), nump.numpy()
    slab, n_tiles = TILE + 128, NMAX // TILE
    grouped = script == "grouped"
    acc_dtype = jnp.bfloat16 if grouped else jnp.float32
    outs = []
    for i in range(B):
        lead = (i // (4 * S)) * 4 * S + i % S if grouped else i
        rows_buf = bank[offs[lead]:offs[lead] + (chunk_tiles * TILE if grouped else NMAX)]
        if mode == "dmafloor":
            outs.append(rows_buf[:FEAT])
            continue
        acc = jnp.zeros((FEAT, D), acc_dtype)
        base = 0
        iota_s = jax.lax.broadcasted_iota(jnp.int32, (slab, TILE), 0)
        const_oh = (iota_s < 1).astype(jnp.bfloat16)
        for t in range(n_tiles):
            if not grouped and not t * TILE < nump[i]:
                continue
            ranks_t = jnp.asarray(ranks[i, t * TILE:(t + 1) * TILE])[None, :]
            rows_t = bank[offs[lead] + t * TILE:offs[lead] + (t + 1) * TILE]
            base_al = min((base // 128) * 128, FEAT - slab)
            oh = const_oh if mode == "noonehot" else (iota_s + base_al == ranks_t).astype(
                jnp.bfloat16)
            prod = jnp.dot(oh, rows_t, preferred_element_type=jnp.float32)
            if mode == "normw":
                acc = acc.at[base_al:base_al + slab].set(prod.astype(acc_dtype))
            else:
                acc = acc.at[base_al:base_al + slab].add(prod.astype(acc_dtype))
            base += int(jnp.sum(ranks_t >= 0))
        outs.append(acc.astype(jnp.bfloat16))
    return np.asarray(jnp.stack(outs).astype(jnp.float32))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("script,variant", [("compact", "normw"), ("compact", "dmafloor"),
                                            ("grouped", "normw"), ("grouped", "noonehot"),
                                            ("grouped", "dmafloor")])
def test_other_twins_match_the_scripts_kernels(data, script, variant):
    bank, offs, ranks, nump = data
    probe = cp.PROBES[script][variant]
    got = cp.onehot_compact_plain(probe, bank, offs, ranks, FEAT, nump, S).float().numpy()
    want = _restated(script, variant, bank, offs, ranks, nump, probe.chunk_tiles)
    if variant == "noonehot":
        assert _rel(got, want) <= 1e-2 and got.any()
    else:
        assert np.array_equal(got, want)
    if variant != "dmafloor":  # the two differ from K1's result
        assert not np.array_equal(got, gather_compact_plain(bank, offs, ranks, FEAT,
                                                            nump).float().numpy())


def test_gates_skip_what_the_scripts_skip(data):
    """The grouped twins at the gate script's chunks: a slide ending at 129
    rows has one live chunk of 16 tiles and one live tile; every gate keeps
    K1's result, and the chunk-liveness gate changes only what is read."""
    bank, offs, ranks, nump = data
    want = gather_compact_plain(bank, offs, ranks, FEAT, nump)
    for v, probe in cp.GATE.items():
        assert torch.equal(cp.onehot_compact_plain(probe, bank, offs, ranks, FEAT, nump, S),
                           want), v


def test_scripts_run_on_cpu(capsys):
    """Each script end to end on the CPU; ``outs`` receives each timed call's
    output, here the twins' on the scripts' own inputs."""
    for mod, shape, script in ((dbg_compact_ablate, (6, 512, 64, 384), "compact"),
                               (dbg_grouped_ablate, (2, 4, 512, 64, 384), "grouped"),
                               (dbg_grouped_gate, (2, 4, 512, 64, 384), "gate")):
        outs = {}
        times = mod.run("cpu", shape, reps=1, outs=outs)
        assert set(times) == {"production", *mod.VARIANTS} == {"production", *cp.PROBES[script]}
        bank, offs, ranks, nump = outs["inputs"]
        slides = shape[0] if script != "compact" else 0
        for v in mod.VARIANTS:
            want = cp.onehot_compact_plain(cp.PROBES[script][v], bank, offs, ranks, shape[-1],
                                           nump, slides)
            assert torch.equal(outs[v], want), (script, v)
    out = capsys.readouterr().out
    assert "production (K1)" in out and "golden-exact: False" not in out
    assert out.count("golden-exact: True") == sum(1 for s, _ in cp.KEEPS_RESULT)


def test_default_device_is_the_card():
    for mod in (dbg_compact_ablate, dbg_grouped_ablate, dbg_grouped_gate):
        assert mod.parse_args([]).device == "cuda:0"
    if not torch.cuda.is_available():  # no fallback to the CPU
        for mod in (dbg_compact_ablate, dbg_grouped_ablate, dbg_grouped_gate):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                mod.run()
