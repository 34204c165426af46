"""The port's PPO learning check (``murcl_tpu_torch/scripts/ppo_sanity.py``)
against the JAX package's ``scripts/ppo_sanity.py``, on the CPU.

- The positional bank equals the JAX script's ``build_positional_bank()``
  bitwise (features, cluster lists, labels), and the slide ids come from the
  same ``default_rng(1)`` sequence. The JAX script is imported by path; its
  ``main`` (35 s) runs in no test.
- The CLI at the JAX script's widths (dim 32, L 32, D 8) prints one JSON
  line with the JAX script's keys, and it holds the three directions of
  learning: confidence with the policy's windows above confidence with random
  windows, the probe's mean action falling, the mean reward of the last five
  epochs above that of the first five. Directions only, since torch's random
  streams are not JAX's (``PARITY.md:42-44``); the seeds are the JAX
  script's. At these widths all three held at every CPU thread count tried
  (1, 2, 3, 4, 6, 8).
- ``run(device="cpu")`` at ABMIL's widths (512, 512, 128), the shape
  ``chip_smoke.py`` runs on the card: the same keys, finite numbers, stage 1
  learning (its last ten losses below half its first ten) and both
  confidences above 0.75 (chance is 0.5). The three PPO directions are not
  held there: stage 1 alone reaches 0.93-0.997 with random windows, and the
  CPU's thread count alone decides which directions hold (``PERF.md``,
  section 6).
"""

import ast
import importlib.util
import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from murcl_tpu_torch.scripts import ppo_sanity as ps

REPO = Path(__file__).resolve().parents[1]
JAX_SCRIPT = REPO / "scripts" / "ppo_sanity.py"


def jax_script():
    spec = importlib.util.spec_from_file_location("jax_ppo_sanity", JAX_SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_report_keys():
    """The keys of the dict the JAX script's ``main`` prints."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    (node,) = [n for n in ast.walk(tree) if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "report" for t in n.targets)]
    return [k.value for k in node.value.keys]


def clusters_of(patch_cluster, patch_pos, num_patches, k):
    """Each slide's cluster lists from its per-patch (cluster, position)."""
    out = []
    for pc, pp, n in zip(patch_cluster, patch_pos, num_patches):
        cl = [[] for _ in range(k)]
        for i in np.argsort(pp[:n], kind="stable"):
            cl[pc[i]].append(int(i))
        out.append(cl)
    return out


def test_positional_bank_and_slide_ids_match_jax_script():
    js = jax_script()
    assert (js.SLIDES, js.N, js.K, js.FEAT, js.T, js.B) == (ps.SLIDES, ps.N, ps.K, ps.FEAT,
                                                            ps.T, ps.B)
    want = js.build_positional_bank()
    got = ps.build_positional_bank(js.DIM)
    rows = ps.SLIDES * ps.N
    np.testing.assert_array_equal(got.feats.numpy(), want.feats[:rows])
    assert not want.feats[rows:].any()  # the JAX bank's zero padding rows
    for name in ("offsets", "num_patches", "cluster_sizes", "labels"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(want, name),
                                      err_msg=name)
    want_cl = [[list(want.cluster_tables[s, k, :want.cluster_sizes[s, k]])
                for k in range(ps.K)] for s in range(ps.SLIDES)]
    got_cl = clusters_of(got.patch_cluster.numpy(), got.patch_pos.numpy(),
                         got.num_patches.numpy(), ps.K)
    assert got_cl == want_cl
    assert sorted(set(got.labels.tolist())) == [0, 1]

    # the JAX script's draws: 150 stage-1 steps, then 15 x 8 stage-2 steps
    rng = np.random.default_rng(1)
    batches = ps.slide_batches()
    for _ in range(ps.STAGE1_STEPS + ps.EPOCHS * ps.EPOCH_STEPS):
        np.testing.assert_array_equal(next(batches), rng.choice(js.SLIDES, js.B, replace=False))


def test_cli_at_jax_widths_learns(capsys):
    ps.main(**vars(ps.parse_args(["--device", "cpu", "--dim", "32", "--L", "32", "--D",
                                  "8"])))
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    report = json.loads(lines[0])
    assert list(report) == jax_report_keys()
    assert len(report["rewards_per_epoch"]) == ps.EPOCHS
    assert all(math.isfinite(v) for v in report["rewards_per_epoch"])
    assert ps.directions(report) == dict.fromkeys(ps.directions(report), True), report


def test_run_at_card_widths_on_plain_path():
    s = ps.run(device="cpu")
    report = s.report()
    assert list(report) == jax_report_keys()
    values = [*s.stage1_losses, *s.rewards, *s.actions, s.conf_random, s.conf_policy]
    assert all(math.isfinite(v) for v in values)
    assert all(bool(w.isfinite().all()) for w in s.weights.values())
    assert s.weights["model.encoder.0.weight"].shape == (512, 512)
    assert s.weights["model.attention.0.weight"].shape == (128, 512)
    assert np.mean(s.stage1_losses[-10:]) < 0.5 * np.mean(s.stage1_losses[:10])
    assert min(s.conf_random, s.conf_policy) > 0.75, report


def test_default_device_is_the_card():
    args = ps.parse_args([])
    assert (args.device, args.compute_dtype, args.dim, args.L, args.D) == (
        "cuda:0", "float32", 512, 512, 128)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):  # no fallback to the CPU
            ps.run(device="cuda:0")
