"""The port's data-parallel MuRCL engine and its launcher on the CPU: two gloo
ranks (``murcl_tpu_torch.parallel.launch``), rendezvous by file in
``tmp_path``, against the JAX ``ContrastiveEngine(mesh=data_mesh(2))``.

The ranks run ``tests/torch_dp_ranks.py`` (no ``jax`` in them); this process
builds the JAX side, the weights (``params_from_jax``) and each rank's draws,
rebuilt from JAX's per-shard keys ``fold_in(step_rng, i)`` as
``tests/test_parallel.py:505-512`` does, and spawns the ranks once for all
the engine cases. Per rank b = 3 slides, feat_size 24, dim 16, K 3, T 3,
f32, dropout 0, Adam at the CLIs' 1e-4.

- Stage 1, ABMIL and CLAM_SB: loss and step losses within rtol 1e-5 of the
  mesh engine's; every weight after one Adam step within rtol 1e-4 plus
  1e-6 (``tests/test_parallel.py:462-470``), but CLAM's score bias
  ``attention_c.bias``, whose true gradient is 0 (softmax ignores a shift),
  so that both sides' rounding noise moves it by up to the rate either way
  (``tests/test_torch_engine.py``); both ranks' weights bitwise equal.
- Stage 3 (CLAM_SB, the policy driving the actions): the same, and the
  policy unmoved.
- Stage 2 (CLAM_SB): step losses within rtol 1e-5; each view's rollout
  gathered in rank order, and the policy's update (all its weights as one
  vector) within 2e-2 relative Frobenius of the update of JAX's
  ``PPO.update`` applied to the gathered rollouts, view 0 then view 1
  (``tests/test_torch_contrastive_stages.py`` says why the rollouts are the
  port's); each weight within 4 x the PPO rate of JAX's own mesh step (the
  bound of ``tests/test_torch_contrastive_stages.py``). Not elementwise
  against the update on the same rollouts: over the step's four Adam
  updates a weight whose gradient sits near eps moves by a share of the
  rate whatever the rounding (4e-4 on 28 of 65,536 encoder weights in one
  draw), while an update on one rank's rollout alone, or in another order,
  moves most weights otherwise. Both ranks' policies bitwise equal, and the
  aggregator untouched.
- The dp-2 step against the port's own single-process step on the same
  global batch, fed the ranks' draws concatenated, the mixup permutations
  block-diagonal: loss within rtol 1e-5, weights within rtol 1e-4 plus 1e-6
  (CLAM's score bias within the rate of its start, as above).
- The collectives' values and gradients, exactly; a rank's exception
  re-raised in the launching process; ``--batch_size`` not a multiple of
  ``--dp_devices`` refused with ``ValueError``; and the kernel build's file
  lock: two processes building at once with ``nvcc`` replaced by a stub
  compile once and leave one library.
"""

import os
import stat
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.models.clam as jax_clam
import murcl_tpu_torch.models.clam as torch_clam
import torch_dp_ranks as ranks
from murcl_tpu.data.bank import bank_from_arrays as jax_bank_from_arrays
from murcl_tpu.engine import BankArrays
from murcl_tpu.engine import ContrastiveEngine as JaxEngine
from murcl_tpu.engine import PretrainConfig as JaxConfig
from murcl_tpu.engine.optim import make_optimizer as jax_make_optimizer
from murcl_tpu.models import ABMIL as JaxABMIL
from murcl_tpu.models import CLAM_SB as JaxCLAM
from murcl_tpu.models import FullLayer as JaxFullLayer
from murcl_tpu.models.rlmil import PPO as JaxPPO
from murcl_tpu.models.rlmil import Rollout as JaxRollout
from murcl_tpu.ops.mixup import mixup_factors as jax_mixup_factors
from murcl_tpu.parallel import data_mesh
from murcl_tpu_torch.drivers.common import dp_world
from murcl_tpu_torch.drivers.murcl import default_args as murcl_defaults
from murcl_tpu_torch.engine.weights import params_from_jax, policy_from_jax
from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.parallel import launch
from murcl_tpu_torch.train_MuRCL import main as murcl_main

N, B_RANK = 2, 3
B = N * B_RANK
DIM, K, T, FEAT, HID = ranks.DIM, ranks.K, ranks.T, ranks.FEAT, ranks.HID
WIDTH, PROJ, ALPHA, LR = ranks.WIDTH, ranks.PROJ, ranks.ALPHA, ranks.LR
CASES = [("ABMIL", 1), ("CLAM_SB", 1), ("CLAM_SB", 3), ("CLAM_SB", 2)]
REPO = Path(__file__).resolve().parents[1]


def _data(seed):
    rng = np.random.default_rng(seed)
    feats, clusters = [], []
    for _ in range(8):
        n = int(rng.integers(16, 48))
        feats.append(rng.normal(size=(n, DIM)).astype(np.float32))
        a = rng.integers(0, K, size=n)
        clusters.append([[int(i) for i in np.where(a == k)[0]] for k in range(K)])
    return feats, clusters, [0] * 8, rng.permutation(8)[:B]


def _stage1_draws(step_rng):
    """Each shard's actions and mixup draws (``engine/contrastive.py:204,225``
    after ``fold_in(step_rng, shard)``), port layout."""
    out = []
    for i in range(N):
        _, r_act, r_mix, _ = jax.random.split(jax.random.fold_in(step_rng, i), 4)
        actions = jax.random.uniform(r_act, (T, 2, B_RANK, K))
        lams, perms = jax.vmap(lambda k: jax_mixup_factors(k, B_RANK, ALPHA))(
            jax.random.split(r_mix, T * 2))
        out.append({"actions": torch.tensor(np.asarray(actions)),
                    "mix": (torch.tensor(np.asarray(lams)[..., 0]),
                            torch.tensor(np.asarray(perms)))})
    return out


def _sequential_draws(step_rng):
    """Each shard's draws of ``_rollout_sequential`` (as
    ``tests/test_torch_contrastive_stages.py`` rebuilds them, per shard)."""
    out = []
    for i in range(N):
        rest, ra0, ra1, rv0 = jax.random.split(jax.random.fold_in(step_rng, i), 4)
        actions0 = np.stack([np.asarray(jax.random.uniform(r, (B_RANK, K))) for r in (ra0, ra1)])
        step_keys, noise = [rv0], []
        for rt in jax.random.split(rest, T - 1):
            r_aa, r_ab, r_va, _ = jax.random.split(rt, 4)
            noise.append([np.asarray(jax.random.normal(r, (B_RANK, K))) for r in (r_aa, r_ab)])
            step_keys.append(r_va)
        lams, perms = [], []
        for key in step_keys:
            draws = [jax_mixup_factors(k, B_RANK, ALPHA) for k in jax.random.split(key, 3)[:2]]
            lams.append([np.asarray(lam)[:, 0] for lam, _ in draws])
            perms.append([np.asarray(perm) for _, perm in draws])
        out.append({"actions0": torch.tensor(actions0), "noise": torch.tensor(np.asarray(noise)),
                    "mix": (torch.tensor(np.asarray(lams)), torch.tensor(np.asarray(perms)))})
    return out


def _jax_side(arch, stage, seed):
    """The JAX mesh engine's step and the case the ranks run."""
    feats, clusters, labels, ids = _data(seed)
    if arch == "ABMIL":
        jmodel = JaxABMIL(dim_in=DIM, L=WIDTH, D=8, dim_out=PROJ, dropout=0.0)
    else:
        jmodel = JaxCLAM(n_classes=PROJ, **ranks.CLAM_KW)
    jfc = JaxFullLayer(feature_num=WIDTH, hidden_state_dim=HID, class_num=PROJ)
    jcfg = JaxConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, max_patches=256,
                     train_stage=stage, alpha=ALPHA, temperature=ranks.TEMP, batch_size=B,
                     remat="none")
    jppo = JaxPPO(state_dim=WIDTH, **ranks.PPO_KW) if stage != 1 else None
    tx = jax_make_optimizer("Adam", backbone_lr=LR, fc_lr=LR) if stage != 2 else None
    jengine = JaxEngine(jcfg, jmodel, jfc, ppo=jppo, tx=tx, mesh=data_mesh(N))
    params = jengine.init_params(jax.random.PRNGKey(seed), jnp.zeros((B, FEAT, DIM)))
    pstate = jppo.init(jax.random.PRNGKey(seed + 1), jnp.zeros((B, WIDTH))) if jppo else None
    jbank = BankArrays.from_bank(jax_bank_from_arrays(feats, clusters, labels).device())
    step_rng = jax.random.PRNGKey(100 + seed)
    agg, new_pstate, jstats = jengine.train_step(jengine.init_state(params), pstate, jbank,
                                                 jnp.asarray(ids, jnp.int32), step_rng)
    msd, fsd = params_from_jax(params["model"], params["fc"], arch=arch)
    case = {"kind": "contrastive", "arch": arch, "stage": stage, "feats": feats,
            "clusters": clusters, "labels": labels, "ids": ids, "model": msd, "fc": fsd,
            "policy": policy_from_jax(pstate.params) if pstate else None,
            "draws": (_stage1_draws if stage == 1 else _sequential_draws)(step_rng)}
    want = {"stats": jstats, "params": agg.params, "pstate": pstate,
            "new_pstate": new_pstate, "jengine": jengine}
    return case, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's steps, and every case run once by two gloo ranks."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jax_clam.SIZE_DICT, "tiny", (WIDTH, 16))
        sides = {key: _jax_side(*key, seed=i) for i, key in enumerate(CASES)}
    cases = [sides[key][0] for key in CASES]
    got = launch(N, ranks.run_cases, cases, run_dir=tmp_path_factory.mktemp("dp"))
    return {key: (sides[key][0], sides[key][1], [got[r][0][i] for r in range(N)])
            for i, key in enumerate(CASES)}


def _assert_ranks_equal(outs, parts=("model", "fc", "policy", "policy_old")):
    for part in parts:
        if part in outs[0]:
            for k, v in outs[0][part].items():
                assert torch.equal(v, outs[1][part][k]), (part, k)


def _assert_weights(out, params, arch):
    want_m, want_f = params_from_jax(params["model"], params["fc"], arch=arch)
    for part, want in (("model", want_m), ("fc", want_f)):
        for name, v in out[part].items():
            if name.endswith("attention_c.bias"):
                continue  # checked against its start below
            np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-4, atol=1e-6,
                                       err_msg=f"{part}.{name}")


@pytest.mark.parametrize("arch,stage", [("ABMIL", 1), ("CLAM_SB", 1), ("CLAM_SB", 3)])
def test_training_step_matches_the_mesh_engine(runs, arch, stage):
    case, want, outs = runs[arch, stage]
    _assert_ranks_equal(outs)
    for out in outs:
        np.testing.assert_allclose(float(out["loss"]), float(want["stats"].loss), rtol=1e-5)
        np.testing.assert_allclose(out["step_losses"].numpy(),
                                   np.asarray(want["stats"].step_losses), rtol=1e-5)
    np.testing.assert_allclose(outs[0]["rewards"].numpy(), np.asarray(want["stats"].rewards),
                               rtol=1e-5, atol=1e-6)
    _assert_weights(outs[0], want["params"], arch)
    for name, v in outs[0]["model"].items():
        if name.endswith("attention_c.bias"):
            assert float((v - case["model"][name]).abs().max()) <= 1.01 * LR
    if stage == 3:  # the policy only acts
        for k, v in case["policy"].items():
            assert torch.equal(outs[0]["policy"][k], v), k


def test_stage2_ppo_updates_on_the_gathered_rollouts(runs):
    case, want, outs = runs["CLAM_SB", 2]
    _assert_ranks_equal(outs)
    np.testing.assert_allclose(outs[0]["step_losses"].numpy(),
                               np.asarray(want["stats"].step_losses), rtol=1e-5)
    for part in ("model", "fc"):
        for k, v in case[part].items():
            assert torch.equal(outs[0][part][k], v), (part, k)
    pstate = want["pstate"]
    for view in (0, 1):  # view 0 first, on the rollouts gathered in rank order
        gathered = [torch.cat([o["rollouts"][view][f] for o in outs], dim=1) for f in range(4)]
        pstate, _ = want["jengine"].ppo.update(
            pstate, JaxRollout(*(jnp.asarray(x.numpy()) for x in gathered)))
    target, moved = policy_from_jax(pstate.params), policy_from_jax(want["new_pstate"].params)
    assert ranks.update_err(outs[0]["policy"], case["policy"], target) <= 2e-2
    for name, v in outs[0]["policy"].items():
        assert torch.equal(outs[0]["policy_old"][name], v), name
        # JAX's own mesh step moved the same weights, by as much
        np.testing.assert_allclose(v.numpy(), moved[name].numpy(), rtol=0,
                                   atol=4 * ranks.PPO_KW["lr"], err_msg=name)


def test_dp_step_equals_the_single_process_step(runs, monkeypatch):
    """Rank r's draws in rows [r*b, (r+1)*b) of one global draw, each rank's
    mixup partners kept in its block: the single process computes the same
    function."""
    from murcl_tpu_torch.parallel import SINGLE

    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (WIDTH, 16))
    for arch in ("ABMIL", "CLAM_SB"):
        case, _, outs = runs[arch, 1]
        draws = case["draws"]
        lams = torch.cat([d["mix"][0] for d in draws], dim=1)
        perms = torch.cat([d["mix"][1] + r * B_RANK for r, d in enumerate(draws)], dim=1)
        single = dict(case, draws=[{"actions": torch.cat([d["actions"] for d in draws], dim=2),
                                    "mix": (lams, perms)}])
        got = ranks.run_case(SINGLE, single)
        np.testing.assert_allclose(float(outs[0]["loss"]), float(got["loss"]), rtol=1e-5)
        for part in ("model", "fc"):
            for k, v in got[part].items():
                if k.endswith("attention_c.bias"):
                    assert float((v - case["model"][k]).abs().max()) <= 1.01 * LR
                    continue
                np.testing.assert_allclose(outs[1][part][k].numpy(), v.numpy(), rtol=1e-4,
                                           atol=1e-6, err_msg=f"{arch} {part}.{k}")


def test_collectives(tmp_path):
    outs = [value for value, _ in launch(N, ranks.collectives, run_dir=tmp_path)]
    rows = torch.cat([torch.arange(6.0).reshape(3, 2) + 10 * r for r in range(N)])
    weights = torch.arange(12.0).reshape(6, 2)
    for r, out in enumerate(outs):
        assert torch.equal(out["gather"], rows)
        assert torch.equal(out["gather_grad"], weights[3 * r:3 * (r + 1)])  # its rows alone
        assert torch.equal(out["along1"], torch.cat([torch.full((2, 3), 1.0),
                                                     torch.full((2, 3), 2.0)], dim=1))
        assert float(out["sum"]) == 1.0 and float(out["mean"]) == 0.5
        assert float(out["all_sum"]) == 9.0 and float(out["all_sum_grad"]) == 3.0
        assert torch.equal(out["grads"], torch.full((4,), 3.0)) and out["nbytes"] == 16
    assert not list(tmp_path.iterdir())  # the rendezvous file is gone


def test_a_rank_failure_reaches_the_launcher(tmp_path):
    with pytest.raises(ValueError, match="rank 1 fails on purpose"):
        launch(N, ranks.failing, 1, run_dir=tmp_path)


def test_batch_size_must_divide_over_the_ranks(synthetic_dataset, tmp_path):
    assert dp_world(murcl_defaults(dp_devices=0)) == 1
    assert dp_world(murcl_defaults(dp_devices=4, batch_size=8)) == 4
    with pytest.raises(ValueError, match="divisible"):
        dp_world(murcl_defaults(dp_devices=3, batch_size=8))
    with pytest.raises(ValueError, match="divisible"):
        murcl_main(["--data_csv", synthetic_dataset["data_csv"], "--data_split_json",
                    synthetic_dataset["data_split_json"], "--device", "cpu", "--batch_size",
                    "3", "--dp_devices", "2", "--base_save_dir", str(tmp_path)])
    assert not list(tmp_path.iterdir())  # refused before a run directory exists


STUB_NVCC = """#!{python}
import sys, time
from pathlib import Path
args = sys.argv[1:]
out = Path(args[args.index("-o") + 1])
with open(Path(sys.argv[0]).parent / "calls.log", "a") as log:
    log.write(("link" if "-shared" in args else "compile") + "\\n")
if "-shared" in args:
    out.write_bytes(b"".join(Path(a).read_bytes() for a in args if a.endswith(".o")))
else:
    src = Path(args[-1])
    time.sleep(0.2)
    out.write_bytes(b"[" + src.name.encode() + b"]")
"""


def test_concurrent_builds_compile_once(tmp_path):
    """Two processes needing the kernel library at once, ``nvcc`` a stub that
    records its calls: one compiles every source and links, the other waits
    on the lock and finds the library; no object or temporary is left."""
    stub = tmp_path / "bin" / "nvcc"
    stub.parent.mkdir()
    stub.write_text(STUB_NVCC.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    code = ("import sys; from pathlib import Path; from murcl_tpu_torch.ops import _cuda; "
            f"_cuda.BUILD_DIR = Path({str(build)!r}); print(_cuda.build())")
    env = dict(os.environ, PATH=f"{stub.parent}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    sources = _cuda.sources()
    calls = (stub.parent / "calls.log").read_text().split()
    assert calls.count("compile") == len(sources) and calls.count("link") == 1, calls
    libs = sorted(p.name for p in build.iterdir() if not p.name.startswith("."))
    assert len(libs) == 1 and libs[0].endswith(".so"), libs
    assert {o.strip() for o, _ in outs} == {str(build / libs[0])}
    assert (build / libs[0]).read_bytes() == b"".join(b"[" + s.name.encode() + b"]"
                                                       for s in sources)


def test_probe_library_builds_apart(tmp_path):
    """The measurement probes' library, ``nvcc`` the recording stub: the
    kernel library's sources leave out the probes' own, and the probe
    library, built on its own, compiles the probes' sources beside
    fused_trunk.cu (whose passes they run) and nothing else."""
    stub = tmp_path / "bin" / "nvcc"
    stub.parent.mkdir()
    stub.write_text(STUB_NVCC.format(python=sys.executable))
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    build = tmp_path / "build"
    code = ("from pathlib import Path; from murcl_tpu_torch.ops import _cuda; "
            f"_cuda.BUILD_DIR = Path({str(build)!r}); print(_cuda.build(probes=True))")
    env = dict(os.environ, PATH=f"{stub.parent}{os.pathsep}{os.environ['PATH']}",
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    probes = _cuda.sources(probes=True)
    assert [p.name for p in probes] == sorted(_cuda.PROBE_SOURCES)
    kernels = {p.name for p in _cuda.sources()}
    assert "fused_trunk.cu" in kernels and not kernels & {"fused_trunk_ablate.cu",
                                                          "wgmma_overlap.cu"}
    libs = [p for p in build.iterdir() if not p.name.startswith(".")]
    assert [p.name for p in libs] == [_cuda.library_path(probes=True).name]
    assert libs[0].name.startswith("libmurcl_probes_")
    assert libs[0].read_bytes() == b"".join(b"[" + s.name.encode() + b"]" for s in probes)
    assert _cuda.library_path(probes=True) != _cuda.library_path()

