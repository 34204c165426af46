"""Helpers of the data-parallel tests (``tests/test_torch_dp*.py``,
``tests/test_torch_cuda.py``): the rank-side halves, functions that
:func:`murcl_tpu_torch.parallel.launch` runs in each spawned rank, and the
checks of a CLI's dp run directories. This module imports no ``jax`` (the
rank processes stay free of it); the tests build the JAX side, the weights
and each rank's draws in the parent, and compare what the ranks return.

A *case* is a dict: ``kind`` (``contrastive`` or ``supervised``), ``arch``,
``stage``, the data (``feats``, ``clusters``, ``labels``), the global ``ids``
(and ``valid``), the starting weights (``model``, ``fc``, ``policy`` state
dicts), ``draws`` (one dict of injected draws per rank) and, for the
supervised engine, ``eval``: whether to score the split through
``drivers.rlmil._evaluate`` instead of taking a train step. ``dim`` and
``size`` (CLAM's) override :data:`DIM` and ``tiny``, for the kernels' widths.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

import murcl_tpu_torch.models.clam as torch_clam
from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.data.sources import ResidentSource
from murcl_tpu_torch.drivers import rlmil as rlmil_driver
from murcl_tpu_torch.engine.config import PretrainConfig, RolloutConfig
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.engine.optim import make_optimizer
from murcl_tpu_torch.engine.supervised import SupervisedEngine
from murcl_tpu_torch.models import ABMIL, CL, CLAM_SB, PPO, FullLayer, MILNet
from murcl_tpu_torch.models.rlmil import Rollout

DIM, K, T, FEAT, HID, PHID = 16, 3, 3, 24, 32, 16
WIDTH, PROJ, ALPHA, TEMP, LR = 32, 8, 0.9, 0.5, 1e-4  # LR: the CLIs' rates
PPO_KW = dict(hidden_state_dim=PHID, action_std=0.5, lr=1e-3, gamma=0.1, K_epochs=2,
              action_size=K)
CLAM_KW = dict(in_dim=DIM, gate=True, size_arg="tiny", dropout=0.0, subtyping=True)
# a MuRCL run directory's files, all rank 0's
FILES = {"args.json", "losses.csv", "results.csv", "checkpoint.pth.tar", "model_best.pth.tar"}


def tiny_clam() -> None:
    """CLAM's ``tiny`` size, (WIDTH, 16), as the JAX side sets it."""
    torch_clam.SIZE_DICT["tiny"] = (WIDTH, 16)


def aggregator(kind: str, arch: str, dim: int = DIM, size: str = "tiny"):
    """``(port aggregator, its bag-embedding width)`` of a case."""
    clam_kw = dict(CLAM_KW, in_dim=dim, size_arg=size)
    clam_width = torch_clam.SIZE_DICT[size][0]
    if kind == "contrastive":
        if arch == "ABMIL":
            return ABMIL(dim_in=dim, L=WIDTH, D=8, dim_out=PROJ, dropout=0.0), WIDTH
        return CLAM_SB(n_classes=PROJ, **clam_kw), clam_width
    if arch == "ABMIL":
        return ABMIL(dim_in=dim, L=WIDTH, D=16), WIDTH
    if arch == "DSMIL":
        return MILNet(dim_feat=dim, num_classes=2), dim
    return CLAM_SB(n_classes=2, k_sample=4, **clam_kw), clam_width


def _state(module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def _engine(dp, case, device):
    kind, arch, stage = case["kind"], case["arch"], case["stage"]
    model, width = aggregator(kind, arch, case.get("dim", DIM), case.get("size", "tiny"))
    model.load_state_dict(case["model"])
    fc = FullLayer(feature_num=width, hidden_state_dim=HID,
                   class_num=PROJ if kind == "contrastive" else 2)
    fc.load_state_dict(case["fc"])
    if kind == "contrastive":
        model = CL(model, projection_dim=PROJ)
    model, fc = model.to(device), fc.to(device)
    ppo = None
    if stage != 1:
        ppo = PPO(width, **PPO_KW).to(device)
        ppo.load_policy(case["policy"])
    opt = make_optimizer(model, fc, "Adam", backbone_lr=LR, fc_lr=LR) if stage != 2 else None
    if kind == "contrastive":
        cfg = PretrainConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, train_stage=stage,
                             alpha=ALPHA, temperature=TEMP)
        return ContrastiveEngine(cfg, model, fc, opt, ppo=ppo, dp=dp)
    cfg = RolloutConfig(arch=arch, T=T, feat_size=FEAT, num_clusters=K, train_stage=stage,
                        num_classes=2, bag_weight=0.7)
    return SupervisedEngine(cfg, model, fc, ppo=ppo, optimizer=opt, dp=dp)


def run_case(dp, case) -> dict:
    """One step of ``case`` on rank ``dp`` with its injected draws: the
    stats, the weights after the step and, at stage 2, the rank's rollouts
    (taken with the same draws before the step)."""
    device = dp.device if dp.device is not None else torch.device("cpu")
    engine = _engine(dp, case, device)
    bank = bank_from_arrays(case["feats"], case["clusters"], case["labels"]).to(device)
    draws = {k: v.to(device) if torch.is_tensor(v) else v
             for k, v in case["draws"][dp.rank].items()}
    if case.get("eval"):
        s = SimpleNamespace(engine=engine, dp=dp, device=device)
        source = ResidentSource(bank)
        eval_step = engine.eval_step
        engine.eval_step = lambda *a, **kw: eval_step(*a, **kw, **draws)
        loss, metrics = rlmil_driver._evaluate(s, source, torch.Generator())
        return {"loss": loss, "metrics": metrics}
    ids = torch.as_tensor(dp.local(np.asarray(case["ids"])), dtype=torch.int64, device=device)
    kw = {}
    if case["kind"] == "supervised":
        kw["valid"] = torch.as_tensor(dp.local(np.asarray(case["valid"])), device=device)
    out = {}
    if case["stage"] == 2:
        engine.model.eval()
        engine.fc.eval()
        with torch.no_grad():
            if case["kind"] == "contrastive":
                _, _, rollouts = engine.rollout_sequential(bank, ids, torch.Generator(), **draws)
            else:
                labels = bank.labels[ids]
                _, _, rollout = engine.rollout_sequential(bank, ids, labels, kw["valid"],
                                                          torch.Generator(), **draws)
                rollouts = (rollout,)
        out["rollouts"] = [Rollout(*(x.cpu() for x in r)) for r in rollouts]
    stats = engine.train_step(bank, ids, torch.Generator(), **kw, **draws)
    out.update({name: getattr(stats, name).detach().cpu() for name in stats._fields})
    out["model"] = _state(engine.model.encoder if case["kind"] == "contrastive" else engine.model)
    out["fc"] = _state(engine.fc)
    if engine.ppo is not None:
        out["policy"] = _state(engine.ppo.policy)
        out["policy_old"] = _state(engine.ppo.policy_old)
    return out


def run_cases(dp, cases) -> list:
    """:func:`run_case` of each case in turn (one spawn for many cases)."""
    tiny_clam()
    return [run_case(dp, case) for case in cases]


def failing(dp, rank_that_fails: int) -> int:
    """Raise a ``ValueError`` on one rank; the other waits in a collective."""
    if dp.rank == rank_that_fails:
        raise ValueError(f"rank {dp.rank} fails on purpose")
    dp.sum(torch.ones(()))
    return dp.rank


def collectives(dp) -> dict:
    """The collectives on small tensors: gather (and its gradient), sums,
    means and the flat gradient all-reduce."""
    x = torch.arange(6.0).reshape(3, 2) + 10 * dp.rank
    x.requires_grad_(True)
    g = dp.gather(x)
    (g * torch.arange(g.numel(), dtype=g.dtype).reshape(g.shape)).sum().backward()
    y = torch.full((2, 3), float(dp.rank + 1))
    s = torch.tensor(float(dp.rank + 1), requires_grad=True)
    total = dp.all_sum(s * 3.0)
    total.backward()
    p = torch.nn.Parameter(torch.zeros(4))
    p.grad = torch.full((4,), float(dp.rank + 1))
    nbytes = dp.all_reduce_grads([p])
    return {"gather": g.detach(), "gather_grad": x.grad, "along1": dp.gather(y, dim=1),
            "sum": dp.sum(torch.tensor(float(dp.rank))), "mean": dp.mean(torch.tensor(
                float(dp.rank))), "all_sum": total.detach(), "all_sum_grad": s.grad,
            "grads": p.grad, "nbytes": nbytes}


def load(run, name="model_best.pth.tar"):
    return torch.load(Path(run) / name, weights_only=True)


def check_runs(outs, files):
    """The checks every dp chain of stages 1 -> 2 -> 3 passes; its run dirs."""
    runs = [Path(out["save_dir"]) for out in outs]
    assert [r.name for r in runs] == ["stage_1", "stage_2", "stage_3"]
    assert {p.name for p in runs[0].parent.iterdir()} == {"stage_1", "stage_2", "stage_3"}
    for stage, (run, out) in enumerate(zip(runs, outs), 1):
        assert {p.name for p in run.iterdir()} == files, (stage, sorted(run.iterdir()))
        assert len(out["rank_launches"]) == 2
        with open(run / "losses.csv") as fp:
            rows = list(csv.DictReader(fp))
        assert rows and all(math.isfinite(float(r["train"])) for r in rows)
        ckpt = load(run, "checkpoint.pth.tar")
        assert (ckpt["policy"] is None) == (stage == 1)
        assert not any(k.startswith("module.") for k in ckpt["model_state_dict"])
    s1, s2 = load(runs[0]), load(runs[1])
    for k, v in s1["model_state_dict"].items():  # stage 2 trains the policy only
        assert torch.equal(v, s2["model_state_dict"][k]), k
    return runs


def update_err(after: dict, before: dict, target: dict) -> float:
    """The relative Frobenius distance between two updates of a module, all
    its weights as one vector: ``after - before`` against ``target -
    before``. One vector, because an Adam step moves a weight whose gradient
    sits near eps by a share of the rate whatever the rounding, and in a
    small tensor such weights can be all there is."""
    diff = sum(float(((after[k] - target[k]).double() ** 2).sum()) for k in before)
    ref = sum(float(((target[k] - before[k]).double() ** 2).sum()) for k in before)
    return (diff / ref) ** 0.5
