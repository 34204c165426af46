"""The system under test, ``murcl_tpu_torch``, as the MuRCL CLI builds it
(``drivers/murcl.py`` ``setup``): the aggregator in its contrastive
wrapper, the GRU head, stage 3's PPO policy, Adam over the aggregator and
the head in the CLI's two groups, and the ``ContrastiveEngine`` whose
``train_step`` every step of a run goes through. Only this module and the
metric readers' spans touch the program.
"""

from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Callable, List

import numpy as np
import torch

from murcl_tpu_torch.data.bank import FeatureBank
from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.engine.optim import make_optimizer
from murcl_tpu_torch.models import CL, PPO, FullLayer, build_aggregator


def arch_setting(cfg: dict) -> dict:
    """``drivers/murcl.py`` ``_arch_setting`` from the configuration."""
    if cfg["arch"] == "ABMIL":
        return {"L": cfg["L"], "D": cfg["D"], "dropout": cfg["dropout"],
                "dim_out": cfg["projection_dim"]}
    return {"gate": cfg["gate"], "size_arg": cfg["size_arg"], "dropout": cfg["dropout"],
            "k_sample": cfg["k_sample"], "subtyping": cfg["subtyping"]}


def feature_bank(bank, num_clusters: int) -> FeatureBank:
    """The program's bank over the benchmark's tensors (no copy)."""
    s = len(bank.num_patches)
    return FeatureBank(feats=bank.feats, offsets=bank.offsets, num_patches=bank.num_patches,
                       cluster_sizes=bank.cluster_sizes, patch_cluster=bank.patch_cluster,
                       patch_pos=bank.patch_pos,
                       labels=torch.zeros(s, dtype=torch.int64, device=bank.feats.device),
                       case_ids=[f"slide_{i}" for i in range(s)], num_clusters=num_clusters,
                       max_patches=int(bank.patch_pos.shape[1]))


def build(cfg: dict, traffic: dict, weights: dict, bank, device) -> SimpleNamespace:
    """The program's objects on ``device`` with the benchmark's weights."""
    stage = traffic["stage"]
    with torch.device(device):
        encoder, feature_num = build_aggregator(cfg["arch"], dim_in=cfg["dim_in"],
                                                num_classes=cfg["projection_dim"],
                                                arch_setting=arch_setting(cfg))
        model = CL(encoder, projection_dim=cfg["projection_dim"])
        fc = FullLayer(feature_num=feature_num, hidden_state_dim=cfg["fc_hidden_dim"],
                       fc_rnn=True, class_num=cfg["projection_dim"])
        ppo = None
        if stage != 1:
            ppo = PPO(state_dim=feature_num, hidden_state_dim=cfg["policy_hidden_dim"],
                      policy_conv=False, action_std=cfg["action_std"], lr=cfg["ppo_lr"],
                      gamma=cfg["ppo_gamma"], K_epochs=cfg["K_epochs"],
                      action_size=traffic["num_clusters"])
    model.load_state_dict(weights["model"])
    fc.load_state_dict(weights["fc"])
    if ppo is not None:
        ppo.load_policy(weights["policy"])
    optimizer = None
    if stage != 2:
        optimizer = make_optimizer(model, fc, optimizer="Adam", backbone_lr=traffic["backbone_lr"],
                                   fc_lr=traffic["fc_lr"], beta1=cfg["beta1"],
                                   beta2=cfg["beta2"], wdecay=cfg["wdecay"])
    pcfg = PretrainConfig(arch=cfg["arch"], T=traffic["T"], feat_size=traffic["feat_size"],
                          num_clusters=traffic["num_clusters"], train_stage=stage,
                          num_classes=cfg["projection_dim"], alpha=traffic["alpha"],
                          temperature=traffic["temperature"],
                          compute_dtype=cfg["compute_dtype"])
    engine = ContrastiveEngine(pcfg, model, fc, optimizer, ppo=ppo)
    return SimpleNamespace(engine=engine, model=model, fc=fc, ppo=ppo, optimizer=optimizer,
                           bank=feature_bank(bank, traffic["num_clusters"]), device=device)


def named_params(prog) -> dict:
    return {**{k: p for k, p in prog.model.named_parameters()},
            **{k: p for k, p in prog.fc.named_parameters()}}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def ids_on(prog, ids: np.ndarray) -> torch.Tensor:
    """A step's slide ids on the device, as the drivers' resident source
    hands them over."""
    return torch.as_tensor(np.asarray(ids), device=prog.bank.feats.device)


def checked_steps(prog, steps: List, beta1: float) -> SimpleNamespace:
    """The first steps of the run through ``train_step`` with the draws
    handed in: ``losses``, ``grad1`` (the first gradient as Adam's first
    moment holds it after step 1, by leaf; None where Adam kept no state),
    ``params`` (after the last), ``means`` (stage 3: the policy's mean
    actions, ``(T-1, 2, B, K)`` a step)."""
    named = named_params(prog)
    captured: list = []
    hook = None
    if prog.ppo is not None:
        hook = prog.ppo.policy_old.register_forward_hook(
            lambda _m, _a, out: captured.append(out[0].detach().clone()))
    losses, grad1, means = [], None, []
    try:
        for k, d in enumerate(steps):
            gen = torch.Generator().manual_seed(d.gen_seed)
            stats = prog.engine.train_step(prog.bank, ids_on(prog, d.ids.numpy()), gen,
                                           **d.program)
            losses.append(stats.loss)
            if k == 0:
                state = prog.optimizer.state
                if all("exp_avg" in state.get(p, {}) for p in named.values()):
                    grad1 = {n: state[p]["exp_avg"] / (1.0 - beta1) for n, p in named.items()}
            if captured:
                t1, b = len(captured) // 2, captured[0].shape[0]
                means.append(torch.stack(captured).reshape(t1, 2, b, -1))
                captured.clear()
    finally:
        if hook is not None:
            hook.remove()
    params = {n: p.detach().clone() for n, p in named.items()}
    _sync(prog.device)
    return SimpleNamespace(losses=[float(v) for v in losses], grad1=grad1, params=params,
                           means=means or None)


def window(prog, batches, generator, seconds: float) -> SimpleNamespace:
    """Steps back to back for ``seconds`` of the host's clock, each ended by
    an event on the step's stream; read after the window: each step's end
    from the window's start (ms), the host's time, the peak memory, and the
    losses' finiteness."""
    cuda = torch.device(prog.device).type == "cuda"
    _sync(prog.device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(prog.device)
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    ends, losses = [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        stats = prog.engine.train_step(prog.bank, ids_on(prog, next(batches)), generator)
        losses.append(stats.loss)
        if cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ends.append(ev)
        else:
            ends.append(time.perf_counter())
    _sync(prog.device)
    host_s = time.perf_counter() - t0
    if cuda:
        end_ms = [start.elapsed_time(e) for e in ends]
        peak = torch.cuda.max_memory_allocated(prog.device)
    else:
        end_ms = [(t - t0) * 1e3 for t in ends]
        peak = 0
    bad = sum(1 for v in torch.stack(losses).cpu().tolist() if not np.isfinite(v))
    return SimpleNamespace(end_ms=end_ms, host_s=host_s, peak_bytes=peak, failed=bad)


def traced(prog, batches, generator, untraced: int, profiled: int,
           spans: Callable[[object], object]) -> SimpleNamespace:
    """The traced run's steps: ``untraced`` steps back to back (each call's
    host time, and their mean step time by the host's clock with one
    synchronisation after them), then ``profiled`` steps under
    ``torch.profiler`` inside a ``portbench.window`` span, with the
    benchmark's spans (``spans(prog)`` installs them and returns an object
    with ``close()``)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(prog.device).type == "cuda"
    _sync(prog.device)
    enqueue = []
    t0 = time.perf_counter()
    for _ in range(untraced):
        ids = ids_on(prog, next(batches))
        t = time.perf_counter()
        prog.engine.train_step(prog.bank, ids, generator)
        enqueue.append((time.perf_counter() - t) * 1e3)
    _sync(prog.device)
    step_s = (time.perf_counter() - t0) / untraced
    hooks = spans(prog)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    try:
        with profile(activities=activities) as prof:
            w0 = time.perf_counter()
            with torch.autograd.profiler.record_function("portbench.window"):
                for _ in range(profiled):
                    prog.engine.train_step(prog.bank, ids_on(prog, next(batches)), generator)
                _sync(prog.device)
            window_s = time.perf_counter() - w0
    finally:
        hooks.close()
    return SimpleNamespace(prof=prof, enqueue_ms=enqueue, step_s=step_s, window_s=window_s,
                           profiled=profiled)


def release(prog) -> None:
    """Drop the program's state (modules, optimizer, engine)."""
    for k in ("engine", "model", "fc", "ppo", "optimizer", "bank"):
        setattr(prog, k, None)

