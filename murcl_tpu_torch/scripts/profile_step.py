"""Profile the stage-1 pretraining step and print the top ops by device time.
(Counterpart of ``scripts/profile_step.py``.)

At the JAX script's shape, the ``bench.py`` step: CLAM_SB (gated, dropout
0.25, k_sample 8, subtyping, 128 classes) and the GRU head (hidden 1024, 128
classes) over a bank of 64 slides x 2048 patches x 512, batch 128, feat_size
1024, T 6, K 10, stage 1, bf16, Adam at 1e-4. The bank is the JAX script's
(``np.random.default_rng(0)``: normal features, uniform cluster labels, in
bf16), the weights are drawn after ``torch.manual_seed(0)``, and each step
draws from a CPU ``torch.Generator`` seeded as the JAX script seeds its key:
0 for the warm-up, then 1, 2, ...

One warm-up step (it builds the kernels), the untraced step time (the
median of 3 steps, each synchronised), then ``--steps`` steps under
``torch.profiler`` with a synchronisation inside the window; the trace goes
to ``--out`` (Chrome's trace format) and the table of the top 35 ops by
summed device time per step is printed, with the union of the device's
intervals (its busy time) beside the untraced step time, and on the card
the host's copies and synchronisations per step. ``--device cpu``
runs the plain twins at the ``--shape`` given, and the table holds host
times. The JAX script's ``--layout sequential`` selects a TPU-only stage-1
layout that the port does not have (``murcl_tpu_torch/train_MuRCL.py``'s
TPU-only flags); the port's one layout is the batched one.

    python -m murcl_tpu_torch.scripts.profile_step              # cuda:0
    python -m murcl_tpu_torch.scripts.profile_step --device cpu --shape 4 96 32 64 8 2
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.models import CL, PPO, FullLayer, build_aggregator
from murcl_tpu_torch.scripts.dbg_select import K, select_bank
from murcl_tpu_torch.scripts.probes import probe_device, where
from murcl_tpu_torch.scripts.profiling import (busy_union_ms, host_events, op_table,
                                               print_table, table_events, trace)

SHAPE = (64, 2048, 512, 1024, 128, 6)  # slides, patches, D, feat_size, batch, T
CLASSES, HIDDEN = 128, 1024  # the projection's classes, the GRU head's hidden width
TOP = 35
# the host's runtime calls that copy or wait for the card (ROADMAP's measured
# gap A), counted per traced step; the trace's own cudaDeviceSynchronize is
# not among them
HOST_CALLS = ("cudaMemcpyAsync", "cudaStreamSynchronize")
OUT = Path(__file__).resolve().parents[2] / "build" / "profile"


def build_step(dev, shape=SHAPE, stage: int = 1, dtype: str = "bfloat16"):
    """The JAX scripts' ``build_step`` (``scripts/profile_step.py:30-67``,
    ``profile_stages.py:35-79``, ``dbg_step.py:22-55``) on ``dev``:
    ``SimpleNamespace(engine, bank, ids, step)``; ``step(seed)`` runs one
    ``train_step`` on a CPU generator seeded ``seed`` and returns its stats.
    Stages 2 and 3 add the policy, ``PPO(hidden 1024, lr 1e-5, gamma 0.1,
    K_epochs 3)``; stage 2 has no optimizer."""
    slides, patches, d, feat, batch, t_steps = shape
    bank = select_bank(slides, patches, d, dev, labels=[i % 2 for i in range(slides)])
    torch.manual_seed(0)
    encoder, feature_num = build_aggregator(
        "CLAM_SB", dim_in=d, num_classes=CLASSES,
        arch_setting={"gate": True, "dropout": 0.25, "k_sample": 8, "subtyping": True})
    model = CL(encoder, projection_dim=CLASSES).to(dev)
    fc = FullLayer(feature_num=feature_num, hidden_state_dim=HIDDEN, class_num=CLASSES).to(dev)
    ppo = None
    if stage != 1:
        ppo = PPO(state_dim=feature_num, hidden_state_dim=1024, action_size=K, lr=1e-5,
                  gamma=0.1, K_epochs=3).to(dev)
    opt = None
    if stage != 2:
        opt = torch.optim.Adam([*model.parameters(), *fc.parameters()], lr=1e-4)
    cfg = PretrainConfig(arch="CLAM_SB", T=t_steps, feat_size=feat, num_clusters=K,
                         train_stage=stage, compute_dtype=dtype)
    engine = ContrastiveEngine(cfg, model, fc, optimizer=opt, ppo=ppo)
    ids = torch.arange(batch, device=dev) % slides

    def step(seed: int):
        return engine.train_step(bank, ids, torch.Generator().manual_seed(seed))

    return SimpleNamespace(engine=engine, bank=bank, ids=ids, step=step, ppo=ppo)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def synced_step_ms(step, dev, seeds) -> float:
    """The median ms of one step per seed, each between two synchronisations
    (the host's clock)."""
    times = []
    for seed in seeds:
        sync(dev)
        t0 = time.perf_counter()
        step(seed)
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_run(s, dev, steps: int, out, what: str, annotate=None) -> dict:
    """Warm-up, the untraced step time, ``steps`` traced steps, the trace to
    ``out`` and the table: what ``profile_step`` and ``profile_stages``
    share. ``annotate`` runs before the traced steps (a span to mark)."""
    stats = s.step(0)
    losses = [float(stats.loss)]
    print(f"warmup loss {losses[0]:.4f}", file=sys.stderr)
    step_ms = synced_step_ms(s.step, dev, range(1, 4))
    if annotate is not None:
        annotate()
    seeds = iter(range(1, steps + 1))
    last = {}

    def traced():
        last["stats"] = s.step(next(seeds))

    prof = trace(traced, steps, dev)
    losses.append(float(last["stats"].loss))
    print(f"traced {steps} {what}, loss {losses[-1]:.4f}", file=sys.stderr)
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out))
    events, on_device = table_events(prof)
    rows = op_table(events, steps)
    grand = sum(r["sum_ms"] for r in rows)
    busy = busy_union_ms(events) / steps
    side = "device" if on_device else "host"
    print(f"trace: {out}")
    print(f"{what} ({where(dev)}): total {side} event time over {steps} steps: {grand:.1f} ms "
          f"({grand / steps:.1f} ms/step); {side} busy {busy:.2f} ms per step, "
          f"{100 * busy / step_ms:.2f}% of the untraced {step_ms:.2f} ms step\n")
    print_table(rows, on_device, TOP)
    names = [e.name for e in host_events(prof)]
    host = {k: names.count(k) / steps for k in HOST_CALLS}
    if on_device:
        print("host runtime calls per step: " + ", ".join(f"{k} {v:.0f}" for k, v in host.items()))
    return {"step_ms": step_ms, "busy_ms": busy, "rows": rows, "on_device": on_device,
            "losses": losses, "host_calls": host, "prof": prof,
            "trace": str(out) if out else None}


def run(device="cuda:0", shape=SHAPE, steps: int = 3, out=OUT / "profile_step.trace.json"
        ) -> dict:
    """Prints the table and returns ``{"step_ms", "busy_ms", "rows",
    "on_device", "losses", "host_calls", "prof", "trace"}``: the untraced
    step ms, the union of the traced events per step,
    :func:`~murcl_tpu_torch.scripts.profiling.op_table`'s rows, whether they
    are the card's, the warm-up's and the last traced step's losses, the
    host's copies and synchronisations per step (``HOST_CALLS``), the
    profiler run and the trace's path."""
    dev = probe_device(device)
    s = build_step(dev, shape, stage=1)
    print(f"profile of the stage-1 step, CLAM_SB bf16, batch {shape[4]} of {shape[0]} slides x "
          f"{shape[1]} patches x {shape[2]}, feat_size {shape[3]}, T {shape[5]} ({where(dev)})",
          flush=True)
    return profile_run(s, dev, steps, out, "stage-1 steps")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=6, default=list(SHAPE),
                    metavar=("SLIDES", "PATCHES", "D", "FEAT", "BATCH", "T"))
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--out", default=str(OUT / "profile_step.trace.json"),
                    help="the trace's path (Chrome's trace format)")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.steps, a.out)
