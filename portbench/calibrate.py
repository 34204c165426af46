"""The readings a cell's limits are set from, in one process on the card:

- ``program``: the port's checked steps against the reference, a dozen
  seeds or more (the lower readings);
- ``control``: the reference in TF32 (both operands of every product
  rounded to 10 mantissa bits) put in the program's place, following its
  own policy, against the float32 reference (the upper readings);
- faults planted in the program: ``half_batch`` (NT-Xent over half of the
  batch, the mean taken over the rest), ``frozen`` (the optimizer's step
  left out: the state returns unchanged), and in stage 3 ``act_shift``
  (each mean action the policy produces moved by 0.01).

    python3 -m portbench.calibrate --workload clam_sb-f32.pretrain_s1 \
        --seeds 11 12 13 --control 21 22 23 --faults 31 32 33 --out calib.json

Each reading is written to ``--out`` (JSON) as it comes, and printed.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

import torch

from portbench import check, inputs, program, spec
from portbench.reference.model import Reference
from portbench.reference.step import run_steps


def half_batch(prog) -> None:
    engine = prog.engine
    whole = engine._nt_xent

    def half(a, b):
        h = a.shape[0] // 2
        return whole(a[:h], b[:h])

    engine._nt_xent = half


def frozen(prog) -> None:
    prog.optimizer.step = lambda *a, **k: None


def act_shift(prog) -> None:
    prog.ppo.policy_old.register_forward_hook(
        lambda _m, _a, out: (out[0] + 0.01, *out[1:]))


FAULTS = {"half_batch": half_batch, "frozen": frozen, "act_shift": act_shift}


def program_reading(plan, seed: int, device, fault=None) -> dict:
    """The port's checked steps at ``seed`` (``fault`` planted) against the
    reference."""
    cfg, traffic = plan.config, plan.traffic
    bank = inputs.make_bank(traffic, cfg["dim_in"], seed, device)
    weights = inputs.make_weights(cfg, traffic, seed, device)
    prog = program.build(cfg, traffic, weights, bank, device)
    if fault is not None:
        fault(prog)
    batches = inputs.id_batches(traffic, seed)
    steps = [inputs.checked_draws(cfg, traffic, seed, k, next(batches))
             for k in range(traffic["checked_steps"])]
    ran = program.checked_steps(prog, steps, cfg["beta1"])
    program.release(prog)
    del prog
    return _against_reference(plan, ran, weights, bank, steps, device)


def control_reading(plan, seed: int, device) -> dict:
    """The TF32 reference in the program's place at ``seed``."""
    cfg, traffic = plan.config, plan.traffic
    bank = inputs.make_bank(traffic, cfg["dim_in"], seed, device)
    weights = inputs.make_weights(cfg, traffic, seed, device)
    batches = inputs.id_batches(traffic, seed)
    steps = [inputs.checked_draws(cfg, traffic, seed, k, next(batches))
             for k in range(traffic["checked_steps"])]
    ran = run_steps(Reference(cfg, tf32=True), weights, bank, steps, traffic, cfg)
    if traffic["stage"] == 1:
        ran.means = None
    return _against_reference(plan, ran, weights, bank, steps, device)


def _against_reference(plan, ran, weights, bank, steps, device) -> dict:
    cfg, traffic = plan.config, plan.traffic
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    params0 = {k: v for g in ("model", "fc") for k, v in weights[g].items()}
    t0 = time.perf_counter()
    ref = run_steps(Reference(cfg), weights, bank, steps, traffic, cfg, followed_means=ran.means)
    numbers = check.readings(ran, ref, params0, ref.loss_grad1)
    numbers["reference_s"] = time.perf_counter() - t0
    numbers.update(check.worst_leaves(ran, ref, params0, ref.loss_grad1))
    return numbers


def witness_reading(plan, seed: int, device) -> dict:
    """A second witness at ``seed``: the port's checked steps and the float32
    reference, each against the reference in float64 (the same bank and
    weights, widened)."""
    cfg, traffic = plan.config, plan.traffic
    bank = inputs.make_bank(traffic, cfg["dim_in"], seed, device)
    weights = inputs.make_weights(cfg, traffic, seed, device)
    prog = program.build(cfg, traffic, weights, bank, device)
    batches = inputs.id_batches(traffic, seed)
    steps = [inputs.checked_draws(cfg, traffic, seed, k, next(batches))
             for k in range(traffic["checked_steps"])]
    ran = program.checked_steps(prog, steps, cfg["beta1"])
    program.release(prog)
    del prog
    gc.collect()
    params0 = {k: v for g in ("model", "fc") for k, v in weights[g].items()}
    ref32 = run_steps(Reference(cfg), weights, bank, steps, traffic, cfg, followed_means=ran.means)
    wide = {g: {k: v.double() for k, v in ws.items()} for g, ws in weights.items()}
    bank64 = type(bank)(**{**vars(bank), "feats": bank.feats.double()})
    ref64 = run_steps(Reference(cfg), wide, bank64, steps, traffic, cfg,
                      followed_means=None if ran.means is None else
                      [m.double() for m in ran.means])
    w0 = {k: v.double() for k, v in params0.items()}
    for r in (ran, ref32):
        r.params = {k: v.double() for k, v in r.params.items()}
        if r.grad1 is not None:
            r.grad1 = {k: v.double() for k, v in r.grad1.items()}
    out = {}
    for name, r in (("program", ran), ("reference32", ref32)):
        out[name] = check.readings(r, ref64, w0, ref64.loss_grad1)
        out[name].update(check.worst_leaves(r, ref64, w0, ref64.loss_grad1))
    out["program_vs_reference32"] = check.readings(ran, ref32, params0, ref32.loss_grad1)
    out["program_vs_reference32"].update(check.worst_leaves(ran, ref32, params0,
                                                            ref32.loss_grad1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--faults", type=int, nargs="*", default=[])
    ap.add_argument("--witness", type=int, nargs="*", default=[],
                    help="seeds read against a float64 reference as well")
    ap.add_argument("--out", required=True)
    a = ap.parse_args(argv)
    plan = spec.plan(a.workload)
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = bool(plan.config["tf32"])
    out = {"workload": a.workload, "program": {}, "control": {}, "faults": {}, "witness": {}}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    path = Path(a.out)
    path.parent.mkdir(parents=True, exist_ok=True)

    def keep(kind, key, numbers):
        out[kind][str(key)] = numbers
        print(kind, key, json.dumps(numbers), file=sys.stderr, flush=True)
        path.write_text(json.dumps(out, indent=1))

    for seed in a.witness:
        keep("witness", seed, witness_reading(plan, seed, device))
    for seed in a.seeds:
        keep("program", seed, program_reading(plan, seed, device))
    for seed in a.control:
        keep("control", seed, control_reading(plan, seed, device))
    names = ["half_batch", "frozen"] + (["act_shift"] if plan.traffic["stage"] == 3 else [])
    for name in names:
        for seed in a.faults:
            keep("faults", f"{name}.{seed}", program_reading(plan, seed, device, FAULTS[name]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
