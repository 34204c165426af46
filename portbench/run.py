"""One run of one cell of the port's benchmark, on the card it is started on.

    python3 -m portbench.run --workload clam_sb-f32.pretrain_s1 --seed 7 --seconds 30 --trace 0

It makes the bank and the weights on the device from ``--seed``, builds the
port (``murcl_tpu_torch``) as the MuRCL CLI does, drives it through the
checked steps (its warm-up too: every shape of the window runs there), then
with ``--trace 0`` runs steps back to back for ``--seconds`` and reports the
cell's end-to-end metrics, and with ``--trace 1`` runs untraced steps, then
profiled ones, and reports its per-layer metrics. Once the window has
closed and the program's state is freed, the plain reference
(``portbench/reference``) follows the checked steps on the same draws and
``correct`` says whether every compared number is within its limit
(``limits/<cell>.json``). The last line of standard output is the result,
one JSON object; the compared numbers and their limits end standard error.

It fails, printing no result, without a CUDA card or with fewer than the
cell asks for, and when the process has loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from types import SimpleNamespace  # noqa: E402
from typing import Callable, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "murcl_tpu")
GIB = 2 ** 30
# steps of a traced run before the profiler, and under it
UNTRACED, PROFILED = 12, 3


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card(chips: int):
    """The card, or SystemExit when there are too few."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise SystemExit(f"portbench: this cell needs {chips} CUDA card(s); found {n}")
    return torch.device("cuda", 0)


def spans(prog):
    """The benchmark's spans in a traced run: the aggregator's forward."""
    from portbench.trace import Spans

    s = Spans()
    s.add(prog.model.encoder, "portbench.aggregator")
    return s


def per_layer(plan, tr, agg_params: int) -> tuple:
    """The per-layer metrics of a traced run, the ``device`` fields and the
    breakdown. Each reader's ``read(run)`` gets ``run`` with ``cfg`` and
    ``traffic`` (the cell's files), ``host`` and ``device`` (the profiler's
    events), ``window_us`` (the profiled window, the profiler's clock),
    ``busy_us`` (the union of device events in it), ``steps`` (profiled),
    ``step_s`` (the untraced steps' mean), ``enqueue_ms`` (each untraced
    call's host time), ``agg_params`` (the aggregator's parameter count) and
    ``caused_by(label)`` (the device events a span caused)."""
    from portbench import trace

    host = trace.host_events(tr.prof)
    dev = trace.device_events(tr.prof)
    lo, hi = trace.within(host, "portbench.window")
    busy = trace.merged(trace.clipped(dev, lo, hi))
    run = SimpleNamespace(cfg=plan.config, traffic=plan.traffic, host=host, device=dev,
                          window_us=(lo, hi), busy_us=sum(b - a for a, b in busy),
                          steps=tr.profiled, step_s=tr.step_s, enqueue_ms=tr.enqueue_ms,
                          agg_params=agg_params,
                          caused_by=lambda label: trace.caused_by(host, dev, label))
    metrics = {}
    for m in plan.per_layer:
        value = plan.readers[m["name"]].read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    table = trace.op_table([e for e in dev if e.time_range.end > lo and e.time_range.start < hi],
                           tr.profiled, top=10)
    breakdown = {"device_ops": [[r["op"], r["sum_ms"] / 1e3] for r in table],
                 "idle_gaps": trace.idle_gaps(host, dev, lo, hi)}
    return metrics, {"busy_s": run.busy_us / 1e6, "window_s": (hi - lo) / 1e6}, breakdown


def run_cell(args, device=None, fault: Optional[Callable] = None, root=None) -> dict:
    """One run; returns the result's fields. ``device`` None takes the card
    (the CLI); tests pass the CPU, ``fault`` (applied to the built program)
    and a ``root`` holding another manifest."""
    import torch

    from portbench import check, inputs, program, spec
    from portbench.reference.model import Reference
    from portbench.reference.step import run_steps

    phases = {"imports": time.perf_counter() - T_START}

    def phase(name):
        if cuda:
            torch.cuda.synchronize(device)
        phases[name] = time.perf_counter() - T_START - sum(phases.values())

    kw = {} if root is None else {"root": root, "here": root / "portbench"}
    plan = spec.plan(args.workload, **kw)
    cfg, traffic = plan.config, plan.traffic
    if device is None:
        device = card(plan.chips)
    cuda = device.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.empty(0, device=device)
    phase("card")

    bank = inputs.make_bank(traffic, cfg["dim_in"], args.seed, device)
    weights = inputs.make_weights(cfg, traffic, args.seed, device)
    phase("bank and weights")
    prog = program.build(cfg, traffic, weights, bank, device)
    if fault is not None:
        fault(prog)
    batches = inputs.id_batches(traffic, args.seed)
    steps = [inputs.checked_draws(cfg, traffic, args.seed, k, next(batches))
             for k in range(traffic["checked_steps"])]
    phase("program")
    ran = program.checked_steps(prog, steps, cfg["beta1"])
    phase("checked steps")
    gen = inputs.window_generator(args.seed)
    setup_s = time.perf_counter() - T_START
    print("setup: " + ", ".join(f"{k} {v:.2f} s" for k, v in phases.items()), file=sys.stderr)
    agg_params = sum(v.numel() for v in weights["model"].values())

    out = {"attempted": 0, "failed": 0, "metrics": {}}
    if args.trace:
        tr = program.traced(prog, batches, gen, UNTRACED, PROFILED, spans)
        out["attempted"] = UNTRACED + PROFILED
        out["metrics"], dev_extra, out["breakdown"] = per_layer(plan, tr, agg_params)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del tr
    else:
        win = program.window(prog, batches, gen, args.seconds)
        n, b = len(win.end_ms), traffic["batch"]
        gaps = [win.end_ms[0]] + [y - x for x, y in zip(win.end_ms, win.end_ms[1:])]
        e2e = {"slides_per_s": b * n / (win.end_ms[-1] / 1e3),
               "step_ms_p95": statistics.quantiles(gaps, n=20)[-1] if n > 1 else gaps[0],
               "peak_mem_gib": win.peak_bytes / GIB, "setup_s": setup_s}
        units = {m["name"]: m["unit"] for m in plan.end_to_end}
        out["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in e2e.items() if k in units}
        out["attempted"], out["failed"] = n, win.failed
        slowest = sorted(range(n), key=lambda i: -gaps[i])[:5]
        out["window"] = {"steps": n, "window_ms": win.end_ms[-1], "host_s": win.host_s,
                         "median_step_ms": statistics.median(gaps),
                         "slowest_steps_ms": [[i, gaps[i]] for i in slowest]}
        peak, dev_extra = win.peak_bytes, {}
    out["device"] = {"platform": "gpu" if cuda else "cpu",
                     "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                     "count": plan.chips, "memory_peak_bytes": int(peak), **dev_extra}

    program.release(prog)
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    params0 = {k: v for g in ("model", "fc") for k, v in weights[g].items()}
    t_ref = time.perf_counter()
    ref = run_steps(Reference(cfg), weights, bank, steps, traffic, cfg,
                    followed_means=ran.means)
    print(f"reference: {time.perf_counter() - t_ref:.2f} s", file=sys.stderr)
    numbers = check.readings(ran, ref, params0, ref.loss_grad1)
    out["correct"] = check.verdict(numbers, plan.limits)
    out["numbers"] = numbers
    out["checks"] = check.report(numbers, plan.limits)
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run_cell(args)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process loaded {found}; the port's benchmark may load none "
              f"of {list(FORBIDDEN)}", file=sys.stderr)
        return 3
    result = {k: out[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in out:
        result["breakdown"] = out["breakdown"]
    result["window"] = out.get("window")
    result["checks"] = out["checks"]
    from portbench import check

    print(check.lines(out["numbers"], {k: v["limit"] for k, v in out["checks"].items()}),
          file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
