"""Profile helpers of the step scripts (``profile_step``, ``profile_stages``)
and of ``chip_smoke.py``: a step's ops from a ``torch.profiler`` trace.

The JAX package's ``scripts/profile_step.py`` and ``profile_stages.py``
(``:114-133``) sum the complete events of the device lanes of a trace by op
name and print the top ones as ``ms/step  calls  op``. :func:`op_table` does
that with a ``torch.profiler`` run's events, and keeps beside each sum the
union of that op's intervals: on a card that runs copies and kernels side by
side, or in streams, the two differ. On the CPU ``torch.profiler`` records
host ops only; there the table holds the host times of the kernels' plain
twins, and its header says so.

This module imports ``torch`` alone, so that ``chip_smoke.py`` can load it
from its file in a process that imports another tree's port.
"""

from __future__ import annotations

import collections
from typing import Iterable, List, Sequence, Tuple

import torch

NAME_WIDTH = 100  # the JAX scripts cut op names at 100 characters


def device_events(prof) -> list:
    """The card's events of a ``torch.profiler`` run (kernels, copies,
    memsets), without the device-side spans of ``record_function``."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def host_events(prof) -> list:
    """The host's op events of a run (aten ops, ``record_function`` spans,
    runtime calls), nested ones included."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]


def table_events(prof) -> Tuple[list, bool]:
    """``(events, on_device)``: the card's events where the run recorded
    any, else the host's (a CPU run)."""
    dev = device_events(prof)
    return (dev, True) if dev else (host_events(prof), False)


def _spans(events: Iterable) -> List[Tuple[float, float]]:
    return [(e.time_range.start, e.time_range.end) for e in events]


def busy_union_ms(events) -> float:
    """The union of the events' intervals, ms (the profiler's times are us)."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(_spans(events)):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


def op_table(prof, steps: int, top: int = 0) -> List[dict]:
    """Per op name, by summed time (the JAX scripts' order), the first
    ``top`` rows (all where 0): ``{"op", "ms", "calls", "sum_ms",
    "union_ms"}``, ``ms`` the summed ms per step, ``calls`` the launches per
    step (the count over ``steps``, floored as the JAX scripts floor it),
    ``sum_ms`` the summed ms over the run and ``union_ms`` the union of that
    op's intervals over the run. ``prof`` is a ``torch.profiler`` run
    (:func:`table_events` picks its events) or a list of events with
    ``name`` and ``time_range``."""
    events = table_events(prof)[0] if hasattr(prof, "events") else list(prof)
    by_name = collections.defaultdict(list)
    for e in events:
        by_name[e.name].append(e)
    rows = [{"op": name, "sum_ms": sum(b - a for a, b in _spans(evs)) / 1e3,
             "union_ms": busy_union_ms(evs), "calls": len(evs) // steps}
            for name, evs in by_name.items()]
    for r in rows:
        r["ms"] = r["sum_ms"] / steps
    rows.sort(key=lambda r: -r["sum_ms"])
    return rows[:top] if top else rows


def print_table(rows: Sequence[dict], on_device: bool = True, top: int = 35) -> None:
    """The JAX scripts' table, ``ms/step  calls  op``, of the first ``top``
    rows, names cut at 100 characters."""
    if not on_device:
        print("(CPU: torch.profiler records host ops only; these are host times of the "
              "plain twins, nested ops each in their own row)")
    print(f"{'ms/step':>9}  {'calls':>6}  op")
    for r in rows[:top]:
        print(f"{r['ms']:9.2f}  {r['calls']:6d}  {r['op'][:NAME_WIDTH]}")


def range_events(prof, label: str) -> list:
    """The card's events launched inside the host spans of
    ``record_function(label)``: those whose correlation id is a runtime
    call (``cuda*``, ``cu*``) that starts inside such a span."""
    host = host_events(prof)
    spans = _spans(e for e in host if e.name == label)
    ids = {e.id for e in host if e.name.startswith("cu")
           and any(a <= e.time_range.start <= b for a, b in spans)}
    return [e for e in device_events(prof) if e.id in ids]


def trace(step, n: int, device: torch.device):
    """``torch.profiler`` over ``n`` calls of ``step``, the card's activity
    too where ``device`` is one, synchronised inside the window."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        for _ in range(n):
            step()
        if cuda:
            torch.cuda.synchronize(device)
    return prof


def profile_steps(step, what: str, step_ms: float, n: int = 3) -> float:
    """Device time by kernel over ``n`` traced steps, and the union of the
    kernel intervals per step against the untraced step time ``step_ms``;
    returns that union, ms per step."""
    prof = trace(step, n, torch.device("cuda", torch.cuda.current_device()))
    kernels = device_events(prof)
    busy_ms = busy_union_ms(kernels) / n
    print(f"profile {what}: device busy {busy_ms:.2f} ms per step, "
          f"{100 * busy_ms / step_ms:.2f}% of the untraced {step_ms:.2f} ms step; "
          f"device ms per step by kernel ({len(kernels) / n:.0f} launches per step):")
    for r in op_table(kernels, n, top=12):
        print(f"  {r['ms']:9.3f}  {r['op'][:110]}")
    return busy_ms
