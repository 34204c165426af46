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

The program opens ``murcl.*`` spans inside its steps
(``murcl_tpu_torch/utils/trace.py``). :func:`span_table` charges each of the
card's events to the innermost program span that caused it (launched inside
it, or by an autograd node made inside it, found by the node's sequence
number), :func:`idle_table` charges each gap in the card's work to the
innermost program span open when it began, and :func:`print_waits` prints
the program's count of host waits by span and site.

This module imports ``torch`` alone, so that ``chip_smoke.py`` can load it
from its file in a process that imports another tree's port.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

NAME_WIDTH = 100  # the JAX scripts cut op names at 100 characters
PREFIX = "murcl."  # the program's spans
NO_SPAN = "(no span)"
BWD_PREFIX = "autograd::engine::evaluate_function"


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


class _Innermost:
    """Labelled intervals of one thread, properly nested; :meth:`at` gives
    the label of the innermost one that holds a point."""

    def __init__(self, spans: Sequence[Tuple[float, float, str]]):
        # of two that start together, the outer first
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [a for a, _, _ in self.spans]

    def at(self, t: float) -> Optional[str]:
        for i in range(bisect.bisect_right(self.starts, t) - 1, -1, -1):
            a, b, label = self.spans[i]
            if b >= t:
                return label
        return None


def _by_thread(spans) -> Dict[int, _Innermost]:
    out = collections.defaultdict(list)
    for thread, a, b, label in spans:
        out[thread].append((a, b, label))
    return {k: _Innermost(v) for k, v in out.items()}


def program_spans(host: Sequence, prefix: str = PREFIX) -> list:
    """The host's program spans (``record_function`` names under ``prefix``)."""
    return [e for e in host if e.name.startswith(prefix)]


def span_labels(host: Sequence, device: Sequence, prefix: str = PREFIX) -> Dict[int, str]:
    """``id(device event) -> `` the innermost program span that caused it:
    the one open on the launching thread when the launch began, or, for a
    launch inside a backward node's ``evaluate_function``, the one open
    when the forward op that made that node began (by thread and sequence
    number). Events of neither kind are left out."""
    fwd = _by_thread((e.thread, e.time_range.start, e.time_range.end, e.name)
                     for e in program_spans(host, prefix))
    made = {}
    for e in host:
        seq = getattr(e, "sequence_nr", -1)
        if seq >= 0 and not e.name.startswith(BWD_PREFIX) and e.thread in fwd:
            label = fwd[e.thread].at(e.time_range.start)
            if label is not None:
                made[(e.thread, seq)] = label
    bwd = _by_thread((e.thread, e.time_range.start, e.time_range.end,
                      made[(e.fwd_thread, e.sequence_nr)]) for e in host
                     if e.name.startswith(BWD_PREFIX) and (e.fwd_thread, e.sequence_nr) in made)
    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    ops = {e.id: e for e in host if not e.name.startswith("cu")}
    out = {}
    for d in device:
        src = runtime.get(d.id) or ops.get(getattr(d, "linked_correlation_id", 0) or -1)
        if src is None:
            continue
        t = src.time_range.start
        label = bwd[src.thread].at(t) if src.thread in bwd else None
        if label is None and src.thread in fwd:
            label = fwd[src.thread].at(t)
        if label is not None:
            out[id(d)] = label
    return out


def span_table(prof, steps: int, prefix: str = PREFIX) -> List[list]:
    """``[[span, ms a step], ...]``, largest first: the card's event time of
    a run by the innermost program span that caused each event
    (:func:`span_labels`), ``(no span)`` for the rest; on the CPU, where the
    run has no device events, the host time inside each program span
    (nested spans counted in each)."""
    dev = device_events(prof)
    host = host_events(prof)
    by: Dict[str, float] = collections.Counter()
    if dev:
        labels = span_labels(host, dev, prefix)
        for d in dev:
            by[labels.get(id(d), NO_SPAN)] += d.time_range.end - d.time_range.start
    else:
        for e in program_spans(host, prefix):
            by[e.name] += e.time_range.end - e.time_range.start
    return [[k, v / 1e3 / steps] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def idle_table(prof, steps: int, prefix: str = PREFIX) -> List[list]:
    """``[[span, ms a step], ...]``, largest first: the card's idle time
    from the first program span's start to the end of the last event, each
    gap charged to the innermost program span open (on any thread) when it
    began; empty where the run has no device events."""
    dev = device_events(prof)
    spans = program_spans(host_events(prof), prefix)
    if not dev or not spans:
        return []
    lo = min(e.time_range.start for e in spans)
    hi = max([e.time_range.end for e in spans] + [e.time_range.end for e in dev])
    gaps, t = [], lo
    for a, b in sorted(_spans(dev)):
        if b <= t:
            continue
        if a > t:
            gaps.append((t, a))
        t = b
    if hi > t:
        gaps.append((t, hi))
    open_at = _Innermost([(e.time_range.start, e.time_range.end, e.name) for e in spans])
    by: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        by[open_at.at(a) or NO_SPAN] += b - a
    return [[k, v / 1e3 / steps] for k, v in sorted(by.items(), key=lambda kv: -kv[1])]


def print_spans(prof, steps: int, on_device: bool) -> None:
    """The two span tables, ms a step: the card's time by span and its idle
    time by span (host time by span on the CPU)."""
    side = "device" if on_device else "host (CPU: no device events)"
    print(f"\n{side} ms per step by program span:")
    for name, ms in span_table(prof, steps):
        print(f"  {ms:9.3f}  {name}")
    if on_device:
        print("device idle ms per step by the program span open when each gap began:")
        for name, ms in idle_table(prof, steps):
            print(f"  {ms:9.3f}  {name}")


def print_waits(waits: Dict[Tuple[str, str], int], steps: int) -> None:
    """The program's host waits (``{(span, "file:line"): count}``) per step,
    most first."""
    print(f"host waits per step by span and site ({sum(waits.values()) / steps:.1f} in all):")
    if not waits:
        print("  none counted (the count needs a CUDA step under the profiler)")
    for (name, site), n in sorted(waits.items(), key=lambda kv: -kv[1]):
        print(f"  {n / steps:7.2f}  {name:20s}  {site}")
