"""The benchmark's reading of a ``torch.profiler`` run: device events, the
union of their intervals, a table by op name, the host's runtime calls per
step, and the device events that the benchmark's own spans caused.

``device_events``, ``host_events``, ``busy_union_ms`` and ``op_table`` are
copies of the program's step-diagnostic helpers
(``murcl_tpu_torch/scripts/profiling.py``), kept here so that the yardstick
stays put when the program's copy changes.

A span is a ``record_function`` the benchmark opens around a call into a
layer (:class:`Spans`: a module's forward, by hooks). The device events a
span caused are those launched from inside it, and, for a forward, those
launched by the autograd nodes it created, found by their sequence numbers:
each op the profiler records inside the forward carries the number of the
node it makes, and the backward's ``evaluate_function`` ops carry the
number of the node they run and the thread that made it. A kernel is tied
to the host op that launched it by the profiler's correlation: a device
event's ``linked_correlation_id`` names its op, and the runtime call that
launched it shares the device event's ``id``. None of this reads a kernel's
name, so a kernel that replaces another is counted against the same work.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch

BWD_PREFIX = "autograd::engine::evaluate_function"
# the host's runtime calls that copy to or from the card or wait for it
SYNC_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync")


def device_events(prof) -> list:
    """The card's events of a run (kernels, copies, memsets), without the
    device-side spans of ``record_function``."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def host_events(prof) -> list:
    """The host's events (ops, ``record_function`` spans, runtime calls)."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU]


def _spans(events: Iterable) -> List[Tuple[float, float]]:
    return [(e.time_range.start, e.time_range.end) for e in events]


def merged(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """Overlapping intervals merged, in order."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def busy_union_ms(events) -> float:
    """The union of the events' intervals, ms (the profiler's times are us)."""
    return sum(b - a for a, b in merged(_spans(events))) / 1e3


def op_table(events, steps: int, top: int = 0) -> List[dict]:
    """Per op name, by summed time: ``{"op", "ms", "calls", "sum_ms",
    "union_ms"}``, ``ms`` the summed ms per step, ``calls`` the count per
    step (floored), ``sum_ms`` summed over the run, ``union_ms`` the union of
    that op's intervals."""
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


def call_counts(host: Sequence, names: Sequence[str] = SYNC_CALLS) -> Dict[str, int]:
    """How many of the host's runtime calls bear each of ``names``."""
    counts = collections.Counter(e.name for e in host)
    return {n: counts.get(n, 0) for n in names}


def within(host: Sequence, label: str) -> Optional[Tuple[float, float]]:
    """The interval of the first host span named ``label``."""
    for e in host:
        if e.name == label:
            return e.time_range.start, e.time_range.end
    return None


def clipped(events: Sequence, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The events' intervals cut to ``[lo, hi]``."""
    return [(max(a, lo), min(b, hi)) for a, b in _spans(events) if b > lo and a < hi]


def launch_points(host: Sequence, device: Sequence) -> Dict[int, Tuple[int, float]]:
    """``id(device event) -> (host thread, host time)`` of the call that
    launched it: the runtime call sharing its ``id`` where the trace has
    one, else the op its ``linked_correlation_id`` names."""
    runtime = {e.id: e for e in host if e.name.startswith("cu")}
    ops = {e.id: e for e in host if not e.name.startswith("cu")}
    out = {}
    for d in device:
        src = runtime.get(d.id) or ops.get(getattr(d, "linked_correlation_id", 0) or -1)
        if src is not None:
            out[id(d)] = (src.thread, src.time_range.start)
    return out


class _Intervals:
    """Intervals of one thread, for point queries."""

    def __init__(self, spans):
        self.spans = merged(spans)
        self.starts = [a for a, _ in self.spans]

    def has(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and t <= self.spans[i][1]


def caused_by(host: Sequence, device: Sequence, label: str) -> List:
    """The device events the spans named ``label`` caused: launched inside
    one, or by an autograd node made inside one (by sequence number and
    forward thread)."""
    spans = [e for e in host if e.name == label]
    if not spans:
        return []
    inside = collections.defaultdict(list)
    for s in spans:
        inside[s.thread].append((s.time_range.start, s.time_range.end))
    fwd = {k: _Intervals(v) for k, v in inside.items()}
    made = set()
    for e in host:
        seq = getattr(e, "sequence_nr", -1)
        if seq >= 0 and not e.name.startswith(BWD_PREFIX) and e.thread in fwd \
                and fwd[e.thread].has(e.time_range.start):
            made.add((e.thread, seq))
    bwd = collections.defaultdict(list)
    for e in host:
        if e.name.startswith(BWD_PREFIX) and (e.fwd_thread, e.sequence_nr) in made:
            bwd[e.thread].append((e.time_range.start, e.time_range.end))
    back = {k: _Intervals(v) for k, v in bwd.items()}
    points = launch_points(host, device)
    out = []
    for d in device:
        where = points.get(id(d))
        if where is None:
            continue
        thread, t = where
        if (thread in fwd and fwd[thread].has(t)) or (thread in back and back[thread].has(t)):
            out.append(d)
    return out


def idle_gaps(host: Sequence, device: Sequence, lo: float, hi: float,
              top: int = 10) -> List[List]:
    """The device's idle time in ``[lo, hi]`` by what the host was doing when
    each gap began (the innermost host op then, on any thread), in seconds,
    the largest ``top``."""
    busy = merged(clipped(device, lo, hi))
    gaps, t = [], lo
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    ops = sorted(host, key=lambda e: e.time_range.start)
    starts = [e.time_range.start for e in ops]
    by: Dict[str, float] = collections.Counter()
    for a, b in gaps:
        name = "(no host op)"
        # the latest-starting op that still runs at a
        i0 = bisect.bisect_right(starts, a) - 1
        for i in range(i0, max(-1, i0 - 5000), -1):
            if ops[i].time_range.end >= a:
                name = ops[i].name
                break
        by[name] += (b - a) / 1e6
    return [[k, v] for k, v in by.most_common(top)]


class Spans:
    """``record_function`` spans around the forward calls of modules, opened
    by a forward pre-hook and closed by a forward hook; :meth:`close` removes
    the hooks."""

    def __init__(self):
        self._handles = []

    def add(self, module: torch.nn.Module, label: str) -> None:
        stack = []

        def pre(_m, _args):
            rf = torch.autograd.profiler.record_function(label)
            rf.__enter__()
            stack.append(rf)

        def post(_m, _args, _out):
            stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def close(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []
