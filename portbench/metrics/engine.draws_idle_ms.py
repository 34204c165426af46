"""engine.draws_idle_ms (layer: engine, the step's random draws on the host
and their moves to the card, ``engine/contrastive.py``): the card's idle
time a step in the profiled window, summed over the gaps in its work that
began inside one of the program's ``murcl.draws`` spans, in ms; None where
the program opens no such span. Moves slides_per_s."""

import bisect

from portbench.trace import clipped, merged


def read(run):
    draws = merged((e.time_range.start, e.time_range.end) for e in run.host
                   if e.name == "murcl.draws")
    if not draws:
        return None
    lo, hi = run.window_us
    gaps, t = [], lo
    for a, b in merged(clipped(run.device, lo, hi)):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    starts = [a for a, _ in draws]

    def inside(t):
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= draws[i][1]

    return sum(b - a for a, b in gaps if inside(a)) / 1e3 / run.steps
