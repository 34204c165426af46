"""select.device_ms (layer: selection, ``ops/select.py`` ``select_feats``:
the ranks and K1's compaction, K5's in stage 3): the device time a step of
the events that the program's ``murcl.select`` spans caused (launched inside
one, or by an autograd node made inside one), the union of their
intervals, in ms; None where the program opens no such span. Moves
slides_per_s."""

from portbench.trace import busy_union_ms


def read(run):
    events = run.caused_by("murcl.select")
    return busy_union_ms(events) / run.steps if events else None
