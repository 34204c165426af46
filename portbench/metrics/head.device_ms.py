"""head.device_ms (layer: head, ``models/rlmil.py`` ``FullLayer``: the GRU
head, 2T calls a step): the device time a step of the events that the
program's ``murcl.head`` spans caused, forward and backward (the backward
by the autograd nodes made inside them), the union of their intervals, in
ms; None where the program opens no such span. Moves slides_per_s."""

from portbench.trace import busy_union_ms


def read(run):
    events = run.caused_by("murcl.head")
    return busy_union_ms(events) / run.steps if events else None
