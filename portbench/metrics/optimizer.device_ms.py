"""optimizer.device_ms (layer: optimizer, ``engine/optim.py`` ``step``: the
zero gradients of the dead heads, the ranks' sum where there are ranks, and
Adam's step): the device time a step of the events that the program's
``murcl.optimizer`` spans caused, the union of their intervals, in ms; None
where the program opens no such span. Moves slides_per_s."""

from portbench.trace import busy_union_ms


def read(run):
    events = run.caused_by("murcl.optimizer")
    return busy_union_ms(events) / run.steps if events else None
