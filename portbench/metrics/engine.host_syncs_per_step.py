"""engine.host_syncs_per_step (layer: engine): the host's
``cudaStreamSynchronize`` and ``cudaMemcpyAsync`` calls per step in the
profiled window, the waits and copies that keep the host from running ahead
of the card. Moves slides_per_s."""

from portbench.trace import call_counts


def read(run):
    lo, hi = run.window_us
    calls = call_counts([e for e in run.host if lo <= e.time_range.start <= hi])
    return sum(calls.values()) / run.steps
