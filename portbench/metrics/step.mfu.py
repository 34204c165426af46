"""step.mfu (layer: the whole step): the model FLOPs of one optimizer step
(``work.step_flops``: forward and backward, no recompute, the GRU head and
the loss included) over the step's time by the host's clock (the traced
run's steps before the profiler, back to back) times the configuration
dtype's peak, in %. Moves slides_per_s."""

from portbench import work


def read(run):
    flops = work.step_flops(run.cfg, run.traffic)
    return 100.0 * flops / (run.step_s * work.PEAK_FLOPS[run.cfg["compute_dtype"]])
