"""device.idle_pct (layer: the device): 100 less the share of the profiled
window in which some operation ran on the card (the union of the device
events' intervals), in %. Moves slides_per_s."""


def read(run):
    lo, hi = run.window_us
    return 100.0 * (1.0 - run.busy_us / (hi - lo))
