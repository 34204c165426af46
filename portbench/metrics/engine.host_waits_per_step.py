"""engine.host_waits_per_step (layer: engine): the host's waits for the card
per profiled step, as the program counts them (``murcl_tpu_torch/utils/
trace.py`` ``host_waits``: under a profiler, each CUDA step runs under
torch's sync debug mode and counts every blocking copy, ``.item()`` and
stream sync by span and call site; device-to-device copies, which
``engine.host_syncs_per_step`` counts beside them, do not block the host
and are not counted). None where the program has no such counter, or its
torch cannot flag syncs. Moves slides_per_s."""


def read(run):
    try:
        from murcl_tpu_torch.utils.trace import SYNC_DEBUG, host_waits
    except ImportError:
        return None
    if not SYNC_DEBUG:
        return None
    return sum(host_waits().values()) / run.steps
