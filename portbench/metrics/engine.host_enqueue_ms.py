"""engine.host_enqueue_ms (layer: engine, ``engine/contrastive.py``
``train_step``): the median host time of one ``train_step`` call, without
a synchronisation of the benchmark's around it, over the traced run's
steps before the profiler. Moves slides_per_s where the host paces the
step."""

import statistics


def read(run):
    return statistics.median(run.enqueue_ms) if run.enqueue_ms else None
