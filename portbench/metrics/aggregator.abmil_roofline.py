"""aggregator.abmil_roofline (layer: aggregator, ``models/abmil.py``: the
encoder's products on cuBLAS, the pool K7): the least time ABMIL's
aggregator function (forward and backward over all of a step's bags,
``work.abmil_flops`` at the configuration dtype's peak, or its bytes where
larger) could take, over the device time of the kernels the benchmark's
aggregator spans caused, in %. Moves slides_per_s."""

from portbench import work


def read(run):
    if run.cfg["arch"] != "ABMIL":
        return None
    return work.aggregator_roofline(run)
