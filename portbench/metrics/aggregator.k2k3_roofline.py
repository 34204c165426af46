"""aggregator.k2k3_roofline (layer: aggregator, ``models/clam.py`` over
``ops/attention.py``'s K2/K3): the least time CLAM_SB's aggregator function
(forward and backward over all of a step's bags, ``work.clam_flops`` at the
configuration dtype's peak, or its bytes where larger) could take, over the
device time of the kernels the benchmark's aggregator spans caused (the
forward's and its autograd nodes'), in %. Moves slides_per_s."""

from portbench import work


def read(run):
    if run.cfg["arch"] != "CLAM_SB":
        return None
    return work.aggregator_roofline(run)
