"""Ops: sub-bag selection, compaction (K1), mixup, the fused CLAM trunk and
attention pool (K2/K3), NT-Xent (K4). Kernels build lazily (``_cuda``)."""
