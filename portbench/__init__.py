"""The benchmark of the PyTorch/CUDA port, ``murcl_tpu_torch``: MuRCL
pretraining cells on one H100, run by ``python3 -m portbench.run`` and
described by ``BENCHMARK.json`` at the checkout's root. It imports neither
JAX nor the JAX package."""
