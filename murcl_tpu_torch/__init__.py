"""PyTorch/CUDA port of MuRCL, beside the JAX reference package ``murcl_tpu``.

Plain tensor code is PyTorch; every Pallas kernel that ``murcl_tpu`` runs on
its stage-1 pretraining path is a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` on first use and bound with ``ctypes``
(:mod:`murcl_tpu_torch.ops._cuda`). Each kernel has a plain PyTorch twin in
the same module; the wrappers take it only for tensors on the CPU.

This package imports neither ``jax`` nor ``murcl_tpu``.
"""
