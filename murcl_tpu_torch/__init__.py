"""PyTorch/CUDA port of MuRCL, beside the JAX reference package ``murcl_tpu``.

Plain tensor code is PyTorch; every Pallas kernel that ``murcl_tpu`` runs on
its stage-1 pretraining path and its supervised CLAM_SB path (RLMIL stages
1 to 3) is a hand-written CUDA kernel for Hopper
(``csrc/``), built with ``nvcc`` on first use and bound with ``ctypes``
(:mod:`murcl_tpu_torch.ops._cuda`). Each kernel has a plain PyTorch twin in
the same module; the wrappers take it only for tensors on the CPU.

The slide preprocessing (``preprocess/``: tiling, tissue masks, patch
features, k-means) runs on numpy, scipy and PyTorch (cuDNN for the
encoders), without PIL, OpenCV, torchvision or scikit-learn.

This package imports neither ``jax`` nor ``murcl_tpu``.
"""
