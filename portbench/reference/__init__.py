"""The plain PyTorch reference the port's runs are checked against: float32,
no kernels, nothing of ``murcl_tpu_torch``."""
