"""Configuration of the training programs (``murcl_tpu/engine/config.py``).

Field names track the reference CLI flags. The JAX package's TPU-only
fields (``remat``, ``select_impl``, ``stage1_layout``) do not exist here:
the port has one stage-1 layout (batched), compacts with its CUDA kernel on
the GPU, and keeps no rematerialisation policy. The batch size is the
shape of the slide ids a step is given; ``Nmax`` is the bank's.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RolloutConfig:
    """Shape + schedule of the T-step cluster-window rollout."""

    arch: str  # CLAM_SB (ABMIL | DSMIL are later slices)
    T: int = 6
    feat_size: int = 1024
    num_clusters: int = 10
    train_stage: int = 1  # 1 (2 | 3 are later slices)
    # aggregator compute dtype; losses, softmax and the GRU head stay float32
    compute_dtype: str = "float32"  # float32 | bfloat16


@dataclass(frozen=True)
class PretrainConfig(RolloutConfig):
    """MuRCL contrastive pretraining extras (``train_MuRCL.py``)."""

    alpha: float = 0.9
    temperature: float = 0.5
