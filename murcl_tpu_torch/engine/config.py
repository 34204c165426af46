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

    arch: str  # ABMIL | CLAM_SB | DSMIL (supervised); ABMIL | CLAM_SB (MuRCL)
    T: int = 6
    feat_size: int = 1024
    num_clusters: int = 10
    train_stage: int = 1  # 1 | 2 | 3
    num_classes: int = 2
    bag_weight: float = 0.7  # CLAM's CE weight; 1 - bag_weight on the instance loss
    # aggregator compute dtype; losses, softmax and the GRU head stay float32
    compute_dtype: str = "float32"  # float32 | bfloat16

    @property
    def uses_policy(self) -> bool:
        """Stages 2 and 3 take their actions from the PPO policy."""
        return self.train_stage != 1


@dataclass(frozen=True)
class PretrainConfig(RolloutConfig):
    """MuRCL contrastive pretraining extras (``train_MuRCL.py``)."""

    alpha: float = 0.9
    temperature: float = 0.5
