"""Models: CLAM_SB (fused and instance-eval routes), the CL wrapper, the GRU
head and the PPO policy."""

from murcl_tpu_torch.models.cl import CL
from murcl_tpu_torch.models.clam import CLAM_SB
from murcl_tpu_torch.models.rlmil import PPO, ActorCritic, FullLayer

__all__ = ["CL", "CLAM_SB", "ActorCritic", "FullLayer", "PPO"]
