"""Models: CLAM_SB on the fused-trunk route, the CL wrapper, the GRU head."""

from murcl_tpu_torch.models.cl import CL
from murcl_tpu_torch.models.clam import CLAM_SB
from murcl_tpu_torch.models.rlmil import FullLayer

__all__ = ["CL", "CLAM_SB", "FullLayer"]
