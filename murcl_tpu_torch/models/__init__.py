"""Models: the MIL aggregators (ABMIL, CLAM_SB on its fused and instance-eval
routes), the CL wrapper, the GRU head and the PPO policy."""

from __future__ import annotations

from typing import Optional

from murcl_tpu_torch.models.abmil import ABMIL
from murcl_tpu_torch.models.cl import CL
from murcl_tpu_torch.models.clam import CLAM_SB, SIZE_DICT
from murcl_tpu_torch.models.rlmil import PPO, ActorCritic, FullLayer


def build_aggregator(arch: str, dim_in: int, num_classes: int = 2,
                     arch_setting: Optional[dict] = None):
    """A MIL aggregator by name: ``(module, feature_num)``, ``feature_num``
    being its bag-embedding width, what ``FullLayer`` consumes (counterpart
    of ``murcl_tpu/models/__init__.py:34-74``). ``arch_setting``: ABMIL
    ``{L, D, K, dim_out, dropout}``; CLAM_SB ``{gate, size_arg, dropout,
    k_sample, subtyping}``."""
    s = dict(arch_setting or {})
    if arch == "ABMIL":
        model = ABMIL(dim_in=dim_in, L=s.get("L", 512), D=s.get("D", 128), K=s.get("K", 1),
                      dim_out=s.get("dim_out", num_classes), dropout=s.get("dropout", 0.0))
        return model, model.L
    if arch == "CLAM_SB":
        size_arg = s.get("size_arg", "small")
        model = CLAM_SB(in_dim=dim_in, gate=s.get("gate", True), size_arg=size_arg,
                        dropout=s.get("dropout", 0.0), k_sample=s.get("k_sample", 8),
                        n_classes=num_classes, subtyping=s.get("subtyping", False))
        return model, SIZE_DICT[size_arg][0]
    if arch == "DSMIL":
        raise NotImplementedError("DSMIL is not ported yet: ROADMAP queue 1, item 12")
    raise ValueError(f"unknown arch {arch!r}; expected ABMIL | CLAM_SB | DSMIL")


__all__ = ["ABMIL", "CL", "CLAM_SB", "ActorCritic", "FullLayer", "PPO", "build_aggregator"]
