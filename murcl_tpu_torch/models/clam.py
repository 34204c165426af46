"""CLAM_SB on the fused-trunk route (counterpart of ``murcl_tpu/models/clam.py``).

Reference module layout (``models/clam.py:37-80`` of the reference): the
trunk ``attention_net = [Linear(in, 512), ReLU, Dropout, Attn_Net_Gated]``,
the dead-code bag head ``classifiers`` and per-class ``instance_classifiers``.
Parameters and their ``state_dict`` keys follow it, so reference checkpoints
and the port's are one format; init is xavier-normal weights and zero
biases. The forward does not run these submodules one by one: their
parameters feed :func:`murcl_tpu_torch.ops.attention.fused_trunk_attention_pool`
(kernels K2/K3 on the GPU), which computes trunk, gates, softmax and pooling
in one op, with bag mixup folded in when ``mix`` is given.
"""

from __future__ import annotations

import torch
from torch import nn

from murcl_tpu_torch.ops.attention import fused_trunk_attention_pool

SIZE_DICT = {"small": (512, 256), "big": (512, 384)}


class AttnNetGated(nn.Module):
    """Parameters of the reference ``Attn_Net_Gated`` (keys ``attention_a.0``,
    ``attention_b.0``, ``attention_c``)."""

    def __init__(self, L: int, D: int, dropout: float):
        super().__init__()
        self.attention_a = nn.Sequential(nn.Linear(L, D), nn.Tanh(), nn.Dropout(dropout))
        self.attention_b = nn.Sequential(nn.Linear(L, D), nn.Sigmoid(), nn.Dropout(dropout))
        self.attention_c = nn.Linear(D, 1)


class CLAM_SB(nn.Module):
    """Single-branch CLAM; ``forward`` returns ``(M (B, L1), aux)`` where
    ``aux`` holds ``attention`` (raw scores (B, N)) and ``logits``."""

    def __init__(self, in_dim: int = 512, gate: bool = True, size_arg: str = "small",
                 dropout: float = 0.0, k_sample: int = 8, n_classes: int = 2,
                 subtyping: bool = False):
        super().__init__()
        if not gate:
            raise NotImplementedError(
                "ungated CLAM needs the ungated attention kernel (ROADMAP queue 2, K7)")
        l1, l2 = SIZE_DICT[size_arg]
        self.dropout = dropout
        self.k_sample = k_sample
        self.n_classes = n_classes
        self.subtyping = subtyping
        # Dropout sits at index 2 even at rate 0, so the attention net keeps
        # the reference's dropout-on key layout (attention_net.3)
        self.attention_net = nn.Sequential(
            nn.Linear(in_dim, l1), nn.ReLU(), nn.Dropout(dropout),
            AttnNetGated(l1, l2, dropout))
        self.classifiers = nn.Linear(l1, n_classes)
        self.instance_classifiers = nn.ModuleList(
            [nn.Linear(l1, 2) for _ in range(n_classes)])
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_normal_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, h, mask=None, mix=None, instance_eval: bool = False,
                generator: torch.Generator = None):
        """``h (B, N, in_dim)`` bags (data, no grad); ``mix=(perm, lam)``
        folds bag mixup into the kernel; in training with dropout > 0 one
        dropout seed is drawn from ``generator`` per forward."""
        if instance_eval:
            raise NotImplementedError(
                "CLAM instance-eval is supervised-only (ROADMAP queue 1, slice 3)")
        trunk = self.attention_net[0]
        att = self.attention_net[3]
        rate, seed = 0.0, 0
        if self.training and self.dropout > 0:
            rate = self.dropout
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        m, _, s = fused_trunk_attention_pool(
            h, trunk.weight.t(), trunk.bias,
            att.attention_a[0].weight.t(), att.attention_a[0].bias,
            att.attention_b[0].weight.t(), att.attention_b[0].bias,
            att.attention_c.weight[0], att.attention_c.bias[0],
            mask=mask, dropout=rate, seed=seed, mix=mix)
        return m, {"attention": s, "logits": self.classifiers(m)}
