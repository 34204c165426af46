"""ABMIL: attention-based MIL pooling (counterpart of ``murcl_tpu/models/abmil.py:57-98``).

Reference layout (``models/abmil.py:12-33`` of the reference), kept as the
``state_dict`` keys (``murcl_tpu/engine/torch_import.py`` ``ABMIL_MAP``):
``encoder.0/.3/.6``, three Linear+ReLU blocks with dropout after the first
two; ``attention.0`` and ``attention.2``, the scorer ``L -> D -> tanh -> 1``;
``decoder.0``, ``L -> L`` then ReLU; and ``fc``, the classification head,
which ``forward`` computes only for ``aux["logits"]`` (the reference never
applies it; the ``FullLayer`` head classifies downstream). Init is
``nn.Linear``'s default, the reference's and the JAX ``init="torch"``'s.

The forward: the encoder runs in the bag dtype with plain matmuls (the JAX
package leaves them to XLA); the ungated attention pool is
:func:`murcl_tpu_torch.ops.attention.gated_attention_pool` with
``gated=False`` (K7 with ``dx`` on the GPU); the pooled vector and the
weights are scaled by ``1/sqrt(N)`` after the softmax (``1/sqrt(max(sum
mask, 1))`` with a mask); the decoder runs in f32 on the pooled vector.
"""

from __future__ import annotations

import torch
from torch import nn

from murcl_tpu_torch.ops.attention import gated_attention_pool


class ABMIL(nn.Module):
    """``forward(x (B, N, dim_in), mask=None)`` returns ``(out (B, L) f32,
    {"logits" (B, dim_out), "attention" (B, N)})``."""

    def __init__(self, dim_in: int, L: int = 512, D: int = 128, K: int = 1, dim_out: int = 2,
                 dropout: float = 0.0):
        super().__init__()
        if K != 1:
            raise NotImplementedError(
                f"ABMIL with K={K} attention heads: the pool has one head, as in murcl_tpu")
        self.L, self.D, self.K = L, D, K
        self.dropout = dropout
        self.encoder = nn.Sequential(
            nn.Linear(dim_in, L), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(L, L), nn.ReLU(), nn.Dropout(dropout),
            nn.Linear(L, L), nn.ReLU())
        self.attention = nn.Sequential(nn.Linear(L, D), nn.Tanh(), nn.Linear(D, K))
        self.decoder = nn.Sequential(nn.Linear(L, L), nn.ReLU())
        self.fc = nn.Linear(L, dim_out)

    def forward(self, x, mask=None, generator: torch.Generator = None):
        """``x`` is data (bf16 or f32). In training with dropout > 0 one seed
        is drawn from ``generator`` per forward; it seeds a generator on the
        bag's device for the encoder's dropout masks."""
        dt = x.dtype
        drop = None
        if self.training and self.dropout > 0:
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
            drop = torch.Generator(device=x.device).manual_seed(seed)
        h = x
        for i in (0, 3, 6):
            lin = self.encoder[i]
            # two roundings, as the JAX TorchLinear: the product, then the bias
            h = torch.relu(h @ lin.weight.t().to(dt) + lin.bias.to(dt))
            if drop is not None and i < 6:
                keep = torch.rand(h.shape, generator=drop, device=h.device) >= self.dropout
                h = torch.where(keep, h / (1.0 - self.dropout), torch.zeros((), dtype=dt,
                                                                         device=h.device))
        a, c = self.attention[0], self.attention[2]
        m, p, _ = gated_attention_pool(
            h, a.weight.t(), a.bias, torch.zeros(a.weight.t().shape, device=h.device),
            torch.zeros(a.bias.shape, device=h.device), c.weight[0], c.bias[0], mask=mask,
            gated=False)
        if mask is None:
            scale = 1.0 / torch.sqrt(m.new_tensor(float(h.shape[1])))
            m, p = m * scale, p * scale
        else:
            root = torch.sqrt(mask.sum(dim=-1, keepdim=True).clamp_min(1).to(m.dtype))
            m, p = m / root, p / root
        out = self.decoder(m)
        return out, {"logits": self.fc(out), "attention": p}
