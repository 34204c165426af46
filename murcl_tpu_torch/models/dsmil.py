"""DSMIL: dual-stream MIL (counterpart of ``murcl_tpu/models/dsmil.py:32-88``).

Reference layout (``models/dsmil.py`` of the reference), kept as the
``state_dict`` keys (``murcl_tpu/engine/torch_import.py`` ``DSMIL_MAP``):
``i_classifier.fc.0``, the instance head ``dim -> C``; ``b_classifier.q``,
the query projection ``dim -> 128``; ``b_classifier.v``, ``Dropout`` then
``Linear(dim, dim)`` (so its Linear is ``v.1``); and ``b_classifier.fcc``,
a ``Conv1d(C, C, kernel_size=dim)``, dead in the reference and kept as
parameters (its weight ``(C, C, dim)`` is the JAX leaf ``fcc_kernel`` as it
is); the forward computes it only when asked (``with_conv=True``), since no
engine reads it.

The forward runs in the bag's dtype, as the JAX module does: the critical
instance of each class is the argmax over N of the (masked) instance
logits, first index on ties; its query is gathered; ``att = softmax_N(q
q_crit^T / sqrt(128))`` (masked rows at -1e30) and ``bag = att^T v``. The
JAX package computes these products outside any Pallas kernel, so they are
plain batched matmuls here.
"""

from __future__ import annotations

import torch
from torch import nn

_NEG_INF = -1e30


def _linear(x, lin: nn.Linear):
    # two roundings, as the JAX TorchLinear: the product, then the bias
    return x @ lin.weight.t().to(x.dtype) + lin.bias.to(x.dtype)


class FCLayer(nn.Module):
    def __init__(self, in_size: int, out_size: int):
        super().__init__()
        self.fc = nn.Sequential(nn.Linear(in_size, out_size))


class BClassifier(nn.Module):
    def __init__(self, input_size: int, output_class: int, dropout_v: float = 0.0,
                 q_dim: int = 128):
        super().__init__()
        self.q = nn.Linear(input_size, q_dim)
        self.v = nn.Sequential(nn.Dropout(dropout_v), nn.Linear(input_size, input_size))
        self.fcc = nn.Conv1d(output_class, output_class, kernel_size=input_size)


class MILNet(nn.Module):
    """``forward(x (B, N, dim_feat), mask=None)`` returns ``(inst_logits (B,
    N, C), bag (B, C, dim_feat), {"attention" (B, N, C)})``, and with
    ``with_conv=True`` also ``"conv_logits" (B, C)`` in the dict."""

    def __init__(self, dim_feat: int, num_classes: int, dropout_v: float = 0.0,
                 q_dim: int = 128):
        super().__init__()
        self.dropout_v = dropout_v
        self.q_dim = q_dim
        self.i_classifier = FCLayer(dim_feat, num_classes)
        self.b_classifier = BClassifier(dim_feat, num_classes, dropout_v, q_dim)

    def forward(self, x, mask=None, generator: torch.Generator = None,
                with_conv: bool = False):
        """``x`` is data (bf16 or f32). In training with ``dropout_v`` > 0
        one seed is drawn from ``generator`` per forward; it seeds a
        generator on the bag's device for the dropout mask of ``v``'s
        input."""
        bc = self.b_classifier
        inst = _linear(x, self.i_classifier.fc[0])  # (B, N, C)
        q = _linear(x, bc.q)  # (B, N, 128)
        v = x
        if self.training and self.dropout_v > 0:
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
            drop = torch.Generator(device=x.device).manual_seed(seed)
            keep = torch.rand(x.shape, generator=drop, device=x.device) >= self.dropout_v
            v = torch.where(keep, x / (1.0 - self.dropout_v),
                            torch.zeros((), dtype=x.dtype, device=x.device))
        v = _linear(v, bc.v[1])  # (B, N, D)

        scores = inst if mask is None else inst.masked_fill(~mask[..., None], _NEG_INF)
        crit = scores.argmax(dim=1)  # (B, C)
        q_crit = torch.gather(q, 1, crit[..., None].expand(-1, -1, q.shape[-1]))  # (B, C, 128)
        # sqrt(128) rounded to the bag's dtype, as JAX takes it
        root = float(torch.tensor(float(self.q_dim), dtype=q.dtype).sqrt())
        att = torch.einsum("bnq,bcq->bnc", q, q_crit) / root
        if mask is not None:
            att = att.masked_fill(~mask[..., None], _NEG_INF)
        att = torch.softmax(att, dim=1)  # over instances, per class
        bag = torch.einsum("bnc,bnd->bcd", att, v)  # (B, C, D)
        aux = {"attention": att}
        if with_conv:  # the dead conv head: Conv1d(C, C, kernel_size=D) is a full-width dot
            aux["conv_logits"] = (torch.einsum("bcd,ocd->bo", bag.float(),
                                               bc.fcc.weight.float()) + bc.fcc.bias.float())
        return inst, bag, aux
