"""CLAM_SB (counterpart of ``murcl_tpu/models/clam.py``).

Reference module layout (``models/clam.py:37-80`` of the reference): the
trunk ``attention_net = [Linear(in, 512), ReLU, Dropout, Attn_Net_Gated]``
(``Attn_Net`` with ``gate=False``), the dead-code bag head ``classifiers``
and per-class ``instance_classifiers``. Parameters and their ``state_dict``
keys follow it, so reference checkpoints and the port's are one format; init
is xavier-normal weights and zero biases. The forward does not run these
submodules one by one; their parameters feed one of two routes, gated or
not:

- default (pretraining): :func:`murcl_tpu_torch.ops.attention.fused_trunk_attention_pool`
  (kernels K2/K3 on the GPU) computes trunk, gates, softmax and pooling in
  one op, with bag mixup folded in when ``mix`` is given. An unmixed bag
  that requires grad gets its gradient from K3 (the JAX model's
  ``attn_input_grad``, ``murcl_tpu/models/clam.py:234``, which autograd's
  ``needs_input_grad`` decides here); the engines' bags are data and need none.
  As in the JAX model (``clam.py:144-192``), a bag whose ``(N, max(in, L1))``
  block is over 6 MiB (:func:`~murcl_tpu_torch.ops.attention.fused_trunk_resident`),
  unmixed and without active dropout (a full slide in eval) takes the trunk
  as a plain product and then :func:`~murcl_tpu_torch.ops.attention.gated_attention_pool`,
  which streams it through K8 when the trunk's output is over 6 MiB;
- ``instance_eval=True`` (supervised training): the trunk is plain torch,
  ``relu(h @ Wf + bf)`` in the bag dtype, because the instance losses gather
  its rows; the pool is :func:`murcl_tpu_torch.ops.attention.gated_attention_pool`
  (K7 on the GPU), with the gradient flowing back into the trunk. The
  instance losses follow ``_instance_losses`` of the JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from murcl_tpu_torch.ops.attention import (fused_trunk_attention_pool, fused_trunk_resident,
                                          gated_attention_pool)

SIZE_DICT = {"small": (512, 256), "big": (512, 384)}


class AttnNetGated(nn.Module):
    """Parameters of the reference ``Attn_Net_Gated`` (keys ``attention_a.0``,
    ``attention_b.0``, ``attention_c``)."""

    def __init__(self, L: int, D: int, dropout: float):
        super().__init__()
        self.attention_a = nn.Sequential(nn.Linear(L, D), nn.Tanh(), nn.Dropout(dropout))
        self.attention_b = nn.Sequential(nn.Linear(L, D), nn.Sigmoid(), nn.Dropout(dropout))
        self.attention_c = nn.Linear(D, 1)

    def gates(self):
        """``(wa (L, D), ba, wb, bb, wc (D,), bc ())`` for the attention ops."""
        a, b, c = self.attention_a[0], self.attention_b[0], self.attention_c
        return a.weight.t(), a.bias, b.weight.t(), b.bias, c.weight[0], c.bias[0]


class AttnNet(nn.Module):
    """Parameters of the reference ungated ``Attn_Net`` (keys ``module.0`` and
    ``module.3``). The dropout slot at index 2 stays at rate 0 too, so the
    keys are the reference's dropout-on layout; ``murcl_tpu``'s
    ``torch_import.clam_map`` maps only the gated layout, and
    :mod:`murcl_tpu_torch.engine.weights` maps this one to the JAX leaves
    ``attn/wa, ba, wc, bc``."""

    def __init__(self, L: int, D: int, dropout: float):
        super().__init__()
        self.module = nn.Sequential(nn.Linear(L, D), nn.Tanh(), nn.Dropout(dropout),
                                    nn.Linear(D, 1))

    def gates(self):
        """``(wa, ba, wb, bb, wc, bc)`` with zero ``wb``/``bb``, which the
        ungated ops ignore (the JAX model's inert inputs, ``clam.py:129-131``)."""
        a, c = self.module[0], self.module[3]
        zb = torch.zeros(a.bias.shape, device=a.bias.device)
        zw = torch.zeros(a.weight.t().shape, device=a.weight.device)
        return a.weight.t(), a.bias, zw, zb, c.weight[0], c.bias[0]


def _instance_ce(logits, target: int):
    """Per-bag mean cross-entropy of ``logits (B, C, k, 2)`` against one
    pseudo-label for every instance: ``(B, C)``."""
    return -F.log_softmax(logits, dim=-1)[..., target].mean(dim=-1)


class CLAM_SB(nn.Module):
    """Single-branch CLAM; ``forward`` returns ``(M (B, L1), aux)`` where
    ``aux`` holds ``attention`` (raw scores (B, N)), ``logits`` and, with
    ``instance_eval``, ``instance_loss`` (B,)."""

    def __init__(self, in_dim: int = 512, gate: bool = True, size_arg: str = "small",
                 dropout: float = 0.0, k_sample: int = 8, n_classes: int = 2,
                 subtyping: bool = False):
        super().__init__()
        l1, l2 = SIZE_DICT[size_arg]
        self.gate = gate
        self.dropout = dropout
        self.k_sample = k_sample
        self.n_classes = n_classes
        self.subtyping = subtyping
        # Dropout sits at index 2 even at rate 0, so the attention net keeps
        # the reference's dropout-on key layout (attention_net.3)
        self.attention_net = nn.Sequential(
            nn.Linear(in_dim, l1), nn.ReLU(), nn.Dropout(dropout),
            (AttnNetGated if gate else AttnNet)(l1, l2, dropout))
        self.classifiers = nn.Linear(l1, n_classes)
        self.instance_classifiers = nn.ModuleList(
            [nn.Linear(l1, 2) for _ in range(n_classes)])
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.xavier_normal_(m.weight)
                nn.init.zeros_(m.bias)

    def forward(self, h, mask=None, mix=None, instance_eval: bool = False, label=None,
                generator: torch.Generator = None):
        """``h (B, N, in_dim)`` bags (data, no grad); ``mix=(perm, lam)``
        folds bag mixup into the kernel (default route only); ``label (B,)``
        is needed with ``instance_eval``. In training with dropout > 0 one
        dropout seed is drawn from ``generator`` per forward: it keys the
        kernels' hash masks, and on the instance route the trunk's mask comes
        from a ``torch.Generator`` on the bag's device seeded with it."""
        rate, seed = 0.0, 0
        if self.training and self.dropout > 0:
            rate = self.dropout
            seed = int(torch.randint(0, 2**31 - 1, (), generator=generator))
        trunk = self.attention_net[0]
        gates = self.attention_net[3].gates()
        dt = h.dtype
        if (not instance_eval and mix is None and rate == 0
                and not fused_trunk_resident(h.shape[1], h.shape[2], trunk.out_features,
                                             h.element_size())):
            # JAX's unfused route for a bag that does not stay resident
            # (murcl_tpu/models/clam.py:168-192): the trunk as a plain product,
            # then the pool, which streams a bag over 6 MiB through K8
            x = torch.relu(h @ trunk.weight.t().to(dt) + trunk.bias.to(dt))
            m, _, s = gated_attention_pool(x, *gates, mask=mask, gated=self.gate)
            return m, {"attention": s, "logits": self.classifiers(m)}
        if not instance_eval:
            m, _, s = fused_trunk_attention_pool(h, trunk.weight.t(), trunk.bias, *gates,
                                                 mask=mask, dropout=rate, seed=seed, mix=mix,
                                                 gated=self.gate)
            return m, {"attention": s, "logits": self.classifiers(m)}

        if label is None:
            raise ValueError("instance_eval=True requires integer labels (B,)")
        if mix is not None:
            raise ValueError("mix is folded into the default route only; the supervised "
                             "instance route never mixes")
        x = torch.relu(h @ trunk.weight.t().to(dt) + trunk.bias.to(dt))
        if rate > 0:
            gen = torch.Generator(device=x.device).manual_seed(seed)
            keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
            x = torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=dt, device=x.device))
        m, p, s = gated_attention_pool(x, *gates, mask=mask, gated=self.gate, dropout=rate,
                                       seed=seed)
        aux = {"attention": s, "logits": self.classifiers(m),
               "instance_loss": self._instance_loss(p, x, label)}
        return m, aux

    def _instance_loss(self, p, x, label):
        """In/out-of-class instance losses (JAX ``_instance_losses``): the
        ``k_sample`` rows of highest and of lowest attention ``p`` go through
        every class's binary classifier; the label's class scores top = 1 and
        bottom = 0, and with ``subtyping`` the other classes push their top-k
        to 0, averaged over classes. Returns ``(B,)``."""
        k = self.k_sample
        rows = lambda idx: x.gather(1, idx[..., None].expand(-1, -1, x.shape[-1]))  # noqa: E731
        top = rows(p.topk(k, dim=1).indices).float()
        bot = rows((-p).topk(k, dim=1).indices).float()
        w = torch.stack([c.weight.t() for c in self.instance_classifiers])  # (C, L1, 2)
        bias = torch.stack([c.bias for c in self.instance_classifiers])  # (C, 2)
        logit_top = torch.einsum("bkl,clo->bcko", top, w) + bias[None, :, None, :]
        logit_bot = torch.einsum("bkl,clo->bcko", bot, w) + bias[None, :, None, :]
        loss_in = (_instance_ce(logit_top, 1) + _instance_ce(logit_bot, 0)) / 2
        in_class = F.one_hot(label.long(), self.n_classes).to(loss_in.dtype)
        total = (loss_in * in_class).sum(dim=1)
        if self.subtyping:
            loss_out = _instance_ce(logit_top, 0)
            total = (total + (loss_out * (1.0 - in_class)).sum(dim=1)) / self.n_classes
        return total
