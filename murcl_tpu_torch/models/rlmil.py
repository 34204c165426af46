"""GRU projection head (counterpart of ``murcl_tpu/models/rlmil.py`` ``FullLayer``).

The reference ``Full_layer`` (``fc_rnn=True``) is a one-layer GRU over the
rollout steps plus a linear head. Here the carry is explicit: ``forward(x,
hidden)`` returns ``(logits, new_hidden)`` and ``hidden=None`` restarts from
zeros. The parameters live in an ``nn.GRU`` so the ``state_dict`` keys are
the reference's (``rnn.weight_ih_l0`` ...), and one step is the r, z, n
gate equations of ``nn.GRUCell`` written out as f32 matmuls, which do not
go through cuDNN's RNN (that one takes TF32 by default). Init is torch's
default, as in the reference.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


class FullLayer(nn.Module):
    def __init__(self, feature_num: int, hidden_state_dim: int = 1024,
                 fc_rnn: bool = True, class_num: int = 1000):
        super().__init__()
        if not fc_rnn:
            raise NotImplementedError(
                "the cascaded-FC head (fc_rnn=False) is not ported (ROADMAP queue 1, "
                "slice 2)")
        self.hidden_state_dim = hidden_state_dim
        self.rnn = nn.GRU(feature_num, hidden_state_dim)
        self.fc = nn.Linear(hidden_state_dim, class_num)

    def forward(self, x, hidden: Optional[torch.Tensor] = None):
        if hidden is None:
            hidden = x.new_zeros((x.shape[0], self.hidden_state_dim))
        rnn = self.rnn
        i_r, i_z, i_n = F.linear(x, rnn.weight_ih_l0, rnn.bias_ih_l0).chunk(3, dim=-1)
        h_r, h_z, h_n = F.linear(hidden, rnn.weight_hh_l0, rnn.bias_hh_l0).chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        h = (1.0 - z) * n + z * hidden
        return self.fc(h), h
