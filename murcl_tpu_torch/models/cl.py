"""Contrastive dual-view wrapper (counterpart of ``murcl_tpu/models/cl.py``).

The reference ``CL`` owns an ``encoder`` and maps it over a list of views;
it adds no parameters, but nests the aggregator's ``state_dict`` keys under
``encoder.``, the prefix reference checkpoints carry.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn


class CL(nn.Module):
    def __init__(self, encoder: nn.Module, projection_dim: int = 128,
                 n_features: int = 512):
        super().__init__()
        self.encoder = encoder
        self.projection_dim = projection_dim  # stored but unused, like the reference
        self.n_features = n_features

    def forward(self, x_views: Sequence, **kwargs):
        return [self.encoder(x, **kwargs) for x in x_views]
