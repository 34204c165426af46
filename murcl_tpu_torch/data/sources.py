"""One batch interface over the resident and the streaming banks
(counterpart of ``murcl_tpu/data/sources.py``).

The drivers talk to a source: ``batch(ids)`` gives ``(FeatureBank,
slide_ids)`` ready for an engine step, whether the split lives on the device
(:class:`ResidentSource`, Camelyon16's scale) or is staged from the host
batch by batch (:class:`StreamingSource`, TCGA's scale), and
``iter_batches(id_list)`` does so for an epoch.

The JAX package's ``harmonize_banks`` (``murcl_tpu/data/bank.py:309-342``)
pads the resident splits to one shape so that XLA compiles once, and keeps
its compaction kernel's over-allocation rule. The port compiles nothing per
shape and its compaction kernel reads no row past a slide's own, so it has
no counterpart; the streaming splits still share one ``max_patches``, the
width of their staged patch tables, as the JAX sources do.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Sequence

import numpy as np
import torch

from murcl_tpu_torch.data.bank import FeatureBank, build_bank
from murcl_tpu_torch.data.streaming import StreamingBank


class ResidentSource:
    """The whole split on the device; a batch is its ids."""

    def __init__(self, bank: FeatureBank):
        self.bank = bank
        self.labels = bank.labels.cpu().numpy()
        self.case_ids = bank.case_ids
        self.num_slides = bank.num_slides
        self.num_clusters = bank.num_clusters
        self.patch_dim = bank.patch_dim
        self.max_patches = bank.max_patches

    def batch(self, ids):
        return self.bank, torch.as_tensor(np.asarray(ids), device=self.bank.feats.device)

    def iter_batches(self, id_list: Iterable):
        for ids in id_list:
            yield self.batch(ids)


class StreamingSource:
    """The split on the host; each batch staged as a mini-bank."""

    def __init__(self, stream: StreamingBank):
        self.stream = stream
        self.labels = stream.labels
        self.case_ids = stream.case_ids
        self.num_slides = stream.num_slides
        self.num_clusters = stream.num_clusters
        self.patch_dim = stream.patch_dim

    @property
    def max_patches(self) -> int:
        return self.stream.max_patches

    def batch(self, ids):
        return self.stream.stage(ids)

    def iter_batches(self, id_list: Iterable):
        """The next batch stages on a thread while the device computes."""
        return self.stream.iter_epoch(list(id_list))


def build_sources(data_csv, split_indices: Dict[str, Sequence[str]], streaming: bool = False,
                  device="cpu", dtype: Optional[torch.dtype] = None) -> dict:
    """One source per split, its features in ``dtype`` on ``device`` (the
    engines' compute dtype: a gather and a cast commute)."""
    if not streaming:
        return {name: ResidentSource(build_bank(data_csv, idx).to(device, dtype=dtype))
                for name, idx in split_indices.items()}
    streams = {name: StreamingBank(data_csv, idx, device=device, dtype=dtype)
               for name, idx in split_indices.items()}
    n_max = max(s.max_patches for s in streams.values())
    for s in streams.values():
        s.max_patches = n_max
    return {name: StreamingSource(s) for name, s in streams.items()}
