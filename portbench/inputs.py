"""What a run feeds both sides, made from ``--seed``: the feature bank and
the weights on the device, the slide ids of each step, and the checked
steps' random draws.

- The bank: ``slides`` slides whose patch counts are the same evenly spaced
  set from ``patches_min`` to ``patches_max`` for every seed, in an order
  drawn from it; normal features and uniform cluster labels over K, drawn
  on the device by a ``torch.Generator`` there in a few large calls. A
  patch's position in its cluster is its rank among the slide's patches of
  that cluster (the order k-means lists them in).
- The weights: one normal draw on the device for every leaf of the
  aggregator, the GRU head and the policy, scaled by
  :func:`~portbench.reference.model.init_scale`; the program loads them by
  name, the reference keeps the benchmark's copy.
- The slide ids: epochs of ``slides * data_repeat`` ids, one shuffled order
  consumed with wraparound, in full batches (the drivers' feed).
- The checked steps' draws (the actions, the mixing factors and
  permutations, stage 3's policy noise) on the host, as the engine draws
  them, and the dropout seeds the engine draws from each step's generator.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Iterator

import numpy as np
import torch

from portbench.reference.model import (aggregator_leaves, head_leaves, init_scale,
                                       policy_leaves)
from portbench.reference.step import Bank

# the purposes a run derives its generators' seeds for
_BANK, _WEIGHTS, _IDS, _DRAWS, _STEP, _WINDOW = range(6)


def derived_seed(seed: int, *tag: int) -> int:
    """A 63-bit seed for one purpose of run ``seed`` (any whole number)."""
    words = np.random.SeedSequence([seed % 2 ** 64, *tag]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def patch_counts(traffic: dict, seed: int) -> np.ndarray:
    b = traffic["bank"]
    counts = np.rint(np.linspace(b["patches_min"], b["patches_max"], b["slides"])).astype(np.int64)
    return np.random.default_rng(derived_seed(seed, _BANK)).permutation(counts)


def make_bank(traffic: dict, dim: int, seed: int, device) -> Bank:
    """The feature bank on ``device``."""
    k = traffic["num_clusters"]
    counts = torch.as_tensor(patch_counts(traffic, seed), device=device)
    n_max, total = int(counts.max()), int(counts.sum())
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _BANK))
    feats = torch.randn((total, dim), generator=gen, device=device)
    labels = torch.randint(0, k, (len(counts), n_max), generator=gen, device=device)
    live = torch.arange(n_max, device=device)[None, :] < counts[:, None]
    onehot = (labels[..., None] == torch.arange(k, device=device)) & live[..., None]
    ranks = onehot.to(torch.int32).cumsum(1)
    pos = torch.where(live, ranks.gather(2, labels[..., None])[..., 0].to(torch.int64) - 1, -1)
    return Bank(feats=feats, offsets=torch.cumsum(counts, 0) - counts, num_patches=counts,
                cluster_sizes=onehot.sum(1).to(torch.int64),
                patch_cluster=torch.where(live, labels, 0), patch_pos=pos)


def make_weights(cfg: dict, traffic: dict, seed: int, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """``{"model": .., "fc": .., "policy": ..}``, each leaf by name, views of
    one draw (the policy only for the stages that use it)."""
    groups = {"model": aggregator_leaves(cfg), "fc": head_leaves(cfg)}
    if traffic["stage"] != 1:
        groups["policy"] = policy_leaves(cfg, traffic["num_clusters"])
    leaves = [(g, n, s) for g, ls in groups.items() for n, s in ls]
    sizes = [int(np.prod(s)) for _, _, s in leaves]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, _WEIGHTS))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    scale = torch.tensor([init_scale(s) for _, _, s in leaves], device=device)
    flat *= scale.repeat_interleave(torch.tensor(sizes, device=device))
    out: Dict[str, Dict[str, torch.Tensor]] = {g: {} for g in groups}
    for (g, n, s), part in zip(leaves, flat.split(sizes)):
        out[g][n] = part.view(s)
    return out


def id_batches(traffic: dict, seed: int) -> Iterator[np.ndarray]:
    """Slide ids of every step, epoch after epoch, without end."""
    rng = np.random.default_rng(derived_seed(seed, _IDS))
    n, b = traffic["bank"]["slides"], traffic["batch"]
    num_data = n * traffic["data_repeat"]
    while True:
        seq = rng.permutation(n)[np.arange(num_data) % n]
        for i in range(num_data // b):
            yield seq[i * b:(i + 1) * b].astype(np.int64)


def forwards_per_step(cfg: dict, traffic: dict) -> int:
    """Aggregator calls a step makes; each draws one dropout seed where the
    aggregator has dropout."""
    return 1 if traffic["stage"] == 1 else traffic["T"]


def checked_draws(cfg: dict, traffic: dict, seed: int, step: int, ids) -> SimpleNamespace:
    """The draws of checked step ``step``: those the engine takes as
    arguments (``program``, keyword arguments of ``train_step``), the step
    generator's seed, and the dropout seeds that generator then yields (one
    ``randint(0, 2**31 - 1)`` per aggregator call), the draws the engine
    takes from it."""
    t, b, k = traffic["T"], traffic["batch"], traffic["num_clusters"]
    gen = torch.Generator().manual_seed(derived_seed(seed, _DRAWS, step))
    lams = traffic["alpha"] + torch.rand((2 * t, b), generator=gen) * (1.0 - traffic["alpha"])
    perms = torch.stack([torch.randperm(b, generator=gen) for _ in range(2 * t)])
    gen_seed = derived_seed(seed, _STEP, step)
    seeds = []
    if cfg.get("dropout", 0) > 0:
        g = torch.Generator().manual_seed(gen_seed)
        seeds = [int(torch.randint(0, 2 ** 31 - 1, (), generator=g))
                 for _ in range(forwards_per_step(cfg, traffic))]
    d = SimpleNamespace(ids=torch.as_tensor(ids), lams=lams, perms=perms, seeds=seeds,
                        gen_seed=gen_seed)
    if traffic["stage"] == 1:
        d.actions = torch.rand((t, 2, b, k), generator=gen)
        d.program = {"actions": d.actions, "mix": (lams, perms)}
    else:
        d.actions0 = torch.rand((2, b, k), generator=gen)
        d.noise = torch.randn((t - 1, 2, b, k), generator=gen)
        d.lams, d.perms = lams.view(t, 2, b), perms.view(t, 2, b)
        d.program = {"actions0": d.actions0, "noise": d.noise, "mix": (d.lams, d.perms)}
    return d


def window_generator(seed: int) -> torch.Generator:
    """The generator the window's steps draw from (on the host, as the
    drivers' is)."""
    return torch.Generator().manual_seed(derived_seed(seed, _WINDOW))
