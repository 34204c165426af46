#!/usr/bin/env python
"""Break down selection's cost: the index computation, a row gather, the
mixup, K1 alone and the full ``select_feats``. (Counterpart of
``scripts/dbg_select.py``.)

At the JAX script's shape, 256 bags (2B views of a MuRCL batch of 128) of
64 slides x 2048 patches, D 512, K 10, feat 1024, bf16, each timed call runs
its piece T = 12 times, as the script's jitted loops do:

  index    ``select_ranks`` (the port's one index computation: each patch's
           slot, from the patch -> cluster tables; the JAX script's
           scatter-free form; its legacy scatter form has no counterpart)
  gather   a plain row gather of the 256 x 1024 rows of one selection
           (``index_select``, shifted by the step as the script shifts them)
  mixup    the port's bag mixup (``mixup_rows``: K6 on the card) of those bags
  compact  K1 alone (``gather_compact``) on one selection's ranks: what
           ``select_feats`` adds to the index computation on the card
  select   the full ``select_feats``: index computation, then K1

The bank and the clusters are drawn as the JAX script draws them
(``np.random.default_rng(0)``); the actions and the mixup draws from a
``torch.Generator`` seeded 1. Times: CUDA events, the median of ``--reps``
timed calls after one warm-up. ``--device cpu`` runs the plain twins at the
``--shape`` given, timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_select               # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_select --device cpu --shape 4 96 32 64 8 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from murcl_tpu_torch.data.bank import bank_from_arrays
from murcl_tpu_torch.ops.compact import gather_compact
from murcl_tpu_torch.ops.mixup import mixup_factors, mixup_rows
from murcl_tpu_torch.ops.select import select_feats, select_ranks
from murcl_tpu_torch.scripts.probes import median_ms, probe_device, where

SHAPE = (64, 2048, 512, 1024, 256, 12)  # slides, patches, D, feat, bags, T
K, ALPHA = 10, 0.9
PIECES = ("index", "gather", "mixup", "compact", "select")


def select_bank(slides: int, patches: int, d: int, dev, labels=None):
    """The JAX script's bank: per slide normal features and uniform cluster
    labels from ``np.random.default_rng(0)``, in bf16 on ``dev``; slide
    labels ``labels`` (zeros by default; the step scripts' ``i % 2``)."""
    rng = np.random.default_rng(0)
    feats, clusters = [], []
    for _ in range(slides):
        feats.append(rng.normal(size=(patches, d)).astype(np.float32))
        a = rng.integers(0, K, size=patches)
        clusters.append([[int(j) for j in np.where(a == c)[0]] for c in range(K)])
    return bank_from_arrays(feats, clusters, labels or [0] * slides).to(dev, torch.bfloat16)


def run(device="cuda:0", shape=SHAPE, reps: int = 5, outs: dict | None = None) -> dict:
    """Prints and returns ``{piece: ms}`` (ms of one timed call: T of the
    piece); ``outs``, where given, receives each piece's output of its last
    step, the bank (``"bank"``), the slide ids (``"ids"``), the actions of
    the last ``select`` step (``"actions"``) and of the first selection,
    whose ranks ``gather``, ``mixup`` and ``compact`` take
    (``"first_actions"``), its rows as ``gather`` takes them, row 0 in an
    empty slot as the JAX script has it (``"x0"``: the mixup's bags), and the
    last mixup's ``(lam, perm)`` (``"mix"``)."""
    dev = probe_device(device)
    slides, patches, d, feat, b, t_steps = shape
    bank = select_bank(slides, patches, d, dev)
    ids = torch.arange(b, device=dev) % slides
    gen = torch.Generator(device=dev).manual_seed(1)
    nump = bank.num_patches[ids]

    def actions():
        return torch.rand(b, K, generator=gen, device=dev)

    a0 = actions()
    ranks0, offs0, _ = select_ranks(ids, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                    a0, bank.patch_cluster, bank.patch_pos, feat)
    # the first selection's rows, slot by slot (row 0 where a slot is empty)
    bag, p = torch.nonzero((ranks0 >= 0) & (torch.arange(ranks0.shape[1], device=dev) <
                                            nump[:, None]), as_tuple=True)
    idx0 = torch.zeros(b, feat, dtype=torch.int64, device=dev)
    idx0[bag, ranks0[bag, p].long()] = offs0[bag] + p
    x0 = bank.feats.index_select(0, idx0.reshape(-1)).reshape(b, feat, d)
    rows = bank.feats.shape[0]
    last = {"first_actions": a0, "x0": x0}

    def index():
        for _ in range(t_steps):
            last["index"] = select_ranks(ids, bank.offsets, bank.num_patches,
                                         bank.cluster_sizes, actions(), bank.patch_cluster,
                                         bank.patch_pos, feat)[0]

    def gather():
        for t in range(t_steps):
            last["gather"] = bank.feats.index_select(0, (idx0 + t).reshape(-1) % rows)

    def mixup():
        for _ in range(t_steps):
            last["mix"] = mixup_factors(gen, b, ALPHA)
            last["mixup"] = mixup_rows(x0, last["mix"][1], last["mix"][0])

    def compact():
        for _ in range(t_steps):
            last["compact"] = gather_compact(bank.feats, offs0, ranks0, feat, nump)

    def select():
        for _ in range(t_steps):
            last["actions"] = actions()
            last["select"] = select_feats(bank, ids, last["actions"], feat)

    print(f"selection breakdown, {b} bags of {slides} slides x {patches} patches -> ({feat}, "
          f"{d}) bf16, K {K}, {t_steps} steps a call, median of {reps} after one warm-up "
          f"({where(dev)})", flush=True)
    out = {}
    for name, fn in zip(PIECES, (index, gather, mixup, compact, select)):
        out[name], _ = median_ms(fn, dev, reps)
        print(f"  {t_steps}x {name:8s}: {out[name]:8.3f} ms", flush=True)
    if outs is not None:
        outs.update(last, bank=bank, ids=ids)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=6, default=list(SHAPE),
                    metavar=("SLIDES", "PATCHES", "D", "FEAT", "BAGS", "T"))
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.reps)
