#!/usr/bin/env python
"""Attribute the grouped one-hot compaction kernel's time to its
ragged-window gates, beside K1. (Counterpart of ``scripts/dbg_grouped_gate.py``.)

The TPU's grouped kernel gated its work twice: a chunk-liveness gate (a
chunk of the window starting past the slide's patch count is neither read
nor worked) and a per-tile predicate ``tile_start < nump``. On the card
(``csrc/compact_onehot.cu``, variants in ``ops/compact_probes.py`` ``GATE``)
the first is the loop bound of the chunks, the producer's and the
consumers', and the second a branch around a tile's work. GROUP 4, chunks
of 16 tiles:

  copy      both gates
  nolive    the per-tile branch only
  noinner   the chunks' loop bound only
  nogate    neither (the ablation's chunk16)

at the JAX script's shape, 128 slides x 12 repeats of 2048-row windows, D
512, FEAT 1024, bf16, on its inputs (``probes.compact_inputs``; every window
whole, so the gates skip nothing), with K1 on the same inputs. Every
variant keeps the result and is checked bitwise against K1's plain twin on
the first 8 bags before it is timed. Times: CUDA events, the median of
``--reps`` calls after one warm-up. ``--device cpu`` runs the plain twins
at the ``--shape`` given, timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_grouped_gate               # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_grouped_gate --device cpu --shape 2 4 512 64 384
"""

from __future__ import annotations

import argparse

from murcl_tpu_torch.ops.compact_probes import GATE
from murcl_tpu_torch.scripts.dbg_grouped_ablate import SHAPE, grouped_run

VARIANTS = tuple(GATE)


def run(device="cuda:0", shape=SHAPE, reps: int = 5, outs: dict | None = None) -> dict:
    """Prints and returns ``{"production": ms, variant: ms}``; ``outs``,
    where given, receives each variant's output of its last timed call and
    the inputs, under ``"inputs"``: ``(bank, offs, ranks, nump)``."""
    return grouped_run("gate", VARIANTS, "grouped one-hot compaction gates", device, shape,
                       reps, outs)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=5, default=list(SHAPE),
                    metavar=("S", "REPEAT", "NMAX", "D", "FEAT"))
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.reps)
