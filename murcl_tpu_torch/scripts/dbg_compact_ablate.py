#!/usr/bin/env python
"""Ablate the one-hot compaction kernel to attribute its time, beside K1.
(Counterpart of ``scripts/dbg_compact_ablate.py``.)

The TPU's compaction built each sub-bag as a banded one-hot product per
128-row tile of the slide's window; the port's K1 (``ops/compact.py``,
``csrc/compact.cu``) is a row copy. This script times the one-hot
formulation on the card (``csrc/compact_onehot.cu``, variants in
``ops/compact_probes.py`` ``COMPACT``), one bag per block, with parts taken
out, and K1 on the same inputs:

  full      the one-hot formulation (band, tile 128, an f32 accumulator)
  dmafloor  the window's rows read and the first FEAT rows written only
  normw     the slab's product stored, not added (another result)
  bf16acc   a bf16 accumulator (exact: each slot gets one nonzero term)
  leanoh    the tile's ones scattered into a zeroed slab, no compare of
            all 256 x 128 entries (the TPU's rebased compare)
  bf16lean  bf16acc and leanoh

at the JAX script's shape, 1536 bags of 2048-row windows, D 512, FEAT 1024,
bf16, on its inputs (``probes.compact_inputs``). The variants that keep the
result are checked bitwise against K1's plain twin on the first 4 bags
before they are timed. Times: CUDA events, the median of ``--reps`` calls
after one warm-up. ``--device cpu`` runs the plain twins at the ``--shape``
given, timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_compact_ablate               # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_compact_ablate --device cpu --shape 8 512 64 384
"""

from __future__ import annotations

import argparse

import torch

from murcl_tpu_torch.ops.compact import gather_compact, gather_compact_plain
from murcl_tpu_torch.ops.compact_probes import COMPACT, KEEPS_RESULT, onehot_compact
from murcl_tpu_torch.scripts.probes import compact_inputs, median_ms, probe_device, where

SHAPE = (1536, 2048, 512, 1024)  # B, NMAX, D, FEAT
VARIANTS = tuple(COMPACT)
CHECKED = 4  # bags held against K1's twin before a variant is timed


def run(device="cuda:0", shape=SHAPE, reps: int = 5, outs: dict | None = None) -> dict:
    """Prints and returns ``{"production": ms, variant: ms}``; ``outs``,
    where given, receives each variant's output of its last timed call and
    the inputs, under ``"inputs"``: ``(bank, offs, ranks, nump)``."""
    dev = probe_device(device)
    b, nmax, d, feat = shape
    bank, offs, ranks, nump = compact_inputs(b, nmax, d, feat, dev)
    if outs is not None:
        outs["inputs"] = (bank, offs, ranks, nump)
    print(f"one-hot compaction ablation, ({b}, {nmax} -> {feat}, {d}) bf16, median of {reps} "
          f"after one warm-up ({where(dev)})", flush=True)
    want = gather_compact_plain(bank, offs[:CHECKED], ranks[:CHECKED], feat, nump[:CHECKED])
    out = {}
    out["production"], _ = median_ms(lambda: gather_compact(bank, offs, ranks, feat, nump), dev,
                                     reps)
    print(f"  {'production (K1)':17s}: {out['production']:7.3f} ms", flush=True)
    for v in VARIANTS:
        fn = lambda: onehot_compact("compact", v, bank, offs, ranks, feat, nump)  # noqa: E731
        note = ""
        if ("compact", v) in KEEPS_RESULT:
            ok = torch.equal(fn()[:CHECKED], want)
            note = f"   golden-exact: {ok}"
            if not ok:
                raise AssertionError(f"{v} diverged from K1's twin")
        out[v], got = median_ms(fn, dev, reps)
        if outs is not None:
            outs[v] = got
        print(f"  {v:17s}: {out[v]:7.3f} ms{note}", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=4, default=list(SHAPE),
                    metavar=("B", "NMAX", "D", "FEAT"))
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.reps)
