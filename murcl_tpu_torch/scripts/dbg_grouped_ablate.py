#!/usr/bin/env python
"""Attribute the slide-grouped one-hot compaction kernel's time, beside K1.
(Counterpart of ``scripts/dbg_grouped_ablate.py``.)

The TPU's grouped compaction read each slide's window once for GROUP bags
of that slide (the engines' repeat layout) and built each bag by a banded
one-hot product per 128-row tile; the port's K1 (``ops/compact.py``) is a
row copy whose reuse of a slide's rows across its bags comes from L2. This
script times the grouped one-hot formulation on the card
(``csrc/compact_onehot.cu``, variants in ``ops/compact_probes.py``
``GROUPED``), GROUP 4, no gate, with parts taken out, and K1 on the same
inputs:

  full      the grouped formulation (band, tile 128, chunks of 8 tiles, the
            bf16 output band the accumulator)
  dmafloor  each group's window read once and its first FEAT rows written
            to the group's 4 bags only
  normw     the slab's product stored, not added (another result)
  noonehot  a constant slab reused for every tile: no compare (another
            result)
  leanoh    the tile's ones scattered into a zeroed slab, no compare
  chunk16   whole-window chunks (16 tiles); here the loop's blocking only

at the JAX script's shape, 128 slides x 12 repeats of 2048-row windows, D
512, FEAT 1024, bf16, on its inputs (``probes.compact_inputs``). The
variants that keep the result are checked bitwise against K1's plain twin
on the first 8 bags before they are timed. Every variant must build and
run (the JAX script printed FAILED and went on; here a failure is an
error). Times: CUDA events, the median of ``--reps`` calls after one
warm-up. ``--device cpu`` runs the plain twins at the ``--shape`` given,
timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_grouped_ablate               # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_grouped_ablate --device cpu --shape 2 4 512 64 384
"""

from __future__ import annotations

import argparse

import torch

from murcl_tpu_torch.ops.compact import gather_compact, gather_compact_plain
from murcl_tpu_torch.ops.compact_probes import GROUPED, KEEPS_RESULT, onehot_compact
from murcl_tpu_torch.scripts.probes import compact_inputs, median_ms, probe_device, where

SHAPE = (128, 12, 2048, 512, 1024)  # S, REPEAT, NMAX, D, FEAT
GROUP = 4
VARIANTS = tuple(GROUPED)
CHECKED = 8  # bags held against K1's twin before a variant is timed


def grouped_run(script: str, variants, title: str, device, shape, reps, outs) -> dict:
    """The grouped scripts' body: K1, then each of ``variants`` of probe
    script ``script`` (``ops/compact_probes.py`` ``PROBES``), printed and
    returned as ``{"production": ms, variant: ms}``; ``outs`` as in
    :func:`run`."""
    dev = probe_device(device)
    s, repeat, nmax, d, feat = shape
    if repeat % GROUP:
        raise ValueError(f"{script}: REPEAT {repeat} is not a multiple of GROUP {GROUP}")
    b = s * repeat
    bank, offs, ranks, nump = compact_inputs(b, nmax, d, feat, dev, slides=s)
    if outs is not None:
        outs["inputs"] = (bank, offs, ranks, nump)
    print(f"{title}, {s} slides x {repeat} repeats ({b}, {nmax} -> {feat}, {d}) bf16, group "
          f"{GROUP}, median of {reps} after one warm-up ({where(dev)})", flush=True)
    want = gather_compact_plain(bank, offs[:CHECKED], ranks[:CHECKED], feat, nump[:CHECKED])
    out = {}
    out["production"], _ = median_ms(lambda: gather_compact(bank, offs, ranks, feat, nump), dev,
                                     reps)
    print(f"  {'production (K1)':22s}: {out['production']:7.3f} ms", flush=True)
    for v in variants:
        fn = lambda: onehot_compact(script, v, bank, offs, ranks, feat, nump, s)  # noqa: E731
        note = ""
        if (script, v) in KEEPS_RESULT:
            ok = torch.equal(fn()[:CHECKED], want)
            note = f"   golden-exact: {ok}"
            if not ok:
                raise AssertionError(f"{v} diverged from K1's twin")
        out[v], got = median_ms(fn, dev, reps)
        if outs is not None:
            outs[v] = got
        print(f"  {v:22s}: {out[v]:7.3f} ms{note}", flush=True)
    return out


def run(device="cuda:0", shape=SHAPE, reps: int = 5, outs: dict | None = None) -> dict:
    """Prints and returns ``{"production": ms, variant: ms}``; ``outs``,
    where given, receives each variant's output of its last timed call and
    the inputs, under ``"inputs"``: ``(bank, offs, ranks, nump)``."""
    return grouped_run("grouped", VARIANTS, "grouped one-hot compaction ablation", device,
                       shape, reps, outs)


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
