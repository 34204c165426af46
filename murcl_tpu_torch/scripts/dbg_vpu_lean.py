#!/usr/bin/env python
"""Measure the lean formulation of K2/K3's elementwise chains against the
pre-lean one. (Counterpart of ``scripts/dbg_vpu_lean.py``.)

The production kernels (lean) fold relu, the dropout keep bit and the
``1 / (1 - p)`` scale into one {0, scale} multiplier per element, in the
trunk's and the gates' epilogues and in the backward's dz chain. The
pre-lean kernels (``full`` here, as the JAX script calls them) take relu,
the round, the 0/1 keep and the scale as separate rounded products (the JAX
script's ``make_fwd(False)`` and ``make_bwd("full")``); ``lean2`` is the
production backward with dx's three terms, ``rnd(p gm) + rnd(dza Wa^T) +
rnd(dzb Wb^T)``, taken as one f32 sum (one accumulator) and rounded once
(``csrc/fused_trunk.cu``, kPreLean and kLean2).

Numerics: a product by an exact 1 or 0 is the identity, so pre-lean and
lean give the same values (the forward bitwise, the backward up to its
weight gradients' f32 atomics, whose order changes from run to run); the
pre-lean backward recomputes the forward's xc, where the JAX script's took
it once more in f32 (its ~1e-3 remat ulp). lean2 moves dx's roundings.

At the JAX script's shape, (1536, 1024, 512) -> 512 -> 256, dropout 0.25,
gated, unmixed, on its inputs (``probes.trunk_inputs``), in bfloat16 (the
JAX script's dtype) unless ``--dtype`` says float32 (where lean2 is the
production kernel: its dx has one accumulator already). Times: CUDA events,
the median of ``--reps`` calls after one warm-up; ``--device cpu`` runs the
plain twins at the ``--shape`` given, timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_vpu_lean                  # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_vpu_lean --device cpu --shape 2 64 32 128 128
"""

from __future__ import annotations

import argparse

import torch

from murcl_tpu_torch.ops.attention import fused_trunk_ablate_bwd, fused_trunk_ablate_fwd
from murcl_tpu_torch.scripts.probes import median_ms, probe_device, trunk_inputs, where

SHAPE = (1536, 1024, 512, 512, 256)  # B, N, Fin, L1, D
DROPOUT, SEED = 0.25, 7
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# the JAX script's names -> the port's variants (ops/attention.py)
FWD = {"full": "prelean", "lean": "lean"}
BWD = {"full": "prelean", "lean": "full", "lean2": "lean2"}
GRADS = ("dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc")


def run(device="cuda:0", shape=SHAPE, dtype="bfloat16", reps: int = 5,
        outs: dict | None = None) -> dict:
    """Prints the JAX script's lines; returns ``{"fwd_max_diff": [M, p, s],
    "bwd_rel": {lean, lean2: {grad: rel}}, "ms": {"fwd full", ...}}``.
    ``outs``, where given, receives ``{"fwd full": (M, p, s), ...}``, the
    outputs of each timed kernel's last call."""
    dev = probe_device(device)
    h, w, mask, p, cots = trunk_inputs(shape, DTYPES[dtype], dev)

    def fwd(tag):
        return fused_trunk_ablate_fwd(FWD[tag], h, *w, mask, DROPOUT, SEED)

    def bwd(tag):
        return fused_trunk_ablate_bwd(BWD[tag], h, *w[:7], mask, p, *cots, DROPOUT, SEED)

    out = {"fwd_max_diff": [float((a - b).abs().max()) for a, b in zip(fwd("full"), fwd("lean"))],
           "bwd_rel": {}, "ms": {}}
    print("fwd lean-vs-full max|diff| (expect 0):", out["fwd_max_diff"], flush=True)
    ref = bwd("full")
    for tag in ("lean", "lean2"):
        got = bwd(tag)
        print(f"bwd {tag}-vs-full rel diff (lean: the weight gradients' atomics alone; lean2: "
              "dx rounded once):")
        out["bwd_rel"][tag] = {}
        for nm, x, y in zip(GRADS, ref, got):
            rel = float((x - y).abs().max()) / (float(x.abs().max()) or 1.0)
            out["bwd_rel"][tag][nm] = rel
            print(f"  {nm}: {rel:.3e}", flush=True)
    del ref, got
    print(f"\ntimings, {tuple(shape[:3])} {dtype}, median of {reps} after one warm-up "
          f"({where(dev)})", flush=True)
    for tag, fn in (("fwd full ", lambda: fwd("full")), ("fwd lean ", lambda: fwd("lean")),
                    ("bwd full ", lambda: bwd("full")), ("bwd lean ", lambda: bwd("lean")),
                    ("bwd lean2", lambda: bwd("lean2"))):
        out["ms"][tag.strip()], last = median_ms(fn, dev, reps)
        if outs is not None:
            outs[tag.strip()] = last
        print(f"  {tag}: {out['ms'][tag.strip()]:7.2f} ms", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=5, default=list(SHAPE),
                    metavar=("B", "N", "FIN", "L1", "D"))
    ap.add_argument("--dtype", default="bfloat16", choices=list(DTYPES))
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.dtype, a.reps)
