#!/usr/bin/env python
"""Ablate K3, the fused trunk + attention backward, to attribute its time.
(Counterpart of ``scripts/dbg_bwd_ablate.py``.)

Times K3 directly (no forward in the loop) and ablated copies of it with
passes removed (``ops/attention.py`` ``fused_trunk_ablate_bwd``,
``csrc/fused_trunk.cu`` ``murcl_fused_trunk_bwd_ablate``), gated, unmixed,
without the bags' gradient:

  full        the production kernels (dropout 0.25)
  nodrop      dropout 0 (the keep-bit hash and its products gone)
  nowgrad     both weight-gradient passes skipped: dWf, dWa, dWb zero, and
              with them dbf, dba, dbb (the pass sums the biases too; the JAX
              script kept the bias sums)
  nodx        dx_wg and dWf's pass skipped (dWf, dbf zero); dWa, dWb kept
  recompute   the trunk, the softmax backward and a gate pass that replays
              the gates for u and sums dwc alone: the floor any
              recompute-based backward pays

at the JAX script's shape, (1536, 1024, 512) -> 512 -> 256, in bfloat16
(the JAX script's dtype) and float32 (the CLIs' default), on the JAX
script's inputs (``probes.trunk_inputs``). Times: CUDA events, the median of
``--reps`` calls after one warm-up. ``--device cpu`` runs the plain twins
at the ``--shape`` given, timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_bwd_ablate                # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_bwd_ablate --device cpu --shape 2 64 32 128 128
"""

from __future__ import annotations

import argparse

import torch

from murcl_tpu_torch.ops.attention import fused_trunk_ablate_bwd
from murcl_tpu_torch.scripts.probes import median_ms, probe_device, trunk_inputs, where

SHAPE = (1536, 1024, 512, 512, 256)  # B, N, Fin, L1, D
VARIANTS = ("full", "nodrop", "nowgrad", "nodx", "recompute")
DROPOUT, SEED = 0.25, 7
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def run(device="cuda:0", shape=SHAPE, dtypes=("bfloat16", "float32"), reps: int = 5,
        outs: dict | None = None) -> dict:
    """Prints and returns ``{dtype: {variant: ms}}``; ``outs``, where given,
    receives ``{dtype: {variant: gradients}}`` of each variant's last timed
    call."""
    dev = probe_device(device)
    out = {}
    for name in dtypes:
        h, w, mask, p, cots = trunk_inputs(shape, DTYPES[name], dev)
        print(f"bwd kernel ablation, {tuple(shape[:3])} {name}, median of {reps} after one "
              f"warm-up ({where(dev)})", flush=True)
        out[name] = {}
        for v in VARIANTS:
            out[name][v], grads = median_ms(lambda: fused_trunk_ablate_bwd(
                v, h, *w[:7], mask, p, *cots, DROPOUT, SEED), dev, reps)
            if outs is not None:
                outs.setdefault(name, {})[v] = grads
            print(f"  {v:10s}: {out[name][v]:7.2f} ms", flush=True)
        del h
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=5, default=list(SHAPE),
                    metavar=("B", "N", "FIN", "L1", "D"))
    ap.add_argument("--dtype", nargs="+", default=list(DTYPES), choices=list(DTYPES))
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), tuple(a.dtype), a.reps)
