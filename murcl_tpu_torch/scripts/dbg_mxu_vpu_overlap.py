#!/usr/bin/env python
"""Does CUDA-core work overlap a warpgroup product in flight on the card?
(Counterpart of ``scripts/dbg_mxu_vpu_overlap.py``.)

K2/K3's epilogues (tanh, sigmoid, the keep bits, the roundings) run on the
CUDA cores between the tensor cores' products of the same tile. If work on
the CUDA cores overlaps an independent product in flight, a kernel that
interleaves two tiles (one warpgroup's gates while the other's products
run: a ping-pong) can hide its epilogues; if the two serialise, it cannot.
Four modes of one kernel (``csrc/wgmma_overlap.cu``, ``ops/overlap.py``)
over the same data:

- ``mxu``:   m = rnd(m @ W) four times (wgmma fed by TMA) — products alone
- ``vpu``:   v = rnd(tanh(v) sigmoid(v)) eight times on y — CUDA cores alone
- ``dep``:   vpu's chain on mxu's m — forced serial
- ``indep``: both, independent: one consumer warpgroup issues the
  products while the other runs the chain on y (the ping-pong's shape)

In every mode the products are one warpgroup's and the chain the other's
(``csrc/wgmma_overlap.cu``), so mxu and vpu time each side alone. Verdict:
overlap iff t(indep) < 0.75 (t(mxu) + t(vpu)) (ideal: the larger of the
two); t(dep) should sit near the sum either way. Also printed: the share of
the shorter side that indep hid, (t(mxu) + t(vpu) - t(indep)) / min(t(mxu),
t(vpu)), 1 where it hid all of it, 0 where the two ran in series.
256 steps of (1024, 512) bf16 tiles x and y, W (512, 512), as the JAX
script; outputs are the per-step f32 column sums of m and v. Times: CUDA events, the median of
``--reps`` calls after one warm-up; ``--device cpu`` runs the plain twins
at the ``--steps`` and ``--rows`` given, timed by the host's clock.

    python -m murcl_tpu_torch.scripts.dbg_mxu_vpu_overlap           # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_mxu_vpu_overlap --device cpu --steps 2 --rows 128
"""

from __future__ import annotations

import argparse

import torch

from murcl_tpu_torch.ops.overlap import MODES, WIDTH, wgmma_overlap
from murcl_tpu_torch.scripts.probes import median_ms, probe_device, where

STEPS, ROWS = 256, 1024


def inputs(dev, steps: int, rows: int, seed: int = 0):
    """x, y (steps, rows, 512) of normals times 0.3 and W (512, 512) of
    normals times 0.05, bf16, drawn on ``dev`` (the JAX script's scales)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *s, sc: (torch.randn(*s, generator=gen, device=dev) * sc).to(  # noqa: E731
        torch.bfloat16)
    return r(steps, rows, WIDTH, sc=0.3), r(steps, rows, WIDTH, sc=0.3), r(WIDTH, WIDTH, sc=0.05)


def verdict(t: dict) -> bool:
    """The JAX script's rule: overlap iff t(indep) < 0.75 (t(mxu) + t(vpu))."""
    return t["indep"] < 0.75 * (t["mxu"] + t["vpu"])


def hidden(t: dict) -> float:
    """The share of the shorter of mxu and vpu that indep hid: 1 all of it,
    0 none (the two in series)."""
    return (t["mxu"] + t["vpu"] - t["indep"]) / min(t["mxu"], t["vpu"])


def run(device="cuda:0", steps: int = STEPS, rows: int = ROWS, reps: int = 5,
        outs: dict | None = None) -> dict:
    """Prints the JAX script's lines; returns ``{mode: ms}`` and the verdict
    under ``"overlap"``. ``outs``, where given, receives ``{mode: (m sums, v
    sums)}`` of each mode's last timed call."""
    dev = probe_device(device)
    x, y, w = inputs(dev, steps, rows)
    print(f"{steps} steps of ({rows}, {WIDTH}) bf16, median of {reps} after one warm-up "
          f"({where(dev)})", flush=True)
    t = {}
    for m in MODES:
        t[m], last = median_ms(lambda: wgmma_overlap(m, x, y, w), dev, reps)
        if outs is not None:
            outs[m] = last
    for m, ms in t.items():
        print(f"{m:6s}: {ms:7.3f} ms")
    print(f"sum(mxu, vpu) = {t['mxu'] + t['vpu']:.3f}  max = {max(t['mxu'], t['vpu']):.3f}")
    print(f"indep hid {hidden(t):.2f} of the shorter side "
          f"({'mxu' if t['mxu'] <= t['vpu'] else 'vpu'})")
    print("verdict:", "OVERLAP (one warpgroup's CUDA-core work ran beside the other's "
          "products: a ping-pong of the warpgroups could hide the epilogues)"
          if verdict(t) else "NO overlap (one warpgroup's CUDA-core work and the other's "
          "products ran in series)", flush=True)
    return {**t, "overlap": verdict(t), "hidden": hidden(t)}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--rows", type=int, default=ROWS, help="rows a step (a multiple of 128 "
                    "on the card)")
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, a.steps, a.rows, a.reps)
