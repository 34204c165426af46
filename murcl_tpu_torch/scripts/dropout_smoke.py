#!/usr/bin/env python
"""The gated attention pool's in-kernel dropout on the card: deterministic
per seed, and its gradient exact against a rebuild with the kernel's own
masks. (Counterpart of the dropout section of ``scripts/tpu_smoke.py``,
``:77-132``; the rest of that script is ``chip_smoke.py``'s.)

On the JAX script's inputs (``np.random.default_rng(0)``, drawn in its
order: two NT-Xent operands, then ``x (8, 256, 512)``, ``wa``, ``wb``
``(512, 256)`` and ``wc (256,)`` of normals times 0.1, zero biases, f32):

1. K7 (``gated_attention_pool``, gated, dropout 0.25) gives the same M
   twice at seed 7 and another at seed 8;
2. the mask writer (``ops/gate_masks.py``, kernel ``csrc/gate_masks.cu``)
   writes K7's keep masks of gates a and b at seed 3, ``(8, 256, 256)``
   bool; their keep rate is within 0.02 of 0.75;
3. the pool rebuilt in plain f32 arithmetic with those masks (TF32 off),
   ``sum(M^2)``'s gradient for ``wc`` equals K7's at seed 3 within 1e-2
   relative (largest difference over the largest entry).

Runs on ``cuda:0`` unless told otherwise; ``--device cpu`` runs the plain
twins (``gate_keep_masks_plain``, K7's twins) at the ``--shape`` given.

    python -m murcl_tpu_torch.scripts.dropout_smoke                # cuda:0
    python -m murcl_tpu_torch.scripts.dropout_smoke --device cpu --shape 2 64 32 16
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from murcl_tpu_torch.ops.attention import gated_attention_pool
from murcl_tpu_torch.ops.gate_masks import gate_keep_masks
from murcl_tpu_torch.scripts.probes import median_ms, probe_device, where

SHAPE = (8, 256, 512, 256)  # B, N, F, D
RATE, MASK_SEED = 0.25, 3
RATE_TOL, GRAD_TOL = 0.02, 1e-2


def inputs(shape, dev):
    """``(x, wa, ba, wb, bb, wc, bc)`` as ``scripts/tpu_smoke.py`` draws them
    (``:32-47``), in f32 on ``dev``."""
    b, n, f, d = shape
    rng = np.random.default_rng(0)
    rng.normal(size=(128, 128))  # the NT-Xent section's zi and zj
    rng.normal(size=(128, 128))
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    x = t(rng.normal(size=(b, n, f)).astype(np.float32))
    wa = t(rng.normal(size=(f, d)).astype(np.float32) * 0.1)
    wb = t(rng.normal(size=(f, d)).astype(np.float32) * 0.1)
    wc = t(rng.normal(size=(d,)).astype(np.float32) * 0.1)
    zero = torch.zeros(d, device=dev)
    return x, wa, zero, wb, zero.clone(), wc, torch.zeros((), device=dev)


def rebuild_loss(x, wa, ba, wb, bb, wc, bc, ka, kb, rate=RATE):
    """``sum(M^2)`` of the gated pool rebuilt in plain f32 arithmetic with the
    keep masks ``ka``, ``kb`` (``tpu_smoke.py``'s ``xla_loss``)."""
    scale = 1.0 / (1.0 - rate)
    a = torch.tanh(x @ wa + ba)
    g = torch.sigmoid(x @ wb + bb)
    a = torch.where(ka, a * scale, torch.zeros_like(a))
    g = torch.where(kb, g * scale, torch.zeros_like(g))
    s = (a * g) @ wc + bc
    p = torch.softmax(s, dim=-1)
    m = torch.einsum("bn,bnf->bf", p, x)
    return (m * m).sum()


def wc_grad(loss, wc):
    w = wc.detach().clone().requires_grad_(True)
    (g,) = torch.autograd.grad(loss(w), w)
    return g


def run(device="cuda:0", shape=SHAPE, reps: int = 5, outs: dict | None = None) -> dict:
    """Runs the three checks (raising where one fails), prints and returns
    ``{"ms": the mask writer's ms, "keep_rate": (ka's, kb's), "grad_rel":
    ..., "deterministic": True, "seed_sensitive": True}``; ``outs``, where
    given, receives the masks of the last timed call, ``(ka, kb)``."""
    dev = probe_device(device)
    b, n, f, d = shape
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wa, ba, wb, bb, wc, bc = inputs(shape, dev)
    kw = dict(gated=True, dropout=RATE)
    print(f"in-kernel dropout of the gated pool, ({b}, {n}, {f}) -> {d} f32, rate {RATE} "
          f"({where(dev)})", flush=True)
    m1, m2, m3 = (gated_attention_pool(x, wa, ba, wb, bb, wc, bc, seed=sd, **kw)[0]
                  for sd in (7, 7, 8))
    out = {"deterministic": bool(torch.equal(m1, m2)),
           "seed_sensitive": not bool(torch.allclose(m1, m3))}
    if not out["deterministic"]:
        raise AssertionError("dropout not deterministic per seed")
    if not out["seed_sensitive"]:
        raise AssertionError("dropout insensitive to seed")

    out["ms"], (ka, kb) = median_ms(lambda: gate_keep_masks(MASK_SEED, RATE, b, n, d, dev), dev,
                                    reps)
    if outs is not None:
        outs["masks"] = (ka, kb)
    out["keep_rate"] = (float(ka.float().mean()), float(kb.float().mean()))
    if abs(out["keep_rate"][0] - (1 - RATE)) >= RATE_TOL:
        raise AssertionError(f"keep rate {out['keep_rate'][0]} not within {RATE_TOL} of "
                             f"{1 - RATE}")

    g_rebuilt = wc_grad(lambda w: rebuild_loss(x, wa, ba, wb, bb, w, bc, ka, kb), wc)
    g_pool = wc_grad(lambda w: (gated_attention_pool(x, wa, ba, wb, bb, w, bc, seed=MASK_SEED,
                                                     **kw)[0] ** 2).sum(), wc)
    out["grad_rel"] = float((g_rebuilt - g_pool).abs().max()
                            / g_rebuilt.abs().max().clamp_min(1e-6))
    if out["grad_rel"] >= GRAD_TOL:
        raise AssertionError(f"dropout grad mismatch: rel {out['grad_rel']}")
    print("  determinism: M equal at seed 7 twice, differs at seed 8: OK", flush=True)
    print(f"  masks at seed {MASK_SEED}: keep rate {out['keep_rate'][0]:.4f} (a), "
          f"{out['keep_rate'][1]:.4f} (b); writer {out['ms']:.4f} ms", flush=True)
    print(f"  d/dwc of sum(M^2), K7 against the rebuild with its masks: rel "
          f"{out['grad_rel']:.2e} (< {GRAD_TOL}): OK", flush=True)
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=4, default=list(SHAPE),
                    metavar=("B", "N", "F", "D"))
    ap.add_argument("--reps", type=int, default=5)
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.reps)
