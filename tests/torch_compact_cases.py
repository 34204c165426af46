"""Compaction inputs for the cases K1's tile design must get right
(``tests/test_torch_select.py`` against JAX's golden on the CPU,
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` against the plain twin on
the card). This module imports no ``jax``.

Each case is drawn from ``np.random.default_rng(seed)``: a bank of ``slides``
windows of ``nmax`` rows each (and one spare window, so that every window of
``nmax`` rows lies inside it, as JAX's ``dynamic_slice`` needs), each bag's
window, its ranks and its ``num_patches``:

- ``ragged``: feat 1000, so the kernel's last tile of a slice is partial;
- ``rows400``: D 100 (400-byte rows in f32, 200 in bf16);
- ``nump``: nmax 4096 and ``num_patches`` below it, with ranks past
  ``num_patches`` that the function must ignore;
- ``empty``: bags with no live rank (all -1, and ``num_patches`` 0);
- ``full``: every slot live, the ranks a random permutation of the slots.

``golden_ranks`` gives the ranks JAX's ``gather_compact_xla`` (which has no
``num_patches``) takes for the same function: -1 past ``num_patches``.
"""

from __future__ import annotations

import numpy as np

CASES = ("ragged", "rows400", "nump", "empty", "full")


def compact_case(name: str, d: int = 32, bags: int = 6, seed: int = 0):
    """``(bank (P, D) f32, offs (B,) int64, ranks (B, nmax) int32, nump (B,)
    int64, feat)`` as numpy arrays; ``d`` is the row width but for
    ``rows400`` (100)."""
    rng = np.random.default_rng(seed)
    feat, nmax = {"ragged": (1000, 2048), "rows400": (256, 512), "nump": (1024, 4096),
                  "empty": (128, 512), "full": (1024, 1024)}[name]
    if name == "rows400":
        d = 100
    slides = max(2, bags // 2)
    bank = rng.normal(size=((slides + 1) * nmax, d)).astype(np.float32)
    offs = rng.integers(0, slides + 1, size=bags).astype(np.int64) * nmax
    nump = np.full(bags, nmax, np.int64)
    if name == "full":
        ranks = np.stack([rng.permutation(feat) for _ in range(bags)]).astype(np.int32)
    else:
        sel = rng.random((bags, nmax)) < min(1.0, 1.1 * feat / nmax)
        ranks = np.where(sel, np.cumsum(sel, axis=1) - 1, -1)
        ranks = np.where(ranks >= feat, -1, ranks).astype(np.int32)
    if name == "nump":
        nump = rng.integers(nmax // 4, nmax, size=bags).astype(np.int64)
        nump[0] = nmax
    if name == "empty":
        ranks[0] = -1
        nump[1] = 0
    return bank, offs, ranks, nump, feat


def golden_ranks(ranks, nump):
    """The ranks with every patch at or past ``num_patches`` unselected."""
    p = np.arange(ranks.shape[1])[None, :]
    return np.where(p < nump[:, None], ranks, -1).astype(np.int32)
