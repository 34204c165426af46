"""Attribute the pretraining step's time: the full step against its pieces.
(Counterpart of ``scripts/dbg_step.py``.)

At the JAX script's shape (``profile_step``'s build: CLAM_SB bf16, batch
128 of 64 slides x 2048 patches x 512, feat_size 1024, T 6, K 10), four
pieces, each timed as the JAX script's ``timed`` times its jitted loops:
one warm-up call, one more and a synchronisation, then ``--k`` calls back
to back and one synchronisation, the mean per call (CUDA events around the
loop on the card, the host's clock on the CPU):

  (a) full    the stage-1 step: zero_grad, ``rollout_batched``, backward,
              Adam (``ContrastiveEngine.train_step``; the weights move at
              each call, where the JAX script's functional step repeats one)
  (b) fwd     ``rollout_batched`` in train mode under ``torch.no_grad()``
  (c) select  T x (``select_feats`` of 2B bags at uniform actions, then each
              half mixed at alpha 0.9 by ``mixup_factors`` + ``mixup_rows``),
              summing ``x[0, 0]`` of both halves as the JAX loop does
  (d) fused   T x ``fused_trunk_attention_pool`` (K2) on a normal (2B, feat,
              D) bf16 bag with the model's own weights, gated, dropout 0.25,
              seed 3 + t

Each call reseeds its generator, so that every timed call repeats the same
draws, as the JAX loop reuses one key: (a) and (b) a CPU generator seeded 1
(the engine's), (c) a generator on the device seeded 2; (d)'s bag is drawn
once from a generator on the device seeded 0 (the JAX script continues its
numpy generator there). The script also prints (a) as one call then a
synchronisation (the second call's time), so that the back-to-back gain, if
any, shows.

    python -m murcl_tpu_torch.scripts.dbg_step               # cuda:0
    python -m murcl_tpu_torch.scripts.dbg_step --device cpu --shape 4 96 32 64 8 2
"""

from __future__ import annotations

import argparse
import time

import torch

from murcl_tpu_torch.ops.attention import fused_trunk_attention_pool
from murcl_tpu_torch.ops.mixup import mixup_factors, mixup_rows
from murcl_tpu_torch.ops.select import select_feats
from murcl_tpu_torch.scripts.dbg_select import ALPHA, K
from murcl_tpu_torch.scripts.probes import probe_device, where
from murcl_tpu_torch.scripts.profile_step import SHAPE, build_step, sync

PIECES = ("full", "fwd", "select", "fused")


def timed(fn, dev, k: int = 8):
    """The JAX script's ``timed``: ``(mean ms of k calls back to back, ms of
    the one synchronised call before them, last output)``."""
    fn()
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    one = (time.perf_counter() - t0) * 1e3
    if dev.type == "cuda":
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(k):
            out = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / k, one, out
    t0 = time.perf_counter()
    for _ in range(k):
        out = fn()
    return (time.perf_counter() - t0) * 1e3 / k, one, out


def trunk_weights(model):
    """CLAM's trunk and gates as ``fused_trunk_attention_pool`` takes them:
    ``(wf, bf, wa, ba, wb, bb, wc, bc)``."""
    trunk = model.encoder.attention_net[0]
    return (trunk.weight.t(), trunk.bias, *model.encoder.attention_net[3].gates())


def fused_forwards(x, weights, t_steps: int, dropout: float = 0.25, seed: int = 3):
    """(d): T calls of the fused forward on ``x``, seed ``seed + t``:
    ``(sum of M[0] over the calls, the last call's (M, p, s))``."""
    acc, out = 0.0, None
    for t in range(t_steps):
        out = fused_trunk_attention_pool(x, *weights, dropout=dropout, seed=seed + t, gated=True)
        acc = acc + out[0][0].float().sum()
    return acc, out


def run(device="cuda:0", shape=SHAPE, k: int = 8, outs: dict | None = None) -> dict:
    """Prints the JAX script's four lines and (a) as one synchronised call;
    returns ``{piece: ms per call back to back}`` with ``full_one_ms``.
    ``outs``, where given, receives the losses of (a) and (b) (``"losses"``,
    the last call's each), the bank and ids, the last selection of (c) and
    its actions (``"select"``, ``"actions"``), and (d)'s bag, weights, their
    model and its last output (``"x"``, ``"weights"``, ``"model"``,
    ``"fused"``)."""
    dev = probe_device(device)
    slides, patches, d, feat, b, t_steps = shape
    s = build_step(dev, shape, stage=1)
    eng, bank, ids = s.engine, s.bank, s.ids
    both = torch.cat([ids, ids])
    last = {}

    def full():
        return s.step(1).loss

    def fwd():
        eng.model.train()
        eng.fc.train()
        with torch.no_grad():
            return eng.rollout_batched(bank, ids, torch.Generator().manual_seed(1))[0]

    def select():
        gen = torch.Generator(device=dev).manual_seed(2)
        acc = torch.zeros((), device=dev)
        for _ in range(t_steps):
            a = torch.rand(2 * b, K, generator=gen, device=dev)
            x2 = select_feats(bank, both, a, feat)
            halves = []
            for h in (x2[:b], x2[b:]):
                lam, perm = mixup_factors(gen, b, ALPHA)
                halves.append(mixup_rows(h, perm, lam))
            acc = acc + halves[0][0, 0].float().sum() + halves[1][0, 0].float().sum()
        last.update(actions=a, select=x2)
        return acc

    x = torch.randn(2 * b, feat, d, generator=torch.Generator(device=dev).manual_seed(0),
                    device=dev).to(torch.bfloat16)
    weights = trunk_weights(eng.model)

    def fused():
        with torch.no_grad():
            acc, last["fused"] = fused_forwards(x, weights, t_steps)
        return acc

    print(f"step attribution, CLAM_SB bf16, batch {b} of {slides} slides x {patches} patches x "
          f"{d}, feat_size {feat}, T {t_steps}; {k} calls back to back and one sync, mean per "
          f"call ({where(dev)})", flush=True)
    res, losses = {}, {}
    for name, fn in zip(PIECES, (full, fwd, select, fused)):
        res[name], one, out = timed(fn, dev, k)
        if name == "full":
            res["full_one_ms"] = one
        if name in ("full", "fwd"):
            losses[name] = float(out)
    print(f"full train step:        {res['full']:8.1f} ms")
    print(f"forward-only rollout:   {res['fwd']:8.1f} ms  (backward ~ "
          f"{res['full'] - res['fwd']:.1f})")
    print(f"{2 * t_steps}x selection+mixup:    {res['select']:8.1f} ms")
    print(f"{t_steps}x fused fwd kernel 2B: {res['fused']:8.1f} ms")
    print(f"full train step, one call then a sync: {res['full_one_ms']:.1f} ms (back to back "
          f"{res['full']:.1f}); losses: full {losses['full']:.4f}, forward {losses['fwd']:.4f}")
    if outs is not None:
        outs.update(last, losses=losses, bank=bank, ids=ids, x=x, weights=weights,
                    model=eng.model)
    return res


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--device", default="cuda:0", help="cuda:N, or cpu (the plain twins)")
    ap.add_argument("--shape", type=int, nargs=6, default=list(SHAPE),
                    metavar=("SLIDES", "PATCHES", "D", "FEAT", "BATCH", "T"))
    ap.add_argument("--k", type=int, default=8, help="calls back to back")
    return ap.parse_args(argv)


if __name__ == "__main__":
    a = parse_args()
    run(a.device, tuple(a.shape), a.k)
