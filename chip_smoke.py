#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``murcl_tpu_torch``) on one GPU.

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from ``murcl_tpu_torch/csrc`` (one nvcc
   per source, in parallel), and reads the library's SASS with
   ``cuobjdump``: the bf16 K2/K3 and K7 kernels and both instantiations of
   K8's kernel must hold tensor-core instructions (HMMA or HGMMA).
3. Holds each kernel against its plain PyTorch twin on the card at the
   paths' per-bag shapes, and times both at the full shapes:
   K1 compaction bitwise (f32, bf16) at the MuRCL stage-1 shape (one block
   per bag) and at the supervised per-step shape (64 distinct slides, the
   JAX package's K5; each bag's slots split over slot slices), both timed;
   K6 mixup bitwise in bf16 at (1536, 1024, 512) and in f32 at (192, 1024,
   512); K4 NT-Xent loss, residual and grads <= 1e-5 at (128, 128), (256,
   128) and (128, 100) x 2 f32, with and without a zero row, K4's loss and
   dz bitwise in two runs, K4 timed by event and by device time beside its
   plain pair; K2/K3 fused trunk +
   attention (gated and mixed; ungated; gated and ungated with the bags'
   gradient dh) and K7 attention pool (gated and ungated at D 256; gated at
   D 384 in bf16; gated at D 256 on bags of 1000 rows, not a multiple of
   the 64-row tile; ABMIL's mode, ungated at D 128, at dropout 0 only)
   relative Frobenius error <= 1e-4 in f32 and <= 2e-2 in bf16 at dropout 0
   and 0.25, with the kernels' keep rates within 1% of 0.75; K2 and K3
   timed gated and ungated, K3 also unmixed with and without dh, K7 at the
   supervised shape and in ABMIL's mode at (1536, 1024, 512), each beside
   its plain twin and its bound; K2's, K3's and K7's timed calls split by
   sub-kernel (forward trunk or gates, and pool; backward trunk, dp, gates,
   dx and each weight-gradient contraction) with torch.profiler; K3 (with
   dh) and K7b run twice on the same inputs, the largest difference per
   output printed (the split-K weight gradients add with atomics; dh and
   K7's dx must be bitwise equal). K8 (the streaming attention pool, on
   the tensor cores; in f32 three bf16 products per product) at the
   heatmap's largest bag (1, 60416, 512) f32 gated with a masked tail and
   at (4, 12288, 512) gated and ungated in f32 and bf16 (a bag ending
   mid-tile, one with whole masked chunks), relative Frobenius error <=
   1e-4 in f32 and <= 2e-2 in bf16; one backward through its op (K7b) at
   (1, 60416, 512) f32 within 1e-4 of the plain backward, timed; K8 timed
   at (1, 60416, 512) and (1, 12288, 512) f32 and (1, 60416, 512) bf16
   beside its twin, its bound and the FMA tiles' old bound, split by
   sub-kernel, and failing unless faster than the twin in f32.
4. Drives the paths on one synthetic dataset of 192 slides x 2048 patches
   (dim 512, K 10), every launch count set to 0 before a stage and read
   after it:
   - MuRCL pretraining, ``murcl_tpu_torch.drivers.murcl.run``, stages 1 ->
     2 -> 3 for CLAM_SB and then for ABMIL, batch 128, feat_size 1024, T 6,
     bf16, on 64 slides: stage 1 one epoch of 5 steps (CLAM_SB) or 2 steps
     (ABMIL), stages 2 and 3 one epoch of 1 step (stage 2 one PPO epoch).
     Per stage a finite loss, the checkpoints (with the policy at stages 2
     and 3) and the kernels: CLAM_SB launches K1, K2 and K4f in every stage
     and K3 and K4b in stages 1 and 3 only; ABMIL launches K1, K7f and K4f
     in every stage, K6 in stage 1 only, K7b and K4b in stages 1 and 3
     only, and never K2 or K3. Then one ABMIL stage-1 step through the
     kernels and through their plain twins, from the same weights and
     draws: step losses and gradients compared, and an optimizer step must
     move every weight with a gradient (``abmil_step_check``);
   - full-slide heatmaps, ``murcl_tpu_torch.preprocess.heatmaps.run_heatmaps``,
     from the CLAM_SB stage-3 ``model_best`` over 3 slides of 2,000, 12,000
     and 60,000 patches (dim 512, f32, a 300 x 200 grid of 4-pixel patches
     on a 1,200 x 800 slide held in memory): K2's forward once and K8 twice,
     nothing else; one PNG of the thumbnail's shape per slide; the scores
     equal to those through the plain twins within 1e-4; per slide the
     load, score, paint and write times;
   - supervised RLMIL, ``murcl_tpu_torch.drivers.rlmil.run``, finetune
     stages 1 -> 2 -> 3 from the CLAM_SB MuRCL stage-3 ``model_best`` on
     128 / 32 / 32 slides, batch 64, feat_size 1024, T 6, bf16, one epoch
     each (2 steps; stage 2 one PPO epoch): finite losses, each stage's
     checkpoints (with the policy in stages 2 and 3), ``pred.csv`` and
     ``final_res.csv``; compaction and K7f launched in every stage, K7b in
     stages 1 and 3 and not in stage 2.
5. Times steady steps: supervised at batch 64 (stage 3, then stage 1), and
   MuRCL CLAM_SB stage 1 (the ``bench.py`` step), ABMIL stage 1 and CLAM_SB
   stage 3 at batch 128: 2 warm-up steps,
   then a host clock around 5 synchronised steps, read also when the step
   call returns (the host's enqueue time); then ``torch.profiler``
   traces 3 more steps of each and prints device time by kernel and the
   device's busy share.

Every kernel's row carries its bound at the timed shape (``bound``: the
larger of its operations at the published H100 SXM peak for their type and
its bytes at 3.35 TB/s). Prints the kernel table as one JSON line, the card
line, and as its last
line ``{"ok": true, "device": {...}}``. Any failure exits nonzero before
that line. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
B_MAIN, N_MAIN, FIN, L1, D, T, K, BATCH = 1536, 1024, 512, 512, 256, 6, 10, 128
SLIDES, PATCHES = 64, 2048
CHECK_BAGS = 192  # bags in the K2/K3 comparisons
RL_BATCH, RL_SPLITS = 64, (128, 32, 32)  # supervised batch; train / valid / test slides
POOL_BAGS = T * RL_BATCH  # K7's bags in a supervised stage-1 step
POOL_CHECK_BAGS = 48  # bags in the K7 comparisons
ABMIL_D, CLAM_BIG_D = 128, 384  # ABMIL's attention width (MuRCL's --D); CLAM "big"
TAIL_N = 1000  # K7's row-tail check: bags of N rows, not a multiple of 64
# the heatmap path: slides of these many patches on a 300 x 200 grid of
# 4-pixel patches (a 1,200 x 800 single-level slide), padded to multiples
# of BUCKET; K8's checks at the largest padded bag and at (4, 12288)
HEAT_SLIDES, HEAT_GRID, HEAT_PATCH, BUCKET = (2000, 12000, 60000), (300, 200), 4, 512
K8_MAIN, K8_CHECK = (1, 60416), (4, 12288)
# published H100 SXM peaks: HBM bytes/s, f32 outside the tensor cores, bf16,
# and TF32 (the tensor cores' fastest rate for f32 operands)
HBM_BPS, F32_FLOPS, BF16_FLOPS, TF32_FLOPS = 3.35e12, 67e12, 989e12, 495e12


def bound(flops: float, nbytes: float, peak: float):
    """``(ms, side)``: the larger of the operations over their type's peak
    rate and the bytes (each input read once, each output written once)
    over HBM's rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / HBM_BPS * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(a, b) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def run_fused(h, w, mask, dropout, seed, mix, cots, gated=True, need_dh=False):
    """Kernels K2 + K3 through the op's autograd: ``(M, p, s, *8 grads[, dh])``."""
    import torch

    from murcl_tpu_torch.ops.attention import fused_trunk_attention_pool

    hg = h.detach().clone().requires_grad_(need_dh)
    ws = [x.detach().clone().requires_grad_(True) for x in w]
    outs = fused_trunk_attention_pool(hg, *ws, mask=mask, dropout=dropout, seed=seed,
                                      mix=mix, gated=gated)
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs] + [x.grad for x in ws] + ([hg.grad] if need_dh else [])


def run_plain(h, w, mask, dropout, seed, mix, cots, gated=True, need_dh=False):
    """The plain PyTorch twins on the same (CUDA) tensors."""
    from murcl_tpu_torch.ops.attention import fused_trunk_plain_bwd, fused_trunk_plain_fwd

    m, p, s = fused_trunk_plain_fwd(h, *w, mask, dropout, seed, *mix, gated=gated)
    return [m, p, s, *fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, dropout, seed, *mix,
                                            gated=gated, need_dh=need_dh)]


def fused_inputs(b, dtype, gen, dev, masked: bool):
    import torch

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * sc

    w = [r(FIN, L1, sc=FIN ** -0.5), r(L1, sc=0.1), r(L1, D, sc=L1 ** -0.5), r(D, sc=0.1),
         r(L1, D, sc=L1 ** -0.5), r(D, sc=0.1), r(D, sc=D ** -0.5), r((), sc=0.1)]
    h = r(b, N_MAIN, FIN).to(dtype)
    lengths = torch.randint(600, N_MAIN + 1, (b,), generator=gen, device=dev)
    mask = torch.arange(N_MAIN, device=dev)[None, :] < lengths[:, None]
    if not masked:
        mask = torch.ones_like(mask)
    perm = torch.randperm(b, generator=gen, device=dev)
    lam = 0.9 + 0.1 * torch.rand(b, generator=gen, device=dev)
    cots = [r(b, L1), r(b, N_MAIN, sc=0.1), r(b, N_MAIN, sc=0.01)]
    return h, w, mask, (perm, lam), cots


def trunk_keep_rate(dev) -> float:
    """Share of trunk units the kernel keeps at dropout 0.25: with Wf = I,
    bf = 0 and a positive bag, xc is nonzero exactly where the mask keeps."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.ops.attention import _cuda_args

    b = 64
    h = (torch.rand(b, N_MAIN, FIN, device=dev) + 0.5).to(torch.bfloat16)
    wf = torch.eye(FIN, device=dev)
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    mask = torch.ones(b, N_MAIN, dtype=torch.bool, device=dev)
    o, drop = _cuda_args(h, wf, z(L1), z(L1, D), z(D), z(L1, D), z(D), z(D), mask, None,
                         None, 0.25, 1234)
    bc = z(1)
    xc = torch.empty(b, N_MAIN, L1, dtype=torch.bfloat16, device=dev)
    m, p, s = z(b, L1), z(b, N_MAIN), z(b, N_MAIN)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = _cuda.library().murcl_fused_trunk_fwd(
        1, 1, ptr(o["h"]), None, None, ptr(o["wf"]), ptr(o["bf"]), ptr(o["wa"]), ptr(o["ba"]),
        ptr(o["wb"]), ptr(o["bb"]), ptr(o["wc"]), ptr(bc), ptr(o["mask"]), *drop, ptr(xc),
        ptr(m), ptr(p), ptr(s), b, N_MAIN, FIN, L1, D, _cuda.stream())
    _cuda.check(err, "keep-rate probe")
    torch.cuda.synchronize()
    return float((xc != 0).float().mean())


def compact_bound(ranks, offs, nump):
    """K1's bound in bf16: the bank rows this run reads (each once), the
    indices, and the sub-bags written."""
    import torch

    p = torch.arange(ranks.shape[1], device=ranks.device)[None, :]
    live = (ranks >= 0) & (p < nump[:, None])
    read = torch.unique((offs[:, None] + p)[live]).numel()
    return bound(0, read * FIN * 2 + nbytes(ranks, offs, nump)
                 + ranks.shape[0] * N_MAIN * FIN * 2, BF16_FLOPS)


def check_compaction(dev, gen):
    import torch

    from murcl_tpu_torch.data.bank import bank_from_arrays
    from murcl_tpu_torch.ops.compact import (_gather_compact_cuda, compact_slot_slice,
                                             gather_compact_plain)
    from murcl_tpu_torch.ops.select import select_ranks
    import numpy as np

    rng = np.random.default_rng(0)
    clusters = []
    for _ in range(SLIDES):
        a = rng.integers(0, K, size=PATCHES)
        clusters.append([np.flatnonzero(a == c).tolist() for c in range(K)])
    feats = [np.zeros((PATCHES, FIN), np.float32)] * SLIDES
    bank = bank_from_arrays(feats, clusters, [0] * SLIDES).to(dev)
    bank.feats = torch.randn(bank.feats.shape, generator=gen, device=dev)
    ids = torch.randint(0, SLIDES, (BATCH,), generator=gen, device=dev)
    flat = torch.cat([ids, ids]).repeat(T)
    actions = torch.rand(B_MAIN, K, generator=gen, device=dev)
    ranks, offs, _ = select_ranks(flat, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                  actions, bank.patch_cluster, bank.patch_pos, N_MAIN)
    nump = bank.num_patches[flat]
    res = {}
    for dtype, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        feats_dt = bank.feats.to(dtype)
        got = _gather_compact_cuda(feats_dt, offs, ranks, N_MAIN, nump)
        want = gather_compact_plain(feats_dt, offs, ranks, N_MAIN, nump)
        check(torch.equal(got.view(view), want.view(view)), f"K1 not bitwise ({dtype})")
        del got, want
        if dtype == torch.bfloat16:
            res["ms"] = median_ms(lambda: _gather_compact_cuda(feats_dt, offs, ranks,
                                                               N_MAIN, nump))
            res["plain_ms"] = median_ms(lambda: gather_compact_plain(feats_dt, offs, ranks,
                                                                     N_MAIN, nump))
            res["bound_ms"], res["bound_by"] = compact_bound(ranks, offs, nump)
    # the supervised per-step shape (the JAX package's K5): 64 distinct slides
    ids = torch.randperm(SLIDES, generator=gen, device=dev)[:RL_BATCH]
    actions = torch.rand(RL_BATCH, K, generator=gen, device=dev)
    ranks, offs, _ = select_ranks(ids, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                  actions, bank.patch_cluster, bank.patch_pos, N_MAIN)
    nump = bank.num_patches[ids]
    res["k5_slices"] = -(-N_MAIN // compact_slot_slice(RL_BATCH, N_MAIN))
    check(res["k5_slices"] > 1 and compact_slot_slice(B_MAIN, N_MAIN) == N_MAIN,
          f"K1's slot slices: {res['k5_slices']} at {RL_BATCH} bags")
    for dtype, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
        feats_dt = bank.feats.to(dtype)
        got = _gather_compact_cuda(feats_dt, offs, ranks, N_MAIN, nump)
        want = gather_compact_plain(feats_dt, offs, ranks, N_MAIN, nump)
        check(torch.equal(got.view(view), want.view(view)), f"K1 at K5's shape ({dtype})")
        if dtype == torch.bfloat16:
            res["k5_ms"] = median_ms(lambda: _gather_compact_cuda(feats_dt, offs, ranks,
                                                                  N_MAIN, nump))
            res["k5_plain_ms"] = median_ms(lambda: gather_compact_plain(feats_dt, offs, ranks,
                                                                        N_MAIN, nump))
            res["k5_bound_ms"] = compact_bound(ranks, offs, nump)[0]
    res["max_abs_err"] = 0.0
    return res


# K4's shapes: the main path's (B 128, projection width 128), then a batch
# and a width the one-block design of PRs 1-6 refused
NTXENT_SHAPES = ((BATCH, 128), (2 * BATCH, 128), (BATCH, 100))


def check_ntxent(dev, gen):
    """K4f and K4b against their plain pair at each of ``NTXENT_SHAPES``,
    with and without a zero row: the loss and the residual (row max, row sum,
    norm; relative to the larger of 1 and the value), the grads from the
    kernel's residual with g = 1/T as the engine's ``sum / T`` gives it, and
    the op's autograd against autograd of ``nt_xent_plain``, all within 1e-5
    (a zero row's grads, ``dzn / 1e-8``, relative to the largest). The loss
    and K4b's grads must be the same bits in two runs. Both timed at the main
    shape: event ms of the wrapper call (mostly host dispatch at these
    sizes) and device ms per launch (torch.profiler), each beside the plain
    twin's, and the autograd calls as PRs 1-6 timed them."""
    import torch

    from murcl_tpu_torch.ops import ntxent as nt

    g = torch.tensor(1 / T, device=dev)
    errs_f, errs_b = [], []
    for b, d in NTXENT_SHAPES:
        for zero_row in (False, True):
            zi = torch.randn(b, d, generator=gen, device=dev)
            zj = torch.randn(b, d, generator=gen, device=dev)
            if zero_row:
                zi[3] = 0.0
            loss, stats = nt._fwd_cuda(zi, zj, 0.5)
            want, want_stats = nt.nt_xent_plain_fwd(zi, zj, 0.5)
            dk = nt._bwd_cuda(zi, zj, 0.5, stats, g)
            dp = nt.nt_xent_plain_bwd(zi, zj, 0.5, stats, g)
            outs = []
            for fn in (nt._NTXent.apply, nt.nt_xent_plain):
                a, c = zi.clone().requires_grad_(True), zj.clone().requires_grad_(True)
                lv = fn(a, c, 0.5)
                lv.backward()
                outs.append((lv.detach(), a.grad, c.grad))
            (lk, gik, gjk), (lp, gip, gjp) = outs
            ef = max(abs(float(loss - want)), abs(float(lk - lp)),
                     float(((stats - want_stats).abs() / want_stats.abs().clamp_min(1)).max()))
            scale = (max(1.0, *(float(x.abs().max()) for x in (*dp, gip, gjp)))
                     if zero_row else 1.0)
            eb = max(float((x - y).abs().max())
                     for x, y in zip((*dk, gik, gjk), (*dp, gip, gjp))) / scale
            print(f"K4 at ({b}, {d}) x 2 f32{' with a zero row' if zero_row else ''}: "
                  f"loss and residual err {ef:.2e}, grads err {eb:.2e}")
            errs_f.append(ef)
            errs_b.append(eb)
            if zero_row and (b, d) == (BATCH, 128):
                again = nt._fwd_cuda(zi, zj, 0.5)[0], nt._bwd_cuda(zi, zj, 0.5, stats, g)
                check(torch.equal(again[0], loss), "K4f: the loss differs between two runs")
                check(all(torch.equal(x, y) for x, y in zip(again[1], dk)),
                      "K4b: dz differs between two runs")
    check(max(errs_f) <= 1e-5, f"K4 forward error {errs_f}")
    check(max(errs_b) <= 1e-5, f"K4 backward error {errs_b}")
    print("K4f's loss and K4b's dz_i, dz_j bitwise equal in two runs")

    zi = torch.randn(BATCH, 128, generator=gen, device=dev)
    zj = torch.randn(BATCH, 128, generator=gen, device=dev)
    _, stats = nt._fwd_cuda(zi, zj, 0.5)
    calls = {"fwd": (lambda: nt._fwd_cuda(zi, zj, 0.5),
                     lambda: nt.nt_xent_plain_fwd(zi, zj, 0.5)),
             "bwd": (lambda: nt._bwd_cuda(zi, zj, 0.5, stats, g),
                     lambda: nt.nt_xent_plain_bwd(zi, zj, 0.5, stats, g))}
    a, c = zi.clone().requires_grad_(True), zj.clone().requires_grad_(True)
    lk, lp = nt._NTXent.apply(a, c, 0.5), nt.nt_xent_plain(a, c, 0.5)
    autograd = {"fwd": (lambda: nt._NTXent.apply(a, c, 0.5), lambda: nt.nt_xent_plain(a, c, 0.5)),
                "bwd": (lambda: torch.autograd.grad(lk, (a, c), g, retain_graph=True),
                        lambda: torch.autograd.grad(lp, (a, c), g, retain_graph=True))}
    # sim = zn zn^T over 2B rows: 2 (2B)^2 d flops; the backward's two
    # products (sim once, then (G + G^T) zn) twice that; f32 products at
    # TF32's rate, the card's fastest for f32 operands
    sim_flops = 2 * (2 * BATCH) ** 2 * 128
    bounds = {"fwd": bound(sim_flops, nbytes(zi, zj) + 4, TF32_FLOPS),
              "bwd": bound(2 * sim_flops, 2 * nbytes(zi, zj) + 4, TF32_FLOPS)}
    out = []
    for k, name in (("fwd", "K4f"), ("bwd", "K4b")):
        kernel, plain = calls[k]
        res = {"ms": median_ms(kernel, reps=20), "plain_ms": median_ms(plain, reps=20),
               "device_ms": device_ms(kernel), "plain_device_ms": device_ms(plain, own=False),
               "split_ms": dict(kernel_split(kernel)),
               "autograd_ms": median_ms(autograd[k][0], reps=20),
               "autograd_plain_ms": median_ms(autograd[k][1], reps=20),
               "max_abs_err": max(errs_f if k == "fwd" else errs_b),
               "bound_ms": bounds[k][0], "bound_by": bounds[k][1]}
        print(f"{name} at ({BATCH}, 128) x 2 f32: event {res['ms']:.4f} ms (plain "
              f"{res['plain_ms']:.4f}), device {res['device_ms']:.4f} ms per launch (plain "
              f"{res['plain_device_ms']:.4f}; "
              + ", ".join(f"{n} {ms:.4f}" for n, ms in res["split_ms"].items())
              + f"), autograd call {res['autograd_ms']:.4f} ms (plain "
              f"{res['autograd_plain_ms']:.4f}); bound {res['bound_ms']:.5f} ms "
              f"({res['bound_by']}), below one launch's latency")
        check(res["ms"] < res["plain_ms"] and res["device_ms"] < res["plain_device_ms"],
              f"{name} not faster than its plain twin: {res}")
        out.append(res)
    return tuple(out)


def kernel_split(fn, own: bool = True, reps: int = 1) -> list:
    """``[(kernel, device ms)]`` of the port's kernels that ``reps`` calls
    of ``fn`` launch, in launch order (torch.profiler; PyTorch's own copies
    and memsets left out); with ``own=False`` every device event, PyTorch's
    included, by its full name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = []
    for e in sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start):
        ms = (e.time_range.end - e.time_range.start) / 1e3
        name = re.search(r"anonymous namespace\)::([\w:]+)", e.name)
        if not own:
            out.append((e.name, ms))
        elif name and "at::native" not in e.name:
            out.append((name.group(1), ms))
    return out


def device_ms(fn, own: bool = True, reps: int = 20) -> float:
    """Device ms per call of ``fn``: ``kernel_split``'s events of ``reps``
    calls, summed, over ``reps``."""
    return sum(ms for _, ms in kernel_split(fn, own, reps)) / reps


# the kernels that must run on the tensor cores: the bf16 kernels of
# csrc/fused_trunk.cu (K2/K3) and csrc/attention_pool.cu (K7), where
# tc::wgrad_kernel serves both, and K8's kernel (csrc/attention_tiled.cu) in
# both of its instantiations
TC_KERNELS = ("trunk_tc", "gates_fwd_tc", "gates_bwd_tc", "dx_tc", "tc::wgrad_kernel",
              "pool_gates_fwd_tc", "pool_gates_bwd_tc", "pool_dx_tc", "tiled_pool_tc<float>",
              "tiled_pool_tc<__nv_bfloat16>")


def mangled(kernel: str) -> str:
    """The part of a kernel's mangled name that spells ``kernel``: each part
    of the name by its length (``2tc12wgrad_kernel``), then a template
    argument (``13tiled_pool_tcIfE``)."""
    base, _, arg = kernel.partition("<")
    out = "".join(f"{len(part)}{part}" for part in base.split("::"))
    if arg:
        arg = arg.rstrip(">")
        out += "I" + ("f" if arg == "float" else f"{len(arg)}{arg}") + "E"
    return out


def check_sass() -> dict:
    """``cuobjdump -sass`` (beside nvcc) over the built kernel library: each
    kernel of ``TC_KERNELS`` (defined in ``csrc/fused_trunk.cu``,
    ``csrc/attention_pool.cu``, ``csrc/attention_tiled.cu`` and the header
    they share) must hold tensor-core instructions (HMMA or HGMMA). Returns
    their counts per kernel."""
    from murcl_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_cuda.library_path())], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        for k in TC_KERNELS:
            if mangled(k) in name:
                counts[k] = counts.get(k, 0) + sum(
                    1 for line in body.splitlines()
                    if re.search(r"\bH(G)?MMA\b", line))
    check(set(counts) == set(TC_KERNELS) and all(counts.values()),
          f"kernels without tensor-core instructions: {counts}")
    return counts


def check_fused(dev, gen):
    import torch

    from murcl_tpu_torch.ops.attention import _FusedTrunkAttention

    names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc", "dh"]
    err_f, err_b = 0.0, 0.0
    cases = [(torch.float32, 0.0, 1e-4, True), (torch.bfloat16, 0.0, 2e-2, True),
             (torch.bfloat16, 0.25, 2e-2, False)]
    # (gated, mixed, need_dh): the main path's mode, then the modes of the
    # model API (ungated CLAM; a CLAM differentiated with respect to its bags)
    modes = [(True, True, False), (False, True, False), (True, False, True),
             (False, False, True)]
    for gated, mixed, need_dh in modes:
        for dtype, rate, tol, masked in cases:
            h, w, mask, mix, cots = fused_inputs(CHECK_BAGS, dtype, gen, dev, masked)
            mix = mix if mixed else (None, None)
            got = run_fused(h, w, mask, rate, 77, mix if mixed else None, cots, gated, need_dh)
            want = run_plain(h, w, mask, rate, 77, mix, cots, gated, need_dh)
            rels = {n: rel_err(g, wv) for n, g, wv in zip(names, got, want)
                    if gated or n not in ("dwb", "dbb")}
            if not gated:
                check(not got[7].any() and not got[8].any(), "K3 ungated: dwb/dbb not zero")
            what = f"K2/K3 gated={gated} mixed={mixed} dh={need_dh} {dtype} dropout {rate}"
            print(f"{what}: rel err " + ", ".join(f"{n} {v:.2e}" for n, v in rels.items()))
            check(max(rels.values()) <= tol, f"{what}: {rels}")
            err_f = max(err_f, *(float((g - wv).abs().max())
                                 for g, wv in zip(got[:3], want[:3])))
            err_b = max(err_b, *(float((g.float() - wv.float()).abs().max())
                                 for g, wv in zip(got[3:], want[3:])))
            del h, got, want
    keep = trunk_keep_rate(dev)
    print(f"K2 trunk keep rate at dropout 0.25: {keep:.5f}")
    check(abs(keep - 0.75) <= 0.0075, f"keep rate {keep}")

    # timing at the main path's full shape: bf16, dropout 0.25, in-kernel mix
    h, w, mask, mix, cots = fused_inputs(B_MAIN, torch.bfloat16, gen, dev, False)
    ws = [x.detach().clone().requires_grad_(True) for x in w]
    perm, lam = mix
    args = (h, *ws, mask, 0.25, 77, perm, lam, True)
    _, p, _ = _FusedTrunkAttention.apply(*args)
    p = p.detach()
    from murcl_tpu_torch.ops import attention as att

    k_fwd = median_ms(lambda: att._fwd_cuda(h, *w, mask, 0.25, 77, perm, lam), reps=3)
    k_bwd = median_ms(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77, perm, lam),
                      reps=3)
    split_fwd = kernel_split(lambda: att._fwd_cuda(h, *w, mask, 0.25, 77, perm, lam))
    split_bwd = name_wgrads(kernel_split(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25,
                                                               77, perm, lam)),
                            ("dWf", "dWa", "dWb"))
    for what, split, total in (("K2", split_fwd, k_fwd), ("K3", split_bwd, k_bwd)):
        print_split(f"{what} at ({B_MAIN}, {N_MAIN}, {FIN}) bf16 gated, mixed, dropout 0.25",
                    split, total)
    # unmixed with dh: dh, like K7b's dx, has no atomics on its path
    twice = determinism(f"K3 at ({B_MAIN}, {N_MAIN}, {FIN}) bf16 gated, unmixed, with dh, "
                        "dropout 0.25",
                        lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77, None, None,
                                              need_dh=True),
                        ["dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc", "dh"], ("dh",))
    modes = {
        "fwd_ungated": median_ms(lambda: att._fwd_cuda(h, *w, mask, 0.25, 77, perm, lam,
                                                       gated=False), reps=3),
        "bwd_ungated": median_ms(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77,
                                                       perm, lam, gated=False), reps=3),
        # unmixed, as a CLAM differentiated with respect to its bags runs it
        "bwd_dh": median_ms(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77,
                                                  None, None, need_dh=True), reps=3),
        "bwd_unmixed": median_ms(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77,
                                                       None, None), reps=3),
    }
    del ws
    torch.cuda.empty_cache()
    p_fwd = median_ms(lambda: att.fused_trunk_plain_fwd(h, *w, mask, 0.25, 77, perm, lam),
                      reps=3)
    p_bwd = median_ms(lambda: att.fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, 0.25, 77,
                                                        perm, lam), reps=3)
    plain = {
        "fwd_ungated": median_ms(lambda: att.fused_trunk_plain_fwd(
            h, *w, mask, 0.25, 77, perm, lam, gated=False), reps=3),
        "bwd_ungated": median_ms(lambda: att.fused_trunk_plain_bwd(
            h, *w[:7], mask, p, *cots, 0.25, 77, perm, lam, gated=False), reps=3),
        "bwd_dh": median_ms(lambda: att.fused_trunk_plain_bwd(
            h, *w[:7], mask, p, *cots, 0.25, 77, need_dh=True), reps=3),
        "bwd_unmixed": median_ms(lambda: att.fused_trunk_plain_bwd(
            h, *w[:7], mask, p, *cots, 0.25, 77), reps=3),
    }
    # matmul terms at the timed shape (bf16): trunk 2 R Fin L1, gates 4 R L1 D,
    # pool 2 R L1; the backward recomputes trunk and gates and adds dx
    # through the gates, dWa/dWb and dWf
    r = B_MAIN * N_MAIN
    trunk, gates = 2 * r * FIN * L1, 4 * r * L1 * D
    io = nbytes(h, mask, perm, lam) + r * 4 * 2 + B_MAIN * L1 * 4
    fb = bound(trunk + gates + 2 * r * L1, io, BF16_FLOPS)
    bb = bound(2 * trunk + 3 * gates + 2 * r * L1,
               nbytes(h, mask, perm, lam, p, *cots), BF16_FLOPS)
    return ({"ms": k_fwd, "plain_ms": p_fwd, "max_abs_err": err_f,
             "bound_ms": fb[0], "bound_by": fb[1], "split_ms": dict(split_fwd),
             "ungated_ms": modes["fwd_ungated"], "ungated_plain_ms": plain["fwd_ungated"]},
            {"ms": k_bwd, "plain_ms": p_bwd, "max_abs_err": err_b,
             "bound_ms": bb[0], "bound_by": bb[1], "split_ms": dict(split_bwd), "twice": twice,
             "ungated_ms": modes["bwd_ungated"], "ungated_plain_ms": plain["bwd_ungated"],
             "dh_ms": modes["bwd_dh"], "dh_plain_ms": plain["bwd_dh"],
             "unmixed_ms": modes["bwd_unmixed"], "unmixed_plain_ms": plain["bwd_unmixed"]})


def check_mixup(dev, gen):
    """K6 against ``apply_mix``: bitwise in bf16 at the ABMIL stage-1 shape
    and in f32 at an eighth of it; both timed."""
    import torch

    from murcl_tpu_torch.ops.mixup import _mixup_rows_cuda, apply_mix

    res = {"max_abs_err": 0.0}
    # (dtype, bags, group): perm_abs permutes within groups, as the engine's
    # (step, view) groups of BATCH bags
    for dtype, view, b, grp in ((torch.bfloat16, torch.int16, B_MAIN, BATCH),
                                (torch.float32, torch.int32, B_MAIN // 8, BATCH // 2)):
        x = torch.randn(b, N_MAIN, FIN, generator=gen, device=dev).to(dtype)
        base = torch.arange(b // grp, device=dev).repeat_interleave(grp) * grp
        perm = torch.cat([torch.randperm(grp, generator=gen, device=dev)
                          for _ in range(b // grp)]) + base
        lam = 0.9 + 0.1 * torch.rand(b, generator=gen, device=dev)
        got, want = _mixup_rows_cuda(x, perm, lam), apply_mix(x, perm, lam)
        check(torch.equal(got.view(view), want.view(view)), f"K6 not bitwise ({dtype})")
        del got, want
        tag = "" if dtype == torch.bfloat16 else "_f32"
        res["ms" + tag] = median_ms(lambda: _mixup_rows_cuda(x, perm, lam))
        res["plain_ms" + tag] = median_ms(lambda: apply_mix(x, perm, lam))
        if dtype == torch.bfloat16:  # x read once (x[perm] is x), out written once
            res["bound_ms"], res["bound_by"] = bound(3 * x.numel(),
                                                     2 * nbytes(x) + nbytes(perm, lam),
                                                     F32_FLOPS)
        del x
        torch.cuda.empty_cache()
    gib = 3 * B_MAIN * N_MAIN * FIN * 2 / 2**30
    res["gbps"] = gib * 2**30 / 1e9 / (res["ms"] / 1e3)
    return res


def pool_inputs(b, dtype, gen, dev, masked: bool, d: int = D, n: int = N_MAIN):
    """K7's operands; masked bags are live for 600 (or n / 2) to n rows, and
    the first four for 1, 63, 65 and n where n is not a multiple of 64."""
    import torch

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * sc

    w = [r(L1, d, sc=L1 ** -0.5), r(d, sc=0.1), r(L1, d, sc=L1 ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(b, n, L1)).to(dtype)  # a trunk output: post-relu
    lengths = torch.randint(min(600, n // 2), n + 1, (b,), generator=gen, device=dev)
    if n % 64:
        lengths[:4] = torch.tensor([1, 63, 65, n], device=dev)
    mask = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    if not masked:
        mask = torch.ones_like(mask)
    cots = [r(b, L1), r(b, n, sc=0.1), r(b, n, sc=0.01)]
    return x, w, mask, cots


def gate_keep_rates(dev):
    """Share of gate units K7 keeps at dropout 0.25, read from its backward
    scratch: dza is nonzero exactly where the gate masks keep (stream 1
    ungated; streams 1 and 2 both gated, 0.75^2 = 0.5625)."""
    import torch

    from murcl_tpu_torch.ops.attention import _pool_bwd_launch, _pool_fwd_cuda

    gen = torch.Generator(device=dev).manual_seed(11)
    b = 64
    x, w, mask, cots = pool_inputs(b, torch.bfloat16, gen, dev, False)
    cots[2] = cots[2] + 0.1 * torch.sign(cots[2])  # ds away from 0 on every row
    rates = {}
    for gated in (False, True):
        _, p, _ = _pool_fwd_cuda(x, *w, mask, gated, 0.25, 4321)
        _, dza = _pool_bwd_launch(x, *w[:5], mask, p, *cots, gated, 0.25, 4321)
        torch.cuda.synchronize()
        rates[gated] = float((dza[0] != 0).float().mean())  # the hi plane, rnd(dza)
    return rates


def name_wgrads(split, grads) -> list:
    """``split`` (``kernel_split``'s list) with each weight-gradient
    contraction named by its gradient, in launch order."""
    grads = iter(grads)
    return [(f"{n} {next(grads)}" if n.endswith("wgrad_kernel") else n, ms) for n, ms in split]


def print_split(what, split, total) -> None:
    print(f"{what}: {total:.3f} ms (median of 3); one call by sub-kernel: "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split))


def determinism(what, fn, names, exact) -> dict:
    """Runs ``fn`` twice on the same inputs and prints, per output, the
    largest absolute difference between the runs and its relative Frobenius
    size; fails unless the outputs named in ``exact`` (no atomics on their
    path) are bitwise equal. Returns ``{name: (max abs, relative)}``."""
    import torch

    first, second = fn(), fn()
    torch.cuda.synchronize()
    diffs = {n: (float((a.float() - b.float()).abs().max()), rel_err(a, b))
             for n, a, b in zip(names, first, second)}
    print(f"{what}, run twice on the same inputs: largest difference per output "
          + ", ".join(f"{n} {d:.3e} (rel {r:.2e})" for n, (d, r) in diffs.items())
          + "; bf16 tolerance 2e-2 rel")
    for n, a, b in zip(names, first, second):
        if n in exact:
            check(torch.equal(a, b), f"{what}: {n} differs between two runs")
    return diffs


def check_pool(dev, gen):
    import torch

    from murcl_tpu_torch.ops import attention as att

    names = ["M", "p", "s", "dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    err_f, err_b = 0.0, 0.0
    cases = [(torch.float32, 0.0, 1e-4), (torch.bfloat16, 0.0, 2e-2),
             (torch.bfloat16, 0.25, 2e-2)]
    # (gated, D, N, cases): CLAM's pools at D 256, gated and ungated; CLAM
    # "big" (gated, D 384) in bf16; bags of TAIL_N rows (K7's row tails);
    # then ABMIL's mode (ungated, D 128, dropout 0) at its own width
    modes = [(True, D, N_MAIN, cases), (False, D, N_MAIN, cases),
             (True, CLAM_BIG_D, N_MAIN, cases[1:]), (True, D, TAIL_N, cases),
             (False, ABMIL_D, N_MAIN, cases[:2])]
    for gated, d, n, mode_cases in modes:
        for dtype, rate, tol in mode_cases:
            x, w, mask, cots = pool_inputs(POOL_CHECK_BAGS, dtype, gen, dev, True, d, n)
            xg = x.clone().requires_grad_(True)
            ws = [v.clone().requires_grad_(True) for v in w]
            outs = att._AttentionPool.apply(xg, *ws, mask, gated, rate, 77)
            torch.autograd.backward(outs, cots)
            got = [o.detach() for o in outs] + [xg.grad] + [v.grad for v in ws]
            m, p, s = att.gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, 77)
            want = [m, p, s, *att.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots,
                                                                  gated, rate, 77)]
            rels = {nm: rel_err(g, wv) for nm, g, wv in zip(names, got, want)
                    if gated or nm not in ("dwb", "dbb")}
            what = f"K7 gated={gated} D={d} N={n} {dtype} dropout {rate}"
            print(f"{what}: rel err " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
            check(max(rels.values()) <= tol, f"{what}: {rels}")
            err_f = max(err_f, *(float((g - wv).abs().max()) for g, wv in zip(got[:3], want[:3])))
            err_b = max(err_b, *(float((g.float() - wv.float()).abs().max())
                                 for g, wv in zip(got[3:], want[3:])))
            del x, xg, got, want
    rates = gate_keep_rates(dev)
    print(f"K7 gate keep rate at dropout 0.25: stream 1 {rates[False]:.5f}, "
          f"streams 1 and 2 {rates[True]:.5f}")
    check(abs(rates[False] - 0.75) <= 0.0075, f"gate keep rate {rates[False]}")
    check(abs(rates[True] - 0.5625) <= 0.005625, f"joint gate keep rate {rates[True]}")

    def timed(b, d, gated, rate):
        """K7f and K7b at (b, N_MAIN, L1) bf16, unmasked: median ms of each
        and of its plain twin, one call of each split by sub-kernel, and the
        bounds (gate products 2 R F D per gate forward; recomputed, then dx
        and dW in the backward; pool and dp 2 R F)."""
        x, w, mask, cots = pool_inputs(b, torch.bfloat16, gen, dev, False, d)
        _, p, _ = att._pool_fwd_cuda(x, *w, mask, gated, rate, 77)
        fwd = lambda: att._pool_fwd_cuda(x, *w, mask, gated, rate, 77)  # noqa: E731
        bwd = lambda: att._pool_bwd_cuda(x, *w[:5], mask, p, *cots, gated, rate, 77)  # noqa: E731
        res = {"fwd": median_ms(fwd, reps=3), "bwd": median_ms(bwd, reps=3),
               "split_fwd": kernel_split(fwd),
               "split_bwd": name_wgrads(kernel_split(bwd), ("dWa", "dWb"))}
        if gated:
            res["twice"] = determinism(f"K7b at ({b}, {N_MAIN}, {L1}) bf16 gated, dropout {rate}",
                                       bwd, names[3:], ("dx",))
        torch.cuda.empty_cache()
        res["fwd_plain"] = median_ms(lambda: att.gated_attention_pool_plain_fwd(
            x, *w, mask, gated, rate, 77), reps=3)
        res["bwd_plain"] = median_ms(lambda: att.gated_attention_pool_plain_bwd(
            x, *w[:5], mask, p, *cots, gated, rate, 77), reps=3)
        r = b * N_MAIN
        gates = 2 * r * L1 * d * (2 if gated else 1)
        res["fwd_bound"] = bound(gates + 2 * r * L1, nbytes(x, mask) + r * 8 + b * L1 * 4,
                                 BF16_FLOPS)
        res["bwd_bound"] = bound(3 * gates + 2 * r * L1, 2 * nbytes(x) + nbytes(mask, p, *cots),
                                 BF16_FLOPS)
        mode = f"({b}, {N_MAIN}, {L1}) bf16 {'gated' if gated else 'ungated'}, D {d}, " \
               f"dropout {rate}"
        print_split(f"K7f at {mode}", res["split_fwd"], res["fwd"])
        print_split(f"K7b at {mode}", res["split_bwd"], res["bwd"])
        del x, p, cots
        torch.cuda.empty_cache()
        return res

    sup = timed(POOL_BAGS, D, True, 0.25)  # the supervised stage-1 shape
    abmil = timed(B_MAIN, ABMIL_D, False, 0.0)  # ABMIL's stage-1 shape
    out = []
    for k in ("fwd", "bwd"):
        out.append({"ms": sup[k], "plain_ms": sup[k + "_plain"],
                    "max_abs_err": err_f if k == "fwd" else err_b,
                    "bound_ms": sup[k + "_bound"][0], "bound_by": sup[k + "_bound"][1],
                    "split_ms": dict(sup["split_" + k]), "abmil_ms": abmil[k],
                    "abmil_plain_ms": abmil[k + "_plain"], "abmil_bound_ms": abmil[k + "_bound"][0],
                    "abmil_split_ms": dict(abmil["split_" + k])})
    out[1]["twice"] = sup["twice"]
    return tuple(out)


def tiled_inputs(b, n, dtype, gen, dev, lengths):
    import torch

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * sc

    w = [r(L1, D, sc=L1 ** -0.5), r(D, sc=0.1), r(L1, D, sc=L1 ** -0.5), r(D, sc=0.1),
         r(D, sc=D ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(b, n, L1)).to(dtype)  # a trunk output: post-relu
    mask = torch.arange(n, device=dev)[None, :] < torch.tensor(lengths, device=dev)[:, None]
    return x, w, mask


def tiled_bound(n: int, dtype) -> tuple:
    """K8's bound at (1, n, L1) gated: the function's own work (the gate
    products, 4 n L1 D, and the rest) at the card's fastest rate for its
    operands (TF32 for f32, bf16 for bf16), x read once. Returns ``((ms,
    side), flops, mma_flops, fma_ms)``; ``mma_flops``, the bf16 products the
    kernel issues (three per f32 product), and ``fma_ms``, the bound of the
    earlier FMA tiles (f32 at 67 TFLOP/s), are notes for the text line."""
    import torch

    gates = 4 * n * L1 * D
    rest = 2 * n * D + 2 * n * L1
    f32 = dtype == torch.float32
    io = n * L1 * (4 if f32 else 2) + n + n * 4 + L1 * 4
    return (bound(gates + rest, io, TF32_FLOPS if f32 else BF16_FLOPS), gates + rest,
            (3 if f32 else 1) * gates + rest, bound(gates + rest, io, F32_FLOPS)[0])


def check_tiled(dev, gen):
    """K8 against its twin: the heatmap's largest bag (1, 60416, 512) f32
    gated with a masked tail, and (4, 12288, 512) gated and ungated in f32
    and bf16 (bags live for 12288 rows, 11288 (ending mid-tile), 12000 and
    5000 (later chunks all masked)). One backward through the op (K7b) at
    (1, 60416, 512) f32 against the plain backward, timed. K8 timed at (1,
    60416, 512) and (1, 12288, 512) f32 and at (1, 60416, 512) bf16 beside
    its twin and its bound, split by sub-kernel; fails unless faster than
    the twin in f32 at both lengths."""
    import torch

    from murcl_tpu_torch.ops import attention as att

    err = 0.0
    (b1, n1), (b4, n4) = K8_MAIN, K8_CHECK
    cases = [(b1, n1, [HEAT_SLIDES[-1]], True, torch.float32, 1e-4)]
    for gated in (True, False):
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            cases.append((b4, n4, [n4, n4 - 1000, 12000, 5000], gated, dtype, tol))
    for b, n, lengths, gated, dtype, tol in cases:
        x, w, mask = tiled_inputs(b, n, dtype, gen, dev, lengths)
        got = att._tiled_fwd_cuda(x, *w, mask, gated)
        want = att.attention_pool_tiled_plain(x, *w, mask, gated)
        rels = {nm: rel_err(g, wv) for nm, g, wv in zip("Mps", got, want)}
        what = f"K8 gated={gated} ({b}, {n}, {L1}) {dtype}"
        print(f"{what}: rel err " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
        check(max(rels.values()) <= tol, f"{what}: {rels}")
        err = max(err, *(float((g - wv).abs().max()) for g, wv in zip(got, want)))
        del x, got, want

    # the op's backward (K7b) at the heatmap's largest bag, past K7f's pool pass
    x, w, mask = tiled_inputs(b1, n1, torch.float32, gen, dev, [HEAT_SLIDES[-1]])
    cots = [torch.randn(b1, L1, generator=gen, device=dev),
            0.1 * torch.randn(b1, n1, generator=gen, device=dev),
            0.01 * torch.randn(b1, n1, generator=gen, device=dev)]
    xg = x.clone().requires_grad_(True)
    ws = [v.clone().requires_grad_(True) for v in w]
    outs = att._AttentionPoolTiled.apply(xg, *ws, mask, True)
    torch.autograd.backward(outs, cots)
    p = att.attention_pool_tiled_plain(x, *w, mask, True)[1]
    want = att.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots, True)
    names = ["dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    rels = {nm: rel_err(g, wv) for nm, g, wv in zip(names, [xg.grad] + [v.grad for v in ws],
                                                     want)}
    bwd = lambda: att._pool_bwd_cuda(x, *w[:5], mask, p, *cots, True, 0.0, 0)  # noqa: E731
    bwd_ms = median_ms(bwd, reps=3)
    bwd_plain_ms = median_ms(lambda: att.gated_attention_pool_plain_bwd(
        x, *w[:5], mask, p, *cots, True), reps=3)
    print(f"K8's op backward (K7b) gated ({b1}, {n1}, {L1}) f32: rel err "
          + ", ".join(f"{k} {v:.2e}" for k, v in rels.items())
          + f"; {bwd_ms:.3f} ms vs plain {bwd_plain_ms:.3f} ms (median of 3)")
    check(max(rels.values()) <= 1e-4, f"K8's op backward: {rels}")
    del x, xg, ws, outs, cots, want, p
    torch.cuda.empty_cache()

    res = {"max_abs_err": err, "bwd_ms": bwd_ms, "bwd_plain_ms": bwd_plain_ms}
    for n, dtype in ((n1, torch.float32), (n4, torch.float32), (n1, torch.bfloat16)):
        x, w, mask = tiled_inputs(1, n, dtype, gen, dev, [n - 416])
        fwd = lambda: att._tiled_fwd_cuda(x, *w, mask, True)  # noqa: E731
        ms = median_ms(fwd)
        plain_ms = median_ms(lambda: att.attention_pool_tiled_plain(x, *w, mask, True))
        split = kernel_split(fwd)
        (b_ms, b_by), flops, mma_flops, fma_ms = tiled_bound(n, dtype)
        what = f"K8 at (1, {n}, {L1}) {str(dtype).split('.')[-1]} gated"
        rate = "495 TFLOP/s (TF32)" if dtype == torch.float32 else "989 TFLOP/s (bf16)"
        print(f"{what}: {ms:.3f} ms vs plain {plain_ms:.3f} ms; one call by sub-kernel: "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in split)
              + f"; bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP at {rate}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s of the function's work; the kernel issues "
              f"{mma_flops / 1e9:.2f} GFLOP of bf16 products; the FMA tiles' bound was "
              f"{fma_ms:.4f} ms")
        if dtype == torch.float32:
            check(ms < plain_ms, f"{what}: {ms} ms, not faster than the plain twin's {plain_ms}")
        tag = {n1: "", n4: "_12288"}[n] if dtype == torch.float32 else "_bf16"
        res.update({"ms" + tag: ms, "plain_ms" + tag: plain_ms, "bound_ms" + tag: b_ms,
                    "split_ms" + tag: dict(split)})
        if not tag:
            res.update(bound_by=b_by, fma_bound_ms=fma_ms)
        del x
        torch.cuda.empty_cache()
    return res


def make_dataset(root):
    """192 synthetic slides x 2048 patches; split files for MuRCL (the
    first 64 slides) and for RLMIL (128 / 32 / 32; labels alternate)."""
    from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
    from murcl_tpu_torch.utils.general import dump_json

    n_tr, n_va, n_te = RL_SPLITS
    ids = [f"synt_{i:03d}" for i in range(n_tr + n_va + n_te)]
    ds = generate_synthetic_dataset(root, num_slides=len(ids), dim=FIN, num_clusters=K,
                                    slide_patches=PATCHES, seed=985,
                                    splits={"train": ids[:SLIDES], "valid": ids[:2],
                                            "test": ids[:2]})
    ds["rlmil_split_json"] = str(Path(root) / "rlmil_split.json")
    dump_json({"train": ids[:n_tr], "valid": ids[n_tr:n_tr + n_va],
               "test": ids[n_tr + n_va:]}, ds["rlmil_split_json"])
    return ds


# per arch, the kernels each MuRCL stage must launch (> 0) and must not (== 0)
MURCL_KERNELS = {
    "CLAM_SB": {1: (("compact", "fused_trunk_fwd", "fused_trunk_bwd", "ntxent_fwd",
                     "ntxent_bwd"), ("mixup_rows", "attention_pool_fwd")),
                2: (("compact", "fused_trunk_fwd", "ntxent_fwd"),
                    ("fused_trunk_bwd", "ntxent_bwd", "mixup_rows")),
                3: (("compact", "fused_trunk_fwd", "fused_trunk_bwd", "ntxent_fwd",
                     "ntxent_bwd"), ("mixup_rows",))},
    "ABMIL": {1: (("compact", "mixup_rows", "attention_pool_fwd", "attention_pool_bwd",
                   "ntxent_fwd", "ntxent_bwd"), ("fused_trunk_fwd", "fused_trunk_bwd")),
              2: (("compact", "attention_pool_fwd", "ntxent_fwd"),
                  ("fused_trunk_fwd", "fused_trunk_bwd", "attention_pool_bwd", "ntxent_bwd",
                   "mixup_rows")),
              3: (("compact", "attention_pool_fwd", "attention_pool_bwd", "ntxent_fwd",
                   "ntxent_bwd"), ("fused_trunk_fwd", "fused_trunk_bwd", "mixup_rows"))},
}
MURCL_REPEAT = {("CLAM_SB", 1): 10, ("ABMIL", 1): 4}  # data_repeat; 2 (one step) otherwise


def murcl_args(dev, ds, results, arch, stage, **extra):
    from murcl_tpu_torch.drivers.murcl import default_args

    return default_args(data_csv=ds["data_csv"], data_split_json=ds["data_split_json"],
                        device=str(dev), train_stage=stage, arch=arch, batch_size=BATCH,
                        feat_size=N_MAIN, T=T, compute_dtype="bfloat16",
                        data_repeat=MURCL_REPEAT.get((arch, stage), 2), epochs=1,
                        ppo_epochs=1, base_save_dir=str(results), **extra)


def murcl_path(dev, ds, results, arch):
    """MuRCL stages 1 -> 2 -> 3 of ``arch`` through the driver; per stage the
    launch counts. Returns ``(counts per stage, stage-3 model_best path)``."""
    import torch

    from murcl_tpu_torch.drivers.murcl import run
    from murcl_tpu_torch.ops import _cuda

    per_stage, run_dir = {}, None
    for stage in (1, 2, 3):
        args = murcl_args(dev, ds, results, arch, stage)
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = run(args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        per_stage[stage] = launches
        run_dir = Path(out["save_dir"])
        what = f"MuRCL {arch} stage {stage}"
        check(run_dir.name == f"stage_{stage}", f"{what} ran in {run_dir}")
        check(math.isfinite(out["best_loss"]), f"{what}: loss {out['best_loss']}")
        for name in ("checkpoint.pth.tar", "model_best.pth.tar", "losses.csv"):
            check((run_dir / name).exists(), f"{what}: no {name}")
        ckpt = torch.load(run_dir / "checkpoint.pth.tar", map_location="cpu", weights_only=True)
        check((ckpt["policy"] is not None) == (stage > 1), f"{what}: policy entry")
        used, unused = MURCL_KERNELS[arch][stage]
        check(all(launches[k] > 0 for k in used) and all(launches[k] == 0 for k in unused),
              f"{what}: launches {launches}")
        print(f"{what}: loss {out['best_loss']:.6f}, {out['steps_per_sec']:.4f} steps/s over "
              f"the epoch (first step included), run() wall {wall:.2f} s, launches {launches}")
    return per_stage, str(run_dir / "model_best.pth.tar")


@contextlib.contextmanager
def plain_twins():
    """For one comparison, route the CUDA wrappers of the ABMIL path (K1, K6,
    K7, K4) and of the heatmap path (K2, K8) to their plain twins on the
    same CUDA tensors; restored after."""
    from types import SimpleNamespace

    from murcl_tpu_torch.ops import attention as att
    from murcl_tpu_torch.ops import compact, mixup, ntxent

    swaps = [(compact, "_gather_compact_cuda", compact.gather_compact_plain),
             (mixup, "_mixup_rows_cuda", mixup.apply_mix),
             (att, "_pool_fwd_cuda", att.gated_attention_pool_plain_fwd),
             (att, "_pool_bwd_cuda", att.gated_attention_pool_plain_bwd),
             (att, "_fwd_cuda", att.fused_trunk_plain_fwd),
             (att, "_tiled_fwd_cuda", att.attention_pool_tiled_plain),
             (ntxent, "_NTXent", SimpleNamespace(apply=ntxent.nt_xent_plain))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    try:
        for mod, name, fn in swaps:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def abmil_step_check(dev, ds, results):
    """One ABMIL stage-1 step at the bench.py shape through the kernels, then
    through their plain twins on the card, from the same weights and draws:
    step losses within 1e-4 absolute, every gradient within a Frobenius error
    of 2e-2 relative to the larger of its norm and 1e-4 of the largest
    gradient's norm (the floor holds the gradients that cancel: the score
    bias's is zero in exact arithmetic, as softmax ignores a shift). Then one
    optimizer step must move every weight that has a gradient. Prints the
    embeddings' spread across bags (norm of the std over bags / norm of the
    mean)."""
    import torch

    from murcl_tpu_torch.drivers.murcl import setup
    from murcl_tpu_torch.ops import _cuda

    s = setup(murcl_args(dev, ds, results, "ABMIL", 1, exist_ok=True))
    eng = s.engine
    named = ([(f"model.{k}", v) for k, v in eng.model.named_parameters()]
             + [(f"fc.{k}", v) for k, v in eng.fc.named_parameters()])
    ids = torch.arange(BATCH, device=dev) % SLIDES
    embs = []
    hook = eng.model.encoder.register_forward_hook(lambda m, i, out: embs.append(out[0].detach()))

    def grads():
        eng.model.train()
        eng.fc.train()
        eng.optimizer.zero_grad(set_to_none=True)
        total, stats = eng.rollout_batched(s.bank, ids, torch.Generator().manual_seed(0))
        total.backward()
        torch.cuda.synchronize()
        return stats.step_losses.clone(), {k: v.grad.clone() for k, v in named
                                           if v.grad is not None}

    _cuda.reset_launch_counts()
    k_loss, k_grads = grads()
    check(all(_cuda.LAUNCHES[k] > 0 for k in ("compact", "mixup_rows", "attention_pool_fwd",
                                              "attention_pool_bwd", "ntxent_fwd",
                                              "ntxent_bwd")), f"kernel step: {_cuda.LAUNCHES}")
    _cuda.reset_launch_counts()
    with plain_twins():
        p_loss, p_grads = grads()
    check(not any(_cuda.LAUNCHES.values()), f"plain step launched {_cuda.LAUNCHES}")
    hook.remove()
    loss_err = float((k_loss - p_loss).abs().max())
    check(k_grads.keys() == p_grads.keys() and len(k_grads) >= 10,
          f"gradients of {sorted(k_grads)} against {sorted(p_grads)}")
    floor = 1e-4 * max(float(g.norm()) for g in p_grads.values())
    rels = {k: float((k_grads[k].double() - p_grads[k].double()).norm()
                     / max(float(p_grads[k].norm()), floor)) for k in k_grads}
    worst = max(rels, key=rels.get)
    emb_k, emb_p = embs[0].float(), embs[1].float()
    spread = float(emb_k.std(dim=0).norm() / emb_k.mean(dim=0).norm())
    print(f"ABMIL stage-1 step, kernels against plain twins: step losses "
          f"{[round(float(v), 6) for v in k_loss]} (max abs diff {loss_err:.2e}); "
          f"embedding rel err {rel_err(emb_k, emb_p):.2e}, spread across bags {spread:.3e}; "
          f"{len(rels)} gradients, worst rel err {rels[worst]:.2e} ({worst}), "
          f"norms {min(float(g.norm()) for g in k_grads.values()):.3e} to "
          f"{max(float(g.norm()) for g in k_grads.values()):.3e}")
    check(loss_err <= 1e-4, f"ABMIL step losses {k_loss} against plain {p_loss}")
    check(rels[worst] <= 2e-2, f"ABMIL gradients against plain: {rels}")

    before = {k: v.detach().clone() for k, v in named}
    eng.train_step(s.bank, ids, torch.Generator().manual_seed(0))
    still = [k for k in k_grads if torch.equal(before[k], dict(named)[k])]
    check(not still, f"ABMIL stage-1 step left {still} unchanged")
    del s, eng, before, k_grads, p_grads
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_rel_err": rels[worst], "spread": spread}


def make_slides(root):
    """The heatmap path's data: one feature npz per slide (dim 512, f32) in
    the data contract, a manifest, coord JSONs as the tiling step writes
    them, and each slide as an in-memory ``ImageSlide`` (the GPU machine
    has no PIL), keyed by its path."""
    import numpy as np

    from murcl_tpu_torch.data import contract
    from murcl_tpu_torch.preprocess.slide_io import ImageSlide
    from murcl_tpu_torch.utils.general import dump_json

    cols, rows = HEAT_GRID
    rng = np.random.default_rng(11)
    root = Path(root)
    (root / "features").mkdir(parents=True)
    (root / "coords").mkdir()
    manifest, slides = [], {}
    for n in HEAT_SLIDES:
        case_id = f"slide_{n}"
        cells = np.sort(rng.choice(cols * rows, size=n, replace=False))
        grid = np.stack([cells // cols, cells % cols], axis=1)
        feat_path = root / "features" / f"{case_id}.npz"
        contract.save_features_npz(feat_path, case_id, rows, cols,
                                   rng.standard_normal((n, FIN), dtype=np.float32), grid)
        slide_path = str(root / f"{case_id}.svs")
        slides[slide_path] = ImageSlide(slide_path, image=rng.integers(
            0, 256, (rows * HEAT_PATCH, cols * HEAT_PATCH, 3), dtype=np.uint8))
        dump_json({"slide_filepath": slide_path, "magnification": 20,
                   "magnification_level0": 20, "num_row": rows, "num_col": cols,
                   "patch_size": 224, "patch_size_level0": HEAT_PATCH, "num_patches": n,
                   "coords": [{"row": int(r), "col": int(c), "x": int(c) * HEAT_PATCH,
                               "y": int(r) * HEAT_PATCH} for r, c in grid]},
                  root / "coords" / f"{case_id}.json")
        manifest.append({"case_id": case_id, "features_filepath": str(feat_path), "label": 0})
    contract.save_manifest(root / "slides.csv", manifest)
    return slides


def png_shape(path) -> tuple:
    """(height, width, channels) from a PNG's header (8-bit RGB only)."""
    import struct

    head = Path(path).read_bytes()[:26]
    check(head[:8] == b"\x89PNG\r\n\x1a\n" and head[12:16] == b"IHDR", f"{path}: not a PNG")
    w, h, depth, colour = struct.unpack(">IIBB", head[16:26])
    check(depth == 8 and colour == 2, f"{path}: not 8-bit RGB")
    return h, w, 3


def heatmap_path(dev, root, checkpoint):
    """``run_heatmaps`` over 3 slides (2,000, 12,000 and 60,000 patches, dim
    512, f32) from the CLAM_SB MuRCL stage-3 ``model_best``, launch counts
    reset first: K2's forward once, K8 twice, nothing else; one PNG of the
    thumbnail's shape per slide, finite scores. Then the same run through
    the plain twins: the scores within 1e-4. Prints, per slide, the load,
    score (CUDA events around the scorer's call: copies in and out and the
    kernels), paint and write times. Returns the launch counts."""
    import torch

    from murcl_tpu_torch.create_heatmaps import parse_args
    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.preprocess import heatmaps as hm

    t0 = time.time()
    slides = make_slides(root)
    print(f"heatmap slides written in {time.time() - t0:.1f} s")
    scores, device_ms = [], []

    class TimedScorer(hm.AttentionScorer):
        def __call__(self, feats):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = super().__call__(feats)
            end.record()
            end.synchronize()
            device_ms.append(start.elapsed_time(end))
            scores.append(torch.tensor(out))
            return out

    args = parse_args(["--data_csv", str(root / "slides.csv"), "--coord_dir",
                       str(root / "coords"), "--save_dir", str(root / "heatmaps"),
                       "--checkpoint", checkpoint, "--device", str(dev.index),
                       "--bucket", str(BUCKET), "--exist_ok"])
    saved = hm.open_slide, hm.AttentionScorer
    hm.open_slide, hm.AttentionScorer = slides.__getitem__, TimedScorer
    try:
        _cuda.reset_launch_counts()
        records = hm.run_heatmaps(args)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        _cuda.reset_launch_counts()
        with plain_twins():
            hm.run_heatmaps(args)
        check(not any(_cuda.LAUNCHES.values()), f"plain heatmaps launched {_cuda.LAUNCHES}")
    finally:
        hm.open_slide, hm.AttentionScorer = saved
    want = {k: 0 for k in launches}
    want.update(fused_trunk_fwd=1, attention_pool_tiled=2)
    check(launches == want, f"heatmap path launches {launches}")
    cols, rows = HEAT_GRID
    for rec, got, plain, ms in zip(records, scores, scores[3:], device_ms):
        n = rec["num_patches"]
        shape = png_shape(rec["path"])
        check(shape == (rows * HEAT_PATCH, cols * HEAT_PATCH, 3), f"{rec['path']}: {shape}")
        check(got.shape == (n,) and bool(torch.isfinite(got).all()), f"{rec['case_id']} scores")
        err = rel_err(got, plain)
        check(err <= 1e-4, f"{rec['case_id']}: kernel scores against plain, rel err {err}")
        print(f"heatmap {rec['case_id']} ({n} patches, padded {-(-n // BUCKET) * BUCKET}): "
              f"load {rec['load_ms']:.1f} ms, score {ms:.2f} ms on the device "
              f"({rec['score_ms']:.2f} ms host), paint {rec['paint_ms']:.1f} ms, write "
              f"{rec['write_ms']:.1f} ms; scores against plain twins rel err {err:.2e}, "
              f"max abs {float((got - plain).abs().max()):.2e}")
    check(len(records) == len(HEAT_SLIDES) and len(scores) == 2 * len(HEAT_SLIDES),
          f"{len(records)} heatmaps, {len(scores)} scorings")
    print(f"heatmap path launches {launches}")
    return launches


def rlmil_args(dev, ds, results, stage, pretrained, **extra):
    from murcl_tpu_torch.drivers.rlmil import default_args

    return default_args(data_csv=ds["data_csv"], data_split_json=ds["rlmil_split_json"],
                        device=str(dev), train_method="finetune", train_stage=stage,
                        checkpoint_pretrained=pretrained if stage < 3 else None,
                        batch_size=RL_BATCH, feat_size=N_MAIN, T=T, compute_dtype="bfloat16",
                        epochs=1, ppo_epochs=1, save_model=True,
                        base_save_dir=str(results), **extra)


def rlmil_path(dev, ds, results, pretrained):
    """Supervised stages 1 -> 2 -> 3; per stage the launch counts."""
    import torch

    from murcl_tpu_torch.drivers.rlmil import run
    from murcl_tpu_torch.ops import _cuda

    per_stage = {}
    for stage in (1, 2, 3):
        args = rlmil_args(dev, ds, results, stage, pretrained)
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = run(args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        per_stage[stage] = launches
        run_dir = Path(out["save_dir"])
        check(run_dir.name == f"stage_{stage}", f"stage {stage} ran in {run_dir}")
        check(all(math.isfinite(v) for v in out["final"] + tuple(out["train_losses"])),
              f"stage {stage}: {out['final']} {out['train_losses']}")
        for name in ("checkpoint.pth.tar", "model_best.pth.tar", "pred.csv", "final_res.csv"):
            check((run_dir / name).exists(), f"stage {stage}: no {name}")
        ckpt = torch.load(run_dir / "checkpoint.pth.tar", map_location="cpu", weights_only=True)
        check((ckpt["policy"] is not None) == (stage > 1), f"stage {stage}: policy entry")
        check(launches["compact"] > 0 and launches["attention_pool_fwd"] > 0,
              f"stage {stage}: compaction or K7f never launched: {launches}")
        check((launches["attention_pool_bwd"] > 0) == (stage != 2),
              f"stage {stage}: K7b launches {launches['attention_pool_bwd']}")
        print(f"RLMIL stage {stage}: train loss {out['train_losses'][0]:.6f}, final test "
              f"(loss, acc, auc, precision, recall, f1) {out['final']}, "
              f"{out['steps_per_sec']:.4f} steps/s over the epoch (first step included), "
              f"run() wall {wall:.2f} s, launches {launches}")
    return per_stage


def steady_steps(dev, ds, results, pretrained):
    """Steady supervised steps at batch 64, stage 3 then stage 1: 2 warm-up
    steps, a host clock around 5 synchronised steps, then a torch.profiler
    trace of 3 more. Returns ``{stage: ms per step}``."""
    import torch

    from murcl_tpu_torch.drivers.rlmil import setup

    out = {}
    for stage in (3, 1):
        s = setup(rlmil_args(dev, ds, results, stage, pretrained, exist_ok=True))
        bank = s.banks["train"]
        gen = torch.Generator().manual_seed(0)
        ids = torch.arange(RL_BATCH, device=dev)

        def step():
            s.engine.train_step(bank, ids, gen)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        times, host = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            host.append((time.perf_counter() - t0) * 1e3)  # enqueued, not yet synced
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[stage] = statistics.median(times)
        print(f"supervised stage {stage}, batch {RL_BATCH}: median step {out[stage]:.2f} ms "
              f"({1e3 / out[stage]:.3f} steps/s), host enqueue {statistics.median(host):.2f} "
              f"ms, steps {[round(t, 2) for t in times]}")
        profile_steps(step, f"stage {stage}", out[stage])
        del s
        torch.cuda.empty_cache()
    return out


def steady_murcl_steps(dev, ds, results):
    """Steady MuRCL steps at batch 128: CLAM_SB stage 1 (the ``bench.py``
    step), ABMIL stage 1, then CLAM_SB stage 3 (which chains on the CLAM_SB
    path's stage 2). Returns ``{name: ms}``."""
    import torch

    from murcl_tpu_torch.drivers.murcl import setup

    out = {}
    for arch, stage in (("CLAM_SB", 1), ("ABMIL", 1), ("CLAM_SB", 3)):
        s = setup(murcl_args(dev, ds, results, arch, stage, exist_ok=True))
        gen = torch.Generator().manual_seed(0)
        ids = torch.arange(BATCH, device=dev) % SLIDES

        def step():
            s.engine.train_step(s.bank, ids, gen)

        for _ in range(2):
            step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, host = [], []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            host.append((time.perf_counter() - t0) * 1e3)  # enqueued, not yet synced
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        name = f"MuRCL {arch} stage {stage}"
        out[name] = statistics.median(times)
        print(f"{name}, batch {BATCH}: median step {out[name]:.2f} ms "
              f"({1e3 / out[name]:.3f} steps/s), host enqueue {statistics.median(host):.2f} ms, "
              f"steps {[round(t, 2) for t in times]}, "
              f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        profile_steps(step, name, out[name])
        del s
        torch.cuda.empty_cache()
    return out


def profile_steps(step, what: str, step_ms: float, n: int = 3) -> None:
    """Device time by kernel over ``n`` traced steps, and the union of the
    kernel intervals per step against the untraced step time ``step_ms``."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = collections.defaultdict(float)
    for e in kernels:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e3 / n
    busy, end = 0.0, float("-inf")
    for a, b in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if b > end:  # union of kernel intervals, us
            busy += b - max(a, end)
            end = b
    busy_ms = busy / 1e3 / n
    print(f"profile {what}: device busy {busy_ms:.2f} ms per step, "
          f"{100 * busy_ms / step_ms:.2f}% of the untraced {step_ms:.2f} ms step; "
          f"device ms per step by kernel ({len(kernels) / n:.0f} launches per step):")
    for name, ms in sorted(by_name.items(), key=lambda r: -r[1])[:12]:
        print(f"  {ms:9.3f}  {name[:110]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from murcl_tpu_torch.ops import _cuda

    card = card_line()
    print(f"card: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    t0 = time.time()
    _cuda.library()
    print(f"kernels built and loaded in {time.time() - t0:.1f} s")
    counts = check_sass()
    print("tensor-core instructions (HMMA/HGMMA) in the K2/K3, K7 and K8 kernels' SASS: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))

    k1 = check_compaction(dev, gen)
    print(f"K1 compaction bitwise ok; {k1['ms']:.3f} ms vs plain {k1['plain_ms']:.3f} ms, "
          f"bound {k1['bound_ms']:.4f} ms at ({B_MAIN}, {N_MAIN}, {FIN}); at K5's shape "
          f"({RL_BATCH}, {N_MAIN}, {FIN}) {k1['k5_ms']:.3f} ms vs plain "
          f"{k1['k5_plain_ms']:.3f} ms, bound {k1['k5_bound_ms']:.4f} ms, "
          f"{k1['k5_slices']} slot slices per bag ({card})")
    k4f, k4b = check_ntxent(dev, gen)
    print(f"K4 NT-Xent at ({BATCH}, 128) x 2 f32: fwd {k4f['ms']:.4f} ms vs plain "
          f"{k4f['plain_ms']:.4f} ms (device {k4f['device_ms']:.4f} vs "
          f"{k4f['plain_device_ms']:.4f}), bwd {k4b['ms']:.4f} ms vs plain "
          f"{k4b['plain_ms']:.4f} ms (device {k4b['device_ms']:.4f} vs "
          f"{k4b['plain_device_ms']:.4f}) ({card})")
    k2, k3 = check_fused(dev, gen)
    print(f"K2 fused fwd {k2['ms']:.2f} ms vs plain {k2['plain_ms']:.2f} ms; "
          f"K3 bwd {k3['ms']:.2f} ms vs plain {k3['plain_ms']:.2f} ms ({card})")
    print(f"K2 ungated {k2['ungated_ms']:.2f} ms vs plain {k2['ungated_plain_ms']:.2f} ms; "
          f"K3 ungated {k3['ungated_ms']:.2f} ms vs plain {k3['ungated_plain_ms']:.2f} ms, "
          f"unmixed {k3['unmixed_ms']:.2f} ms vs plain {k3['unmixed_plain_ms']:.2f} ms, "
          f"unmixed with dh {k3['dh_ms']:.2f} ms vs plain {k3['dh_plain_ms']:.2f} ms ({card})")
    k7f, k7b = check_pool(dev, gen)
    print(f"K7 pool fwd {k7f['ms']:.2f} ms vs plain {k7f['plain_ms']:.2f} ms, bound "
          f"{k7f['bound_ms']:.4f} ms; K7 bwd {k7b['ms']:.2f} ms vs plain {k7b['plain_ms']:.2f} ms, "
          f"bound {k7b['bound_ms']:.4f} ms at ({POOL_BAGS}, {N_MAIN}, {L1}) bf16 gated, D {D}, "
          f"dropout 0.25 ({card})")
    print(f"K7 ABMIL mode (ungated, D {ABMIL_D}, dropout 0) at ({B_MAIN}, {N_MAIN}, {L1}) "
          f"bf16: fwd {k7f['abmil_ms']:.2f} ms vs plain {k7f['abmil_plain_ms']:.2f} ms, bound "
          f"{k7f['abmil_bound_ms']:.4f} ms; bwd {k7b['abmil_ms']:.2f} ms vs plain "
          f"{k7b['abmil_plain_ms']:.2f} ms, bound {k7b['abmil_bound_ms']:.4f} ms ({card})")
    k6 = check_mixup(dev, gen)
    print(f"K6 mixup bitwise ok; {k6['ms']:.3f} ms vs plain {k6['plain_ms']:.3f} ms at "
          f"({B_MAIN}, {N_MAIN}, {FIN}) bf16 ({k6['gbps']:.0f} GB/s moved); "
          f"{k6['ms_f32']:.3f} ms vs plain {k6['plain_ms_f32']:.3f} ms at "
          f"({B_MAIN // 8}, {N_MAIN}, {FIN}) f32 ({card})")
    k8 = check_tiled(dev, gen)
    print(f"K8 gated f32 at (1, 60416, {L1}) {k8['ms']:.3f} ms vs plain {k8['plain_ms']:.3f} ms, "
          f"bound {k8['bound_ms']:.4f} ms (TF32; FMA tiles' bound {k8['fma_bound_ms']:.4f}); at (1, "
          f"12288, {L1}) {k8['ms_12288']:.3f} vs {k8['plain_ms_12288']:.3f} ms; bf16 at (1, "
          f"60416, {L1}) {k8['ms_bf16']:.3f} vs {k8['plain_ms_bf16']:.3f} ms; the op's backward "
          f"(K7b) at (1, 60416, {L1}) f32 {k8['bwd_ms']:.3f} vs {k8['bwd_plain_ms']:.3f} ms "
          f"({card})")

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=work))
    try:
        t0 = time.time()
        ds = make_dataset(tmp / "data")
        print(f"synthetic dataset written in {time.time() - t0:.1f} s")
        clam_stages, pretrained = murcl_path(dev, ds, tmp / "murcl", "CLAM_SB")
        heat = heatmap_path(dev, tmp / "slides", pretrained)
        abmil_stages, _ = murcl_path(dev, ds, tmp / "murcl", "ABMIL")
        abmil_step_check(dev, ds, tmp / "murcl")
        rl_stages = rlmil_path(dev, ds, tmp / "rlmil", pretrained)
        steady_steps(dev, ds, tmp / "rlmil", pretrained)
        steady_murcl_steps(dev, ds, tmp / "murcl")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    for counts in [*clam_stages.values(), *abmil_stages.values(), *rl_stages.values(), heat]:
        for k, v in counts.items():
            launches[k] += v

    base = "murcl_tpu_torch/csrc/"
    rows = [
        ("compact", base + "compact.cu",
         "murcl_tpu/ops/compact_pallas.py:296 (also serves :164 and :52)", k1),
        ("mixup_rows", base + "mixup.cu", "murcl_tpu/ops/compact_pallas.py:419", k6),
        ("fused_trunk_fwd", base + "fused_trunk.cu",
         "murcl_tpu/ops/attention_pallas.py:563", k2),
        ("fused_trunk_bwd", base + "fused_trunk.cu",
         "murcl_tpu/ops/attention_pallas.py:642", k3),
        ("ntxent_fwd", base + "ntxent.cu", "murcl_tpu/ops/ntxent_pallas.py:45", k4f),
        ("ntxent_bwd", base + "ntxent.cu", "murcl_tpu/ops/ntxent_pallas.py:58", k4b),
        ("attention_pool_fwd", base + "attention_pool.cu",
         "murcl_tpu/ops/attention_pallas.py:177", k7f),
        ("attention_pool_bwd", base + "attention_pool.cu",
         "murcl_tpu/ops/attention_pallas.py:250", k7b),
        ("attention_pool_tiled", base + "attention_tiled.cu",
         "murcl_tpu/ops/attention_pallas.py:1115", k8),
    ]
    # library_ms: no single PyTorch call computes any of these functions
    # (PERF.md, section 6)
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                "library_ms": None} for n, src, rep, r in rows]
    for row in kernels:  # the modes each attention row was held in
        if row["name"].startswith("fused_trunk"):
            row["modes"] = ("gated and ungated, mixed and unmixed"
                            + ("; bags' gradient dh" if row["name"].endswith("bwd") else ""))
        if row["name"] in ("attention_pool_fwd", "attention_pool_bwd"):
            row["modes"] = (f"gated and ungated at D {D}; gated at D {CLAM_BIG_D} (bf16) and on "
                            f"{TAIL_N}-row bags; ungated at D {ABMIL_D} (ABMIL)")
        if row["name"] == "attention_pool_tiled":
            row["modes"] = ("gated and ungated, f32 and bf16; timed f32 gated at (1, 60416, 512); "
                            "bound of the function's f32 products at the TF32 rate")
            row.update({k: k8[k] for k in ("ms_12288", "plain_ms_12288",
                                           "bound_ms_12288", "ms_bf16", "plain_ms_bf16",
                                           "bound_ms_bf16", "bwd_ms", "bwd_plain_ms")})
        if row["name"] == "compact":
            row.update({k: k1[k] for k in ("k5_ms", "k5_plain_ms", "k5_bound_ms")})
        if row["name"].startswith("ntxent"):
            r = k4f if row["name"] == "ntxent_fwd" else k4b
            row.update({k: r[k] for k in ("device_ms", "plain_device_ms", "autograd_ms",
                                          "autograd_plain_ms")})
            row["modes"] = (f"{', '.join(f'({b}, {d})' for b, d in NTXENT_SHAPES)} x 2 f32, with "
                            f"and without a zero row; timed at ({BATCH}, 128)")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
