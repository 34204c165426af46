#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``murcl_tpu_torch``) on one GPU.

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from ``murcl_tpu_torch/csrc`` (one nvcc
   per source, in parallel).
3. Holds each kernel against its plain PyTorch twin on the card at the
   paths' per-bag shapes, and times both at the full shapes:
   K1 compaction bitwise (f32, bf16) at the MuRCL stage-1 shape and at the
   supervised per-step shape (64 distinct slides, the JAX package's K5);
   K4 NT-Xent loss and grads <= 1e-5 abs; K2/K3 fused trunk + attention and
   K7 attention pool (gated and ungated) relative Frobenius error <= 1e-4
   in f32 and <= 2e-2 in bf16 at dropout 0 and 0.25, with the kernels' keep
   rates within 1% of 0.75.
4. Drives the paths on one synthetic dataset of 192 slides x 2048 patches
   (dim 512, K 10), every launch count set to 0 before a path and read
   after it:
   - MuRCL pretraining, ``murcl_tpu_torch.drivers.murcl.run`` at stage 1,
     CLAM_SB, batch 128, feat_size 1024, T 6, bf16, one epoch (5 steps) on
     64 slides: a finite loss, the checkpoint, every kernel launched;
   - supervised RLMIL, ``murcl_tpu_torch.drivers.rlmil.run``, finetune
     stages 1 -> 2 -> 3 from that checkpoint on 128 / 32 / 32 slides, batch
     64, feat_size 1024, T 6, bf16, one epoch each (2 steps; stage 2 one
     PPO epoch): finite losses, each stage's checkpoints (with the policy
     in stages 2 and 3), ``pred.csv`` and ``final_res.csv``; compaction and
     K7f launched in every stage, K7b in stages 1 and 3 and not in stage 2.
5. Times steady supervised steps at batch 64 (stage 3, then stage 1): 2
   warm-up steps, then a host clock around 5 synchronised steps; then
   ``torch.profiler`` traces 3 more steps of each and prints device time by
   kernel and the device's busy share.

Prints the kernel table as one JSON line, the card line, and as its last
line ``{"ok": true, "device": {...}}``. Any failure exits nonzero before
that line. Run from the repository root: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import json
import math
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


def run_fused(h, w, mask, dropout, seed, mix, cots):
    """Kernels K2 + K3 through the op's autograd: ``(M, p, s, *8 grads)``."""
    import torch

    from murcl_tpu_torch.ops.attention import fused_trunk_attention_pool

    ws = [x.detach().clone().requires_grad_(True) for x in w]
    outs = fused_trunk_attention_pool(h, *ws, mask=mask, dropout=dropout, seed=seed,
                                      mix=mix)
    torch.autograd.backward(outs, cots)
    return [o.detach() for o in outs] + [x.grad for x in ws]


def run_plain(h, w, mask, dropout, seed, mix, cots):
    """The plain PyTorch twins on the same (CUDA) tensors."""
    from murcl_tpu_torch.ops.attention import fused_trunk_plain_bwd, fused_trunk_plain_fwd

    m, p, s = fused_trunk_plain_fwd(h, *w, mask, dropout, seed, *mix)
    return [m, p, s, *fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, dropout, seed, *mix)]


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
        1, ptr(o["h"]), None, None, ptr(o["wf"]), ptr(o["bf"]), ptr(o["wa"]), ptr(o["ba"]),
        ptr(o["wb"]), ptr(o["bb"]), ptr(o["wc"]), ptr(bc), ptr(o["mask"]), *drop, ptr(xc),
        ptr(m), ptr(p), ptr(s), b, N_MAIN, FIN, L1, D, _cuda.stream())
    _cuda.check(err, "keep-rate probe")
    torch.cuda.synchronize()
    return float((xc != 0).float().mean())


def check_compaction(dev, gen):
    import torch

    from murcl_tpu_torch.data.bank import bank_from_arrays
    from murcl_tpu_torch.ops.compact import _gather_compact_cuda, gather_compact_plain
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
    # the supervised per-step shape (the JAX package's K5): 64 distinct slides
    ids = torch.randperm(SLIDES, generator=gen, device=dev)[:RL_BATCH]
    actions = torch.rand(RL_BATCH, K, generator=gen, device=dev)
    ranks, offs, _ = select_ranks(ids, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                  actions, bank.patch_cluster, bank.patch_pos, N_MAIN)
    nump = bank.num_patches[ids]
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
    res["max_abs_err"] = 0.0
    return res


def check_ntxent(dev, gen):
    import torch

    from murcl_tpu_torch.ops.ntxent import _NTXent, nt_xent_plain

    errs_f, errs_b = [], []
    for zero_row in (False, True):
        zi = torch.randn(BATCH, 128, generator=gen, device=dev)
        zj = torch.randn(BATCH, 128, generator=gen, device=dev)
        if zero_row:
            zi[3] = 0.0
        outs = []
        for fn in (_NTXent.apply, nt_xent_plain):
            a, b = zi.clone().requires_grad_(True), zj.clone().requires_grad_(True)
            loss = fn(a, b, 0.5)
            loss.backward()
            outs.append((loss.detach(), a.grad, b.grad))
        (lk, gik, gjk), (lp, gip, gjp) = outs
        errs_f.append(float((lk - lp).abs()))
        # the clamped zero row's gradient is dzn / 1e-8: held relatively
        scale = max(1.0, float(gip.abs().max()), float(gjp.abs().max()))
        errs_b.append(max(float((gik - gip).abs().max()), float((gjk - gjp).abs().max()))
                      / (scale if zero_row else 1.0))
    check(max(errs_f) <= 1e-5, f"K4 forward error {errs_f}")
    check(max(errs_b) <= 1e-5, f"K4 backward error {errs_b}")
    zi = torch.randn(BATCH, 128, generator=gen, device=dev, requires_grad=True)
    zj = torch.randn(BATCH, 128, generator=gen, device=dev, requires_grad=True)
    g = torch.ones((), device=dev)
    fwd = {"ms": median_ms(lambda: _NTXent.apply(zi, zj, 0.5), reps=20),
           "plain_ms": median_ms(lambda: nt_xent_plain(zi, zj, 0.5), reps=20),
           "max_abs_err": max(errs_f)}
    lk, lp = _NTXent.apply(zi, zj, 0.5), nt_xent_plain(zi, zj, 0.5)
    bwd = {"ms": median_ms(lambda: torch.autograd.grad(lk, (zi, zj), g, retain_graph=True),
                           reps=20),
           "plain_ms": median_ms(lambda: torch.autograd.grad(lp, (zi, zj), g,
                                                             retain_graph=True), reps=20),
           "max_abs_err": max(errs_b)}
    return fwd, bwd


def check_fused(dev, gen):
    import torch

    from murcl_tpu_torch.ops.attention import _FusedTrunkAttention

    names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    err_f, err_b = 0.0, 0.0
    cases = [(torch.float32, 0.0, 1e-4, True), (torch.bfloat16, 0.0, 2e-2, True),
             (torch.bfloat16, 0.25, 2e-2, False)]
    for dtype, rate, tol, masked in cases:
        h, w, mask, mix, cots = fused_inputs(CHECK_BAGS, dtype, gen, dev, masked)
        got = run_fused(h, w, mask, rate, 77, mix, cots)
        want = run_plain(h, w, mask, rate, 77, mix, cots)
        rels = {n: rel_err(g, wv) for n, g, wv in zip(names, got, want)}
        print(f"K2/K3 {dtype} dropout {rate}: rel err "
              + ", ".join(f"{n} {v:.2e}" for n, v in rels.items()))
        check(max(rels.values()) <= tol, f"K2/K3 {dtype} dropout {rate}: {rels}")
        err_f = max(err_f, *(float((g - wv).abs().max()) for g, wv in zip(got[:3], want[:3])))
        err_b = max(err_b, *(float((g - wv).abs().max()) for g, wv in zip(got[3:], want[3:])))
        del h, got, want
    keep = trunk_keep_rate(dev)
    print(f"K2 trunk keep rate at dropout 0.25: {keep:.5f}")
    check(abs(keep - 0.75) <= 0.0075, f"keep rate {keep}")

    # timing at the main path's full shape: bf16, dropout 0.25, in-kernel mix
    h, w, mask, mix, cots = fused_inputs(B_MAIN, torch.bfloat16, gen, dev, False)
    ws = [x.detach().clone().requires_grad_(True) for x in w]
    perm, lam = mix
    args = (h, *ws, mask, 0.25, 77, perm, lam)
    _, p, _ = _FusedTrunkAttention.apply(*args)
    p = p.detach()
    from murcl_tpu_torch.ops import attention as att

    k_fwd = median_ms(lambda: att._fwd_cuda(h, *w, mask, 0.25, 77, perm, lam), reps=3)
    k_bwd = median_ms(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77, perm, lam),
                      reps=3)
    del ws
    torch.cuda.empty_cache()
    p_fwd = median_ms(lambda: att.fused_trunk_plain_fwd(h, *w, mask, 0.25, 77, perm, lam),
                      reps=3)
    p_bwd = median_ms(lambda: att.fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, 0.25, 77,
                                                        perm, lam), reps=3)
    return ({"ms": k_fwd, "plain_ms": p_fwd, "max_abs_err": err_f},
            {"ms": k_bwd, "plain_ms": p_bwd, "max_abs_err": err_b})


def pool_inputs(b, dtype, gen, dev, masked: bool):
    import torch

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * sc

    w = [r(L1, D, sc=L1 ** -0.5), r(D, sc=0.1), r(L1, D, sc=L1 ** -0.5), r(D, sc=0.1),
         r(D, sc=D ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(b, N_MAIN, L1)).to(dtype)  # a trunk output: post-relu
    lengths = torch.randint(600, N_MAIN + 1, (b,), generator=gen, device=dev)
    mask = torch.arange(N_MAIN, device=dev)[None, :] < lengths[:, None]
    if not masked:
        mask = torch.ones_like(mask)
    cots = [r(b, L1), r(b, N_MAIN, sc=0.1), r(b, N_MAIN, sc=0.01)]
    return x, w, mask, cots


def gate_keep_rates(dev):
    """Share of gate units K7 keeps at dropout 0.25, read from its backward
    scratch: dza is nonzero exactly where the gate masks keep (stream 1
    ungated; streams 1 and 2 both gated, 0.75^2 = 0.5625)."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.ops.attention import _pool_args, _pool_fwd_cuda

    gen = torch.Generator(device=dev).manual_seed(11)
    b = 64
    x, w, mask, cots = pool_inputs(b, torch.bfloat16, gen, dev, False)
    cots[2] = cots[2] + 0.1 * torch.sign(cots[2])  # ds away from 0 on every row
    rates = {}
    for gated in (False, True):
        _, p, _ = _pool_fwd_cuda(x, *w, mask, gated, 0.25, 4321)
        o, drop = _pool_args(x, *w[:5], mask, 0.25, 4321)
        f32 = dict(dtype=torch.float32, device=dev)
        waT, wbT = w[0].T.contiguous(), w[2].T.contiguous()
        dza = torch.empty(b, N_MAIN, D, dtype=torch.bfloat16, device=dev)
        dzb = torch.empty_like(dza)
        dx = torch.empty_like(x)
        bufs = [torch.empty(b, N_MAIN, **f32), dza, dzb, dx, torch.empty(L1, D, **f32),
                torch.empty(D, **f32), torch.empty(L1, D, **f32), torch.empty(D, **f32),
                torch.empty(D, **f32), torch.empty((), **f32)]
        ptr = lambda t: t.data_ptr()  # noqa: E731
        err = _cuda.library().murcl_attention_pool_bwd(
            1, int(gated), ptr(o["x"]), ptr(o["wa"]), ptr(o["ba"]), ptr(o["wb"]), ptr(o["bb"]),
            ptr(o["wc"]), ptr(waT), ptr(wbT), ptr(o["mask"]), *drop, ptr(p), *map(ptr, cots),
            *map(ptr, bufs), b, N_MAIN, L1, D, _cuda.stream())
        _cuda.check(err, "gate keep-rate probe")
        torch.cuda.synchronize()
        rates[gated] = float((dza != 0).float().mean())
    return rates


def check_pool(dev, gen):
    import torch

    from murcl_tpu_torch.ops import attention as att

    names = ["M", "p", "s", "dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    err_f, err_b = 0.0, 0.0
    cases = [(torch.float32, 0.0, 1e-4), (torch.bfloat16, 0.0, 2e-2),
             (torch.bfloat16, 0.25, 2e-2)]
    for gated in (True, False):
        for dtype, rate, tol in cases:
            x, w, mask, cots = pool_inputs(POOL_CHECK_BAGS, dtype, gen, dev, True)
            xg = x.clone().requires_grad_(True)
            ws = [v.clone().requires_grad_(True) for v in w]
            outs = att._AttentionPool.apply(xg, *ws, mask, gated, rate, 77)
            torch.autograd.backward(outs, cots)
            got = [o.detach() for o in outs] + [xg.grad] + [v.grad for v in ws]
            m, p, s = att.gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, 77)
            want = [m, p, s, *att.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots,
                                                                  gated, rate, 77)]
            rels = {n: rel_err(g, wv) for n, g, wv in zip(names, got, want)
                    if gated or n not in ("dwb", "dbb")}
            print(f"K7 gated={gated} {dtype} dropout {rate}: rel err "
                  + ", ".join(f"{n} {v:.2e}" for n, v in rels.items()))
            check(max(rels.values()) <= tol, f"K7 gated={gated} {dtype} dropout {rate}: {rels}")
            err_f = max(err_f, *(float((g - wv).abs().max()) for g, wv in zip(got[:3], want[:3])))
            err_b = max(err_b, *(float((g.float() - wv.float()).abs().max())
                                 for g, wv in zip(got[3:], want[3:])))
            del x, xg, got, want
    rates = gate_keep_rates(dev)
    print(f"K7 gate keep rate at dropout 0.25: stream 1 {rates[False]:.5f}, "
          f"streams 1 and 2 {rates[True]:.5f}")
    check(abs(rates[False] - 0.75) <= 0.0075, f"gate keep rate {rates[False]}")
    check(abs(rates[True] - 0.5625) <= 0.005625, f"joint gate keep rate {rates[True]}")

    # timing at the supervised stage-1 shape: bf16, dropout 0.25, gated
    x, w, mask, cots = pool_inputs(POOL_BAGS, torch.bfloat16, gen, dev, False)
    _, p, _ = att._pool_fwd_cuda(x, *w, mask, True, 0.25, 77)
    k_fwd = median_ms(lambda: att._pool_fwd_cuda(x, *w, mask, True, 0.25, 77), reps=3)
    k_bwd = median_ms(lambda: att._pool_bwd_cuda(x, *w[:5], mask, p, *cots, True, 0.25, 77),
                      reps=3)
    torch.cuda.empty_cache()
    p_fwd = median_ms(lambda: att.gated_attention_pool_plain_fwd(x, *w, mask, True, 0.25, 77),
                      reps=3)
    p_bwd = median_ms(lambda: att.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots,
                                                                 True, 0.25, 77), reps=3)
    return ({"ms": k_fwd, "plain_ms": p_fwd, "max_abs_err": err_f},
            {"ms": k_bwd, "plain_ms": p_bwd, "max_abs_err": err_b})


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


def main_path(dev, ds, results):
    import numpy as np
    import torch

    from murcl_tpu_torch.drivers.murcl import default_args, run
    from murcl_tpu_torch.ops import _cuda

    args = default_args(data_csv=ds["data_csv"], data_split_json=ds["data_split_json"],
                        device=str(dev), train_stage=1, arch="CLAM_SB",
                        batch_size=BATCH, feat_size=N_MAIN, T=T, compute_dtype="bfloat16",
                        data_repeat=10, epochs=1, base_save_dir=str(results), save_dir="run")
    _cuda.reset_launch_counts()
    t0 = time.time()
    out = run(args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    check(math.isfinite(out["best_loss"]), f"loss {out['best_loss']}")
    check((Path(out["save_dir"]) / "checkpoint.pth.tar").exists(), "no checkpoint")
    used = ("compact", "fused_trunk_fwd", "fused_trunk_bwd", "ntxent_fwd", "ntxent_bwd")
    check(all(launches[k] > 0 for k in used), f"a kernel never launched: {launches}")
    check(np.isfinite(out["steps_per_sec"]), "no step rate")
    print(f"MuRCL path: 5 stage-1 steps, loss {out['best_loss']:.6f}, "
          f"{out['steps_per_sec']:.4f} steps/s over the epoch (first step included), "
          f"run() wall {wall:.2f} s, launches {launches}")
    return launches, str(Path(out["save_dir"]) / "model_best.pth.tar")


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
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[stage] = statistics.median(times)
        print(f"supervised stage {stage}, batch {RL_BATCH}: median step {out[stage]:.2f} ms "
              f"({1e3 / out[stage]:.3f} steps/s), steps {[round(t, 2) for t in times]}")
        profile_steps(step, f"stage {stage}", out[stage])
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

    k1 = check_compaction(dev, gen)
    print(f"K1 compaction bitwise ok; {k1['ms']:.3f} ms vs plain {k1['plain_ms']:.3f} ms at "
          f"({B_MAIN}, {N_MAIN}, {FIN}); at K5's shape ({RL_BATCH}, {N_MAIN}, {FIN}) "
          f"{k1['k5_ms']:.3f} ms vs plain {k1['k5_plain_ms']:.3f} ms ({card})")
    k4f, k4b = check_ntxent(dev, gen)
    print(f"K4 NT-Xent fwd {k4f['ms']:.4f} ms vs plain {k4f['plain_ms']:.4f} ms, "
          f"bwd {k4b['ms']:.4f} ms vs plain {k4b['plain_ms']:.4f} ms ({card})")
    k2, k3 = check_fused(dev, gen)
    print(f"K2 fused fwd {k2['ms']:.2f} ms vs plain {k2['plain_ms']:.2f} ms; "
          f"K3 bwd {k3['ms']:.2f} ms vs plain {k3['plain_ms']:.2f} ms ({card})")
    k7f, k7b = check_pool(dev, gen)
    print(f"K7 pool fwd {k7f['ms']:.2f} ms vs plain {k7f['plain_ms']:.2f} ms; "
          f"K7 bwd {k7b['ms']:.2f} ms vs plain {k7b['plain_ms']:.2f} ms at "
          f"({POOL_BAGS}, {N_MAIN}, {L1}) bf16, dropout 0.25 ({card})")

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=work))
    try:
        t0 = time.time()
        ds = make_dataset(tmp / "data")
        print(f"synthetic dataset written in {time.time() - t0:.1f} s")
        launches, pretrained = main_path(dev, ds, tmp / "murcl")
        per_stage = rlmil_path(dev, ds, tmp / "rlmil", pretrained)
        steady_steps(dev, ds, tmp / "rlmil", pretrained)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for counts in per_stage.values():
        for k, v in counts.items():
            launches[k] += v

    base = "murcl_tpu_torch/csrc/"
    rows = [
        ("compact", base + "compact.cu",
         "murcl_tpu/ops/compact_pallas.py:296 (also serves :164 and :52)", k1),
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
    ]
    kernels = [{"name": n, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[n], "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                "plain_ms": r["plain_ms"]} for n, src, rep, r in rows]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
