#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``murcl_tpu_torch``) on one GPU.

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from ``murcl_tpu_torch/csrc``.
3. Holds each kernel against its plain PyTorch twin on the card at the main
   path's per-bag shapes, and times both at the full stage-1 shape:
   K1 compaction bitwise (f32, bf16); K4 NT-Xent loss and grads <= 1e-5
   abs; K2/K3 fused trunk + attention relative Frobenius error <= 1e-4 in
   f32 and <= 2e-2 in bf16 at dropout 0 and 0.25, with the kernel's trunk
   keep rate within 1% of 0.75.
4. Drives the main path: ``murcl_tpu_torch.drivers.murcl.run`` at stage 1,
   CLAM_SB, batch 128, feat_size 1024, dim 512, T 6, K 10, bf16, one epoch
   (5 steps) on a synthetic dataset of 64 slides x 2048 patches, and checks
   a finite loss, the checkpoint, and that every kernel launched.

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


def main_path(dev):
    import numpy as np
    import torch

    from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
    from murcl_tpu_torch.drivers.murcl import default_args, run
    from murcl_tpu_torch.ops import _cuda

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=work))
    try:
        ids = [f"synt_{i:03d}" for i in range(SLIDES)]
        ds = generate_synthetic_dataset(tmp / "data", num_slides=SLIDES, dim=FIN,
                                        num_clusters=K, slide_patches=PATCHES, seed=985,
                                        splits={"train": ids, "valid": ids[:2],
                                                "test": ids[:2]})
        args = default_args(data_csv=ds["data_csv"], data_split_json=ds["data_split_json"],
                            device=str(dev.index), train_stage=1, arch="CLAM_SB",
                            batch_size=BATCH, feat_size=N_MAIN, T=T,
                            compute_dtype="bfloat16", data_repeat=10, epochs=1,
                            base_save_dir=str(tmp / "results"), save_dir="run")
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = run(args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        check(math.isfinite(out["best_loss"]), f"loss {out['best_loss']}")
        check((Path(out["save_dir"]) / "checkpoint.pth.tar").exists(), "no checkpoint")
        check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
        check(np.isfinite(out["steps_per_sec"]), "no step rate")
        print(f"main path: 5 stage-1 steps, loss {out['best_loss']:.6f}, "
              f"{out['steps_per_sec']:.4f} steps/s over the epoch (first step included), "
              f"run() wall {wall:.2f} s, launches {launches}")
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


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
    print(f"K1 compaction bitwise ok; {k1['ms']:.3f} ms vs plain {k1['plain_ms']:.3f} ms "
          f"({card})")
    k4f, k4b = check_ntxent(dev, gen)
    print(f"K4 NT-Xent fwd {k4f['ms']:.4f} ms vs plain {k4f['plain_ms']:.4f} ms, "
          f"bwd {k4b['ms']:.4f} ms vs plain {k4b['plain_ms']:.4f} ms ({card})")
    k2, k3 = check_fused(dev, gen)
    print(f"K2 fused fwd {k2['ms']:.2f} ms vs plain {k2['plain_ms']:.2f} ms; "
          f"K3 bwd {k3['ms']:.2f} ms vs plain {k3['plain_ms']:.2f} ms ({card})")
    launches = main_path(dev)

    base = "murcl_tpu_torch/csrc/"
    rows = [
        ("compact", base + "compact.cu", "murcl_tpu/ops/compact_pallas.py:296", k1),
        ("fused_trunk_fwd", base + "fused_trunk.cu",
         "murcl_tpu/ops/attention_pallas.py:563", k2),
        ("fused_trunk_bwd", base + "fused_trunk.cu",
         "murcl_tpu/ops/attention_pallas.py:642", k3),
        ("ntxent_fwd", base + "ntxent.cu", "murcl_tpu/ops/ntxent_pallas.py:45", k4f),
        ("ntxent_bwd", base + "ntxent.cu", "murcl_tpu/ops/ntxent_pallas.py:58", k4b),
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
