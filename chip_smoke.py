#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``murcl_tpu_torch``) on one GPU.

1. Requires CUDA; prints the card's name and power limit (nvidia-smi).
2. Builds the hand-written kernels from ``murcl_tpu_torch/csrc`` (one nvcc
   per source, in parallel), and reads the library's SASS with
   ``cuobjdump``: the K2/K3 and K7 kernels in both instantiations (bf16,
   and f32 as three bf16 products) must hold Hopper's warpgroup products
   (HGMMA), K8's gate products among them (K7f's ``pool_gates_fwd_wg``);
   K8's chunk pass (``chunk_kernel``) must be there in both instantiations
   and the earlier ``mma.sync`` kernel (``tiled_pool_tc``) and the probes'
   kernels nowhere. Then builds the probe library (``csrc/fused_trunk.cu``
   with the K2/K3 ablations of ``csrc/fused_trunk_ablate.cu`` and the
   overlap probe of ``csrc/wgmma_overlap.cu``, the one-hot compaction
   probes of ``csrc/compact_onehot.cu`` and the gate-mask writer of
   ``csrc/gate_masks.cu``), whose ablation kernels, overlap modes and
   one-hot kernels must hold HGMMA, but the overlap's vpu mode, the one-hot
   probes' dmafloor copy and the mask writer, which hold no products.
3. Holds each kernel against its plain PyTorch twin on the card at the
   paths' per-bag shapes, and times both at the full shapes:
   K1 compaction bitwise (f32, bf16) at every bag count the main paths
   launch (``COMPACT_SHAPES``: 1536, MuRCL stage 1; 256, its stages 2/3;
   384, supervised stage 1; 64 distinct slides, its stages 2/3, the JAX
   package's K5, each bag's slots over two blocks), each timed in both
   dtypes (one call by events, ten back to back, device time by
   torch.profiler) beside its twin, its bound and ``torch.index_select`` of
   the same live rows, and bitwise on ``tests/torch_compact_cases.py``'s
   cases at D 512; then selection's breakdown (``select_probe_path``, the
   port of ``scripts/dbg_select.py``), its launches and outputs held
   against the twins;
   K6 mixup bitwise in bf16 at (1536, 1024, 512) and in f32 at (192, 1024,
   512); K4 NT-Xent loss, residual and grads <= 1e-5 at (128, 128), (256,
   128) and (128, 100) x 2 f32, with and without a zero row, K4's loss and
   dz bitwise in two runs, K4 timed by event and by device time beside its
   plain pair; K2/K3 fused trunk +
   attention (gated and mixed; ungated; gated and ungated with the bags'
   gradient dh) and K7 attention pool (gated and ungated at D 256; gated at
   D 384 in bf16; gated at D 256 on bags of 1000 rows, not a multiple of
   the 64-row tile; ABMIL's mode, ungated at D 128, at dropout 0 only; at
   widths the op zero-pads to multiples of 128, (F, D) = (32, 8) and (512,
   64), gated and ungated, in both dtypes at dropout 0 and 0.25)
   relative Frobenius error <= 1e-4 in f32 and <= 2e-2 in bf16 at dropout 0
   and 0.25, with the kernels' keep rates within 1% of 0.75; K2 and K3
   timed gated and ungated, K3 also unmixed with and without dh, K7 at the
   supervised shape and in ABMIL's mode at (1536, 1024, 512), each beside
   its plain twin and its bound; K2's, K3's and K7's timed calls split by
   sub-kernel (K2: trunk, gates and pool; K3: trunk, softmax backward,
   gates, dx and its two weight-gradient passes, dWf and dWa + dWb; in f32
   also the planes' split and the refine of the trunk's pre-activations
   near relu's kink; K7f:
   gates and pool; K7b: W's planes, dp, softmax backward, gates, dx and
   one weight-gradient pass, dWa + dWb) with torch.profiler, each with its
   sub-kernels' achieved TFLOP/s and GB/s; K2/K3's f32 route (the CLIs'
   default) at (1536, 1024, 512) gated and mixed, ungated, and unmixed with
   dh, at dropout 0.25, and at the heatmap's (1, 3072, 512), relative
   Frobenius error <= 1e-4 on every output, timed beside the bound of its
   f32 products at TF32's rate; K7's f32 route (the supervised CLIs'
   default) gated and ungated at D 128, 256 and 384, dropout 0 and 0.25,
   on bags ending at the 128-row tiles' edges; K7's timed calls in both
   dtypes (the supervised shape, ABMIL's mode) and K7b in f32 at the
   heatmap's (1, 60416, 512) (K8's op backward) held to the twin at the
   same tolerances on their own inputs, then timed by sub-kernel beside
   the twin and the bound (in f32 its f32 products at TF32's rate or its
   bytes), failing unless K8's op backward beats its twin; K3 (with
   dh) and K7b run twice on the same inputs, the largest difference per
   output printed (the split-K weight gradients add with atomics; dh and
   K7's dx must be bitwise equal). K8 (the streaming attention pool: its
   gate products on K7f's warpgroup gate kernel, in f32 three bf16
   products per product, then a bytes-bound chunk pass and the chunks'
   merge) at the heatmap's largest bag (1, 60416, 512) f32 gated with a
   masked tail and at (4, 12288, 512) gated and ungated in f32 and bf16 (a
   bag ending mid-chunk, one with whole masked chunks), relative Frobenius
   error <= 1e-4 in f32 and <= 2e-2 in bf16; one backward through its op
   (K7b) at (1, 60416, 512) f32 within 1e-4 of the plain backward, timed;
   K8 timed at (1, 60416, 512) and (1, 12288, 512) f32 and bf16 beside its
   twin and its bound, split by sub-kernel (split_kernel, the gate pass,
   the chunk pass, the merge) with each one's achieved TFLOP/s and GB/s,
   and failing unless faster than the twin in f32.
   Then the K2/K3 probes (``ablation_path``): the ports of the JAX
   package's ``scripts/dbg_bwd_ablate.py``, ``dbg_vpu_lean.py`` and
   ``dbg_mxu_vpu_overlap.py`` at their JAX shapes ((1536, 1024, 512) -> 512
   -> 256; 256 steps of (1024, 512)), every launch count 0 before and read
   after: K3 full, nodrop, nowgrad, nodx and recompute in bf16 and f32 and
   K3's split printed (weight gradients, dx chain, floor, hash), K2/K3
   pre-lean against lean and K3 lean2 (bf16), the overlap probe's four
   modes and its verdict. Each variant's outputs from its last timed call
   are held against its twin on the same inputs at the scripts' shapes (the
   K2/K3 tolerances; dbc, which cancels near 0 at the scripts' zero score
   cotangent, against the twin's sum |ds|; lean2's dWf and dbf in bf16 at
   1e-3 and apart from the production kernel's; the gradients a variant
   skips exact zeros; K2's pre-lean bitwise its lean), and again at 64 bags
   with a score cotangent in both dtypes; the overlap's modes against
   theirs (2e-2) and bitwise against each other; the twins timed; K2/K3 at
   Fin 1000 (zero-padded) against the twin.
   Then the compaction and dropout probes (``compaction_probe_path``): the
   ports of the JAX package's ``scripts/tpu_smoke.py`` mask writer
   (``dropout_smoke.py``: K7's determinism per seed, its gate keep masks at
   (8, 256, 256), their keep rate within 0.02 of 0.75 and d/dwc within 1e-2
   of the pool rebuilt with them) and of its one-hot compaction probes
   (``dbg_compact_ablate.py``, ``dbg_grouped_ablate.py``,
   ``dbg_grouped_gate.py``: 1536 bags of 2048-row windows -> 1024 x 512
   bf16, bag by bag and 128 slides x 12 repeats in groups of 4), every
   launch count 0 before and read after, each with K1 timed on the same
   inputs: the masks bitwise their twin, every compaction variant bitwise
   its twin (``noonehot`` within 1e-2: f32 row sums in another order) and,
   where it keeps the result, K1's twin's, the twins timed; K2/K3 at L1
   200, D 100 (zero-padded to 256, 128, the dropout hashed at the logical
   widths) against the twin at the logical widths, bf16 mixed and f32 with
   dh, dropout 0.25.
4. Decodes JPEG tiles on the card with nvJPEG (``nvjpeg_path``): the
   committed fixture's tiles against PIL's decode, within
   ``FIXTURE_BOUND``, their rate, and a JPEG-tiled TIFF read through
   ``TiffSlide`` on the card. Fails where libnvjpeg does not load.
5. Preprocesses two synthetic 16,384 x 12,288 slides at 40x, written as
   deflate TIFF pyramids (downsamples 1, 4, 16) with an Aperio description
   and read through ``open_slide``, through the three entry points
   (``preprocess_path``): ``create_patches`` at 20x with 256-pixel patches
   (read at 512 px; ``rgb``, and slide 0 also ``otsu`` and ``adaptive``,
   and ``rgb`` from a single-level file of the same pixels, whose
   downsample runs on the card; host ms per phase), ``extract_features`` on
   the card with random ResNet18 weights at batch 256: threads with the
   exact resize (PIL's bicubic on the card, bit for bit with the host's
   ``resize_u8`` on 64 patches and on a 4,096 x 3,072 region downsampled
   16 times), threads with ``--resize_on_device``, and the process decode
   pool (patches/s, host ms per patch, the device's idle share under
   torch.profiler; the pool's features equal the threads'; 64 patches'
   features within 1e-4 of the port's CPU f32 forward), the encoder alone
   over 4,096 patches in f32 (TF32 off) and bf16 beside its bound,
   ``features_clustering`` on the card (K 10; inertia within 1e-4 of the
   port's CPU k-means; ms and iterations per slide); then
   ``WSIWithCluster`` loads the output and MuRCL CLAM_SB stage 1 (batch 2,
   feat_size 1024, bf16, ``--profile 2``, whose trace must name
   ``trunk_wg``) trains on it, launching K1, K2/K3 and K4.
   Then slides as Aperio's and Camelyon16's scanners write them
   (``jpeg_slide_path``): two JPEG-tiled pyramids of the same size, each
   level made of the four 256-pixel YCbCr 4:2:0 tiles of
   ``preprocess/fixtures/jpeg_tiles_256.npz``, tiled by ``create_patches``
   and read by ``extract_features``' 8 threads, their tiles decoded by
   nvJPEG and converted by ``csrc/ycc_rgb.cu`` (bitwise with its plain twin;
   patches/s, the device's idle share, the cost of opening a decoder per
   slide); 64 patches of slide 0 held against PIL's decode of the same
   tiles: pixels within ``FIXTURE_BOUND``, features within 1e-2.
6. Drives the paths on one synthetic dataset of 192 slides x 2048 patches
   (dim 512, K 10), every launch count set to 0 before a stage and read
   after it:
   - MuRCL CLAM_SB stages 1 -> 2 -> 3 through the CLI,
     ``train_MuRCL.main``, with the runbook's flags and no
     ``--compute_dtype``: float32, K2/K3's f32 route, 2 steps in stage 1;
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
     on a 1,200 x 800 slide read from a TIFF file): K2's forward once and K8 twice,
     nothing else; one PNG of the thumbnail's shape per slide; the scores
     equal to those through the plain twins within 1e-4; per slide the
     load, score, paint and write times;
   - supervised RLMIL, ``murcl_tpu_torch.drivers.rlmil.run``, stages 1 ->
     2 -> 3 on 128 / 32 / 32 slides, batch 64, feat_size 1024, T 6, bf16,
     one epoch each (2 steps; stage 2 one PPO epoch), three times: CLAM_SB
     finetune from the CLAM_SB MuRCL stage-3 ``model_best``, ABMIL finetune
     from the ABMIL one, and DSMIL from scratch. Per stage finite losses,
     the checkpoints (with the policy in stages 2 and 3), ``pred.csv`` and
     ``final_res.csv``, and the kernels: CLAM_SB and ABMIL launch
     compaction and K7f in every stage and K7b in stages 1 and 3 only;
     ABMIL never K2, K3 or K6; DSMIL compaction in every stage and no
     attention-pool or trunk kernel (its products are plain matmuls, as in
     the JAX package). Then one supervised ABMIL stage-1 step through the
     kernels and through their plain twins, compared as
     ``abmil_step_check`` compares (``supervised_step_check``). Then
     the PPO learning check, ``murcl_tpu_torch/scripts/ppo_sanity.py``
     (150 stage-1 steps and 15 x 8 PPO steps of 8 slides), at ABMIL's
     widths (dim 512, L 512, D 128) four times with the same seeds: through
     the kernels in f32 twice, through their plain twins in f32, and
     through the kernels in bf16; then at the JAX script's widths (32, 32,
     8; K7 zero-padded to 128) through the kernels in f32 and through the
     plain twins in f32 (``ppo_sanity_path``): each run's report line, its
     directions, the differences between the runs, and the checks of its
     docstring; the kernel runs' launches of K1, K7f and K7b count in the
     kernels line. Then supervised CLAM_SB stage 1 through the CLI,
     ``train_RLMIL.main``, with the runbook's fine-tuning flags and no
     ``--compute_dtype``: float32, K7's f32 route (``rlmil_cli_path``).
7. Times steady steps: supervised at batch 64 (CLAM_SB stage 3 and stage
   1, ABMIL stage 1, DSMIL stage 1; CLAM_SB stages 1 and 3 and ABMIL stage
   1 in float32), and MuRCL CLAM_SB stage 1 (the ``bench.py`` step), ABMIL
   stage 1 and CLAM_SB stage 3 at batch 128, and CLAM_SB stages 1 and 3 and
   ABMIL stage 1 in float32: 2
   warm-up steps, then a host clock around 5 synchronised steps, read also
   when the step call returns (the host's enqueue time), and the peak
   device memory; then ``torch.profiler`` traces 3 more steps of each and
   prints device time by kernel and the device's busy share
   (``murcl_tpu_torch/scripts/profiling.py``). Then the step diagnostics
   (``step_diagnostics_path``), the ports of the JAX package's
   ``scripts/profile_step.py``, ``profile_stages.py`` (stages 2 and 3),
   ``dbg_step.py`` and ``scale_smoke.py`` at their JAX shapes, every launch
   count 0 before a script and read after: the tables of top ops by device
   time (which must name the hand-written kernels), the step against its
   pieces (forward-only faster than the full step), the streaming stage-3
   steps/s and the full-bag pool's seconds, every loss and score finite,
   and the kernels each launches (``STEP_DIAG_KERNELS``). Where the
   parent commit's tree is unpacked under ``build/parent``, the A/B
   (``ab_parent``): K7f and K7b at the supervised stage-1 shape and in
   ABMIL's mode in bf16 and in f32, K2 and K3 through the op at the timed
   call in bf16 and in f32, K8 at (1, 60416, 512) and (1, 12288, 512) in
   f32 and bf16, K1 at ``COMPACT_SHAPES`` and a TCGA-like shape in both,
   and the steady steps of ``AB_STEPS``
   (supervised CLAM_SB stage 1 in bf16, and in f32 stages 1 and 3;
   supervised ABMIL stage 1 f32; MuRCL ABMIL stage 1 in bf16 and f32; MuRCL
   CLAM_SB stage 1 f32), of the parent's tree and of this one in turns
   (parent, this, this, parent), each side a process that imports and
   builds its own tree's port, all printed, none held (a redesign slower
   than its parent's kernel stays, with its numbers).
8. The streaming feature feed (``streaming_path``), on 128 synthetic
   slides of 3,000-10,240 patches x 512 (K 10; about 1.7 GB of f32 npz,
   drawn as the JAX package's ``scripts/bench_tcga_scale.py`` draws its
   TCGA-sized slides): MuRCL CLAM_SB stage 1 (batch 128, feat_size 1024, T 6, bf16, 3
   steps) with and without ``--streaming`` must write the same
   ``losses.csv``, and RLMIL CLAM_SB (scratch, batch 64) stages 1 and 3 the
   same ``final_res.csv`` and ``pred.csv``, all at an aggregator and head
   learning rate of 0 (K3's and K7b's atomics make two training runs differ
   in their last bits whatever feeds them; at lr 0 each step's outputs
   depend on its batch's data alone); the streaming runs' launch counts go
   into the kernels line. Then ``--policy_conv`` with ``--streaming``: a
   MuRCL stage 2 and an RLMIL stage 2 whose checkpoints' conv policies load
   back; K1 bitwise against its twin on a staged mini-bank at ranks (1536,
   10240) in f32 and bf16, timed in both beside its bound (the ``tcga_*``
   fields of the ``compact`` row); and steady stage-1 steps in turns, streaming and
   resident, twice round, each batch 128 distinct slides as at TCGA's
   10,000+ slides: step ms, the host's staging ms per batch, the copy's
   bytes and GB/s (the feed's ``stage_log``), the peak device memory and,
   over 3 traced steps, the device's busy share.

9. Data-parallel training (``dp_cli_path``, ``dp_step_path``), two ranks
   (``--dp_devices 2``), each on a card of its own over NCCL where there are
   two, else both on ``cuda:0`` over gloo: ``train_MuRCL`` CLAM_SB stages 1
   -> 2 -> 3 at the bench.py shape (batch 128, 64 per rank; 2 steps each),
   a single-process stage 2 from the dp stage 1's ``model_best``, and
   ``train_RLMIL`` CLAM_SB finetune stages 1 -> 2 -> 3 from the dp MuRCL
   stage 3 (batch 64, 32 per rank): per run finite losses, rank 0's files
   alone in the run directory, and each rank's launches (K1, K2/K3, K4 for
   MuRCL; K1, K7 for RLMIL, by ``MURCL_KERNELS`` and ``RLMIL_KERNELS``),
   summed over the ranks into the kernels line. Then one MuRCL CLAM_SB
   stage-1 step at the bench.py shape with dropout off, dp 2 against the
   single process from the same weights and draws (each rank's half of one
   global draw, the mixup partners within each half): step losses within
   2e-2 relative, the all-reduced gradients within 2e-2 relative Frobenius
   (K3's split-K atomics), the ranks' gradients and weights after Adam
   bitwise equal; and steady steps in turns, single, dp, single: step and
   enqueue ms per rank, the gradient all-reduce's bytes and ms, and the peak
   device memory per rank.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

REPO = Path(__file__).resolve().parent
B_MAIN, N_MAIN, FIN, L1, D, T, K, BATCH = 1536, 1024, 512, 512, 256, 6, 10, 128
SLIDES, PATCHES = 64, 2048
CHECK_BAGS = 192  # bags in the K2/K3 comparisons
RL_BATCH, RL_SPLITS = 64, (128, 32, 32)  # supervised batch; train / valid / test slides
POOL_BAGS = T * RL_BATCH  # K7's bags in a supervised stage-1 step
POOL_CHECK_BAGS = 48  # bags in the K7 comparisons
ABMIL_D, CLAM_BIG_D = 128, 384  # ABMIL's attention width (MuRCL's --D); CLAM "big"
# (F, D) that K7's op zero-pads to multiples of 128: the JAX package's PPO
# check (scripts/ppo_sanity.py: L 32, D 8), and ABMIL at --D 64
ODD_WIDTHS = ((32, 8), (512, 64))
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


def profiling():
    """The profile helpers, ``murcl_tpu_torch/scripts/profiling.py`` of this
    tree, loaded from their file (they import torch alone): an A/B side
    process imports the parent tree's port, and both sides are measured
    with the same helpers."""
    import importlib.util

    name = "chip_smoke_profiling"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, REPO / "murcl_tpu_torch" / "scripts" / "profiling.py")
        sys.modules[name] = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sys.modules[name])
    return sys.modules[name]


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


def enqueue_ms(fn, reps: int = 5) -> float:
    """Host ms to enqueue one call of ``fn`` from an idle card (the wrapper's
    Python and its launches), median of ``reps``."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
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


def fused_inputs(b, dtype, gen, dev, masked: bool, n: int = N_MAIN, l1: int = L1, d: int = D):
    import torch

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * sc

    w = [r(FIN, l1, sc=FIN ** -0.5), r(l1, sc=0.1), r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1),
         r(l1, d, sc=l1 ** -0.5), r(d, sc=0.1), r(d, sc=d ** -0.5), r((), sc=0.1)]
    h = r(b, n, FIN).to(dtype)
    lengths = torch.randint(min(600, n), n + 1, (b,), generator=gen, device=dev)
    mask = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    if not masked:
        mask = torch.ones_like(mask)
    perm = torch.randperm(b, generator=gen, device=dev)
    lam = 0.9 + 0.1 * torch.rand(b, generator=gen, device=dev)
    cots = [r(b, l1), r(b, n, sc=0.1), r(b, n, sc=0.01)]
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
        ptr(o["wb"]), ptr(o["bb"]), ptr(o["wc"]), ptr(bc), None, ptr(o["mask"]), *drop,
        ptr(xc), None, ptr(m), ptr(p), ptr(s), b, N_MAIN, FIN, L1, D, L1, D, _cuda.stream())
    _cuda.check(err, "keep-rate probe")
    torch.cuda.synchronize()
    return float((xc != 0).float().mean())


def compact_bound(ranks, offs, nump, esize: int, feat: int = N_MAIN, d: int = FIN):
    """K1's bound at ``esize`` bytes an element: the bank rows this run
    reads (each once), the indices, and the sub-bags written."""
    import torch

    p = torch.arange(ranks.shape[1], device=ranks.device)[None, :]
    live = (ranks >= 0) & (p < nump[:, None])
    read = torch.unique((offs[:, None] + p)[live]).numel()
    return bound(0, read * d * esize + nbytes(ranks, offs, nump)
                 + ranks.shape[0] * feat * d * esize, BF16_FLOPS)


# K1's bag counts on the main paths: bags a launch -> (the path, launches a
# step; ppo_sanity adds 484 a run at RL_BATCH)
COMPACT_SHAPES = {B_MAIN: ("MuRCL stage 1", 1), 2 * BATCH: ("MuRCL stages 2/3", 6),
                  POOL_BAGS: ("supervised stage 1", 1), RL_BATCH: ("supervised stages 2/3", 6)}
COMPACTION_KEYS = ("ms", "b2b_ms", "device_ms", "plain_ms", "index_select_ms", "bound_ms",
                   "bound_by", "share_of", "share")
COMPACT_CASE_BAGS = (64, 200)  # tests/torch_compact_cases.py's cases at D 512: one wave, two
TCGA_LIKE = (128, 3000, 10240, 12)  # slides, patches from .. to, bags a slide (2 views x T)


def compaction_inputs(dev, gen):
    """K1's operands at each of ``COMPACT_SHAPES``: a bank of ``SLIDES``
    random slides of ``PATCHES`` x ``FIN`` (f32, K clusters), and the ranks
    ``select_ranks`` draws for each path's bags, as the engines lay them
    out: MuRCL stage 1 ``cat([ids, ids]).repeat(T)`` of ``BATCH`` ids, its
    stages 2/3 ``cat([ids, ids])``, supervised stage 1 ``ids.repeat(T)`` of
    ``RL_BATCH`` distinct slides, its stages 2/3 ``ids``. The bank, the ids
    and the actions at ``B_MAIN`` and ``RL_BATCH`` bags come from ``gen`` in
    the order the compaction check has always drawn them, so that the
    checks after it draw the same inputs from ``gen`` as before; the other
    two counts' actions from a generator of their own. Returns ``(feats,
    {bags: (ranks, offs, nump)})``."""
    import numpy as np
    import torch

    from murcl_tpu_torch.data.bank import bank_from_arrays
    from murcl_tpu_torch.ops.select import select_ranks

    rng = np.random.default_rng(0)
    clusters = []
    for _ in range(SLIDES):
        a = rng.integers(0, K, size=PATCHES)
        clusters.append([np.flatnonzero(a == c).tolist() for c in range(K)])
    bank = bank_from_arrays([np.zeros((PATCHES, FIN), np.float32)] * SLIDES, clusters,
                            [0] * SLIDES).to(dev)
    own = torch.Generator(device=dev).manual_seed(3)
    feats = torch.randn(bank.feats.shape, generator=gen, device=dev)
    ids = torch.randint(0, SLIDES, (BATCH,), generator=gen, device=dev)
    main = torch.rand(B_MAIN, K, generator=gen, device=dev)
    sup = torch.randperm(SLIDES, generator=gen, device=dev)[:RL_BATCH]
    layouts = {B_MAIN: (torch.cat([ids, ids]).repeat(T), main),
               RL_BATCH: (sup, torch.rand(RL_BATCH, K, generator=gen, device=dev)),
               2 * BATCH: (torch.cat([ids, ids]), torch.rand(2 * BATCH, K, generator=own,
                                                              device=dev)),
               POOL_BAGS: (sup.repeat(T), torch.rand(POOL_BAGS, K, generator=own, device=dev))}
    shapes = {}
    for bags in COMPACT_SHAPES:
        flat, actions = layouts[bags]
        ranks, offs, _ = select_ranks(flat, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                      actions, bank.patch_cluster, bank.patch_pos, N_MAIN)
        shapes[bags] = (ranks, offs, bank.num_patches[flat])
    return feats, shapes


def tcga_like_inputs(dev, gen):
    """K1's operands at the TCGA shape without the streaming corpus:
    ``TCGA_LIKE``'s slides of random lengths back to back in a random f32
    bank, each slide's bags side by side as a MuRCL stage-1 batch of
    distinct slides lays them out, each bag a Bernoulli(N_MAIN / n)
    selection of its slide's patches cut at N_MAIN. Returns ``(feats,
    ranks, offs, nump)``, ranks ``(slides x bags, patches' upper bound)``."""
    import torch

    slides, lo, hi, per = TCGA_LIKE
    n = torch.randint(lo, hi + 1, (slides,), generator=gen, device=dev)
    sid = torch.arange(slides, device=dev).repeat(per)
    p = torch.arange(hi, device=dev)[None, :]
    pick = (torch.rand(len(sid), hi, generator=gen, device=dev) < (N_MAIN / n[sid])[:, None]) \
        & (p < n[sid, None])
    ranks = torch.where(pick, torch.cumsum(pick.int(), 1) - 1, -1)
    ranks = torch.where(ranks >= N_MAIN, -1, ranks).int().contiguous()
    feats = torch.randn(int(n.sum()), FIN, generator=gen, device=dev)
    return feats, ranks, (torch.cumsum(n, 0) - n)[sid].contiguous(), n[sid].contiguous()


def compaction_times(feats, ranks, offs, nump) -> dict:
    """K1 through its wrapper on these operands: ms (CUDA events around one
    call, the host's enqueue included), ms per call of 10 back to back
    (``back_to_back_ms``), device ms (torch.profiler tracing host and
    device, every kernel of the call: the order kernel too where it runs;
    None where the trace holds none of them), the twin's ms, the bound and
    its share of the device time (of the back-to-back time where the trace
    held no kernel: ``share_of``), and ``torch.index_select`` of the same
    live rows (a copy-rate yardstick: it writes no zero slots and not the
    sub-bags' layout, so it is not the function)."""
    import torch

    from murcl_tpu_torch.ops.compact import _gather_compact_cuda, gather_compact_plain

    p = torch.arange(ranks.shape[1], device=ranks.device)[None, :]
    rows = (offs[:, None] + p)[(ranks >= 0) & (p < nump[:, None])]

    def fn():
        return _gather_compact_cuda(feats, offs, ranks, N_MAIN, nump)

    r = {"ms": median_ms(fn), "b2b_ms": back_to_back_ms(fn),
         "device_ms": device_ms(fn, reps=5, host=True) or None,
         "plain_ms": median_ms(lambda: gather_compact_plain(feats, offs, ranks, N_MAIN, nump)),
         "index_select_ms": median_ms(lambda: feats.index_select(0, rows))}
    r["bound_ms"], r["bound_by"] = compact_bound(ranks, offs, nump, feats.element_size())
    r["share_of"] = "device" if r["device_ms"] else "b2b"
    r["share"] = r["bound_ms"] / (r["device_ms"] or r["b2b_ms"])
    return r


def compaction_line(r) -> str:
    """``compaction_times``' numbers as one line's words."""
    dev = "not traced" if r["device_ms"] is None else f"{r['device_ms']:.4f}"
    return (f"{r['ms']:.4f} ms (back to back {r['b2b_ms']:.4f}, device {dev}) vs twin "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms ({100 * r['share']:.1f}% "
            f"of it by the {r['share_of']} time); index_select of the live rows "
            f"{r['index_select_ms']:.4f} ms")


def check_compaction(dev, gen):
    """K1 bitwise against its twin (f32, bf16) at each of ``COMPACT_SHAPES``
    and timed there in both dtypes (``compaction_times``); its planner at the
    supervised stages' 64 bags (two slot slices a bag, one wave) and at the
    others (one slice a bag, the bags in slide order); and bitwise on
    ``tests/torch_compact_cases.py``'s cases at D 512, at ``COMPACT_CASE_BAGS``."""
    import torch

    from murcl_tpu_torch.ops.compact import (_gather_compact_cuda, compact_plan,
                                             gather_compact_plain)

    sys.path.insert(0, str(REPO / "tests"))
    from torch_compact_cases import CASES, compact_case

    card = card_line()
    feats32, shapes = compaction_inputs(dev, gen)
    res = {"shapes": {}, "max_abs_err": 0.0}
    for bags, (ranks, offs, nump) in shapes.items():
        path, per_step = COMPACT_SHAPES[bags]
        for dtype, view, tag in ((torch.float32, torch.int32, "f32"),
                                 (torch.bfloat16, torch.int16, "bf16")):
            feats = feats32.to(dtype)
            got = _gather_compact_cuda(feats, offs, ranks, N_MAIN, nump)
            want = gather_compact_plain(feats, offs, ranks, N_MAIN, nump)
            check(torch.equal(got.view(view), want.view(view)),
                  f"K1 not bitwise at ({bags}, {N_MAIN}, {FIN}) {tag}")
            del got, want
            r = compaction_times(feats, ranks, offs, nump)
            r["per_step"] = per_step
            res["shapes"][f"{bags}_{tag}"] = r
            print(f"K1 at ({bags}, {N_MAIN}, {FIN}) {tag} ({path}, {per_step} a step): "
                  f"{compaction_line(r)} ({card})")
            del feats
            torch.cuda.empty_cache()
    k5, k1 = (compact_plan(b, N_MAIN, FIN * 2) for b in (RL_BATCH, B_MAIN))
    check(k5.slices > 1 and not k5.by_slide and k1.slices == 1 and k1.by_slide,
          f"K1's plans: {k5} at {RL_BATCH} bags, {k1} at {B_MAIN}")
    res["k5_slices"] = k5.slices
    for name in CASES:
        for bags in COMPACT_CASE_BAGS:
            bank, offs, ranks, nump, feat = compact_case(name, d=FIN, bags=bags)
            offs, ranks, nump = (torch.from_numpy(x).to(dev) for x in (offs, ranks, nump))
            for dtype, view in ((torch.float32, torch.int32), (torch.bfloat16, torch.int16)):
                if name == "rows400" and dtype == torch.bfloat16:
                    continue  # 200-byte rows: the wrapper refuses them
                b = torch.from_numpy(bank).to(dev, dtype)
                got = _gather_compact_cuda(b, offs, ranks, feat, nump)
                want = gather_compact_plain(b, offs, ranks, feat, nump)
                check(torch.equal(got.view(view), want.view(view)),
                      f"K1 not bitwise on the {name} case, {bags} bags, {dtype}")
                del b, got, want
    print(f"K1 bitwise on the cases {', '.join(CASES)} at D {FIN}, {COMPACT_CASE_BAGS} bags")
    main, k5r = res["shapes"][f"{B_MAIN}_bf16"], res["shapes"][f"{RL_BATCH}_bf16"]
    res.update({k: main[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by")})
    res.update({"k5_" + k: k5r[k] for k in ("ms", "device_ms", "plain_ms", "bound_ms")})
    return res


def select_probe_path(dev) -> dict:
    """Selection's breakdown at the JAX script's shape (the port of
    ``scripts/dbg_select.py``): every launch count 0 before and read after
    (K1 12 a call of ``compact`` and of ``select``, K6 12 a call of
    ``mixup``, a warm-up and 5 timed calls each, and nothing else); then,
    not counted, the last ``select`` step's sub-bags, the ``compact`` output
    and the mixup's bitwise against the twins on the same draws. Returns
    the script's ms."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.ops.compact import gather_compact_plain
    from murcl_tpu_torch.ops.mixup import apply_mix
    from murcl_tpu_torch.ops.select import select_ranks
    from murcl_tpu_torch.scripts import dbg_select

    outs = {}
    _cuda.reset_launch_counts()
    times = dbg_select.run(str(dev), reps=PROBE_REPS, outs=outs)
    t_steps, calls = dbg_select.SHAPE[-1], 1 + PROBE_REPS
    launches = {k: v for k, v in _cuda.LAUNCHES.items() if v}
    check(launches == {"compact": 2 * t_steps * calls, "mixup_rows": t_steps * calls},
          f"dbg_select's launches: {launches}")
    bank, ids, feat = outs["bank"], outs["ids"], dbg_select.SHAPE[3]
    nump = bank.num_patches[ids]
    for key, a in (("select", outs["actions"]), ("compact", outs["first_actions"])):
        ranks, offs, _ = select_ranks(ids, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                      a, bank.patch_cluster, bank.patch_pos, feat)
        want = gather_compact_plain(bank.feats, offs, ranks, feat, nump)
        check(torch.equal(outs[key].view(torch.int16), want.view(torch.int16)),
              f"dbg_select's {key} not bitwise the twin")
    lam, perm = outs["mix"]
    check(torch.equal(outs["mixup"].view(torch.int16),
                      apply_mix(outs["x0"], perm, lam).view(torch.int16)),
          "dbg_select's mixup not bitwise the twin")
    print(f"dbg_select: K1 alone {times['compact']:.3f} ms of select_feats' "
          f"{times['select']:.3f} ms ({100 * times['compact'] / times['select']:.1f}%), the index "
          f"computation {times['index']:.3f} ms, a plain row gather {times['gather']:.3f} ms, the "
          f"mixup {times['mixup']:.3f} ms ({t_steps} steps a call; launches {launches}; "
          f"{card_line()})")
    return times


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


def kernel_split(fn, own: bool = True, reps: int = 1, host: bool = False) -> list:
    """``[(kernel, device ms)]`` of the port's kernels that ``reps`` calls
    of ``fn`` launch, in launch order (torch.profiler; PyTorch's own copies
    and memsets left out); with ``own=False`` every device event, PyTorch's
    included, by its full name; ``host`` traces the host's activity too."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU] * host + [ProfilerActivity.CUDA]) as prof:
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


def device_ms(fn, own: bool = True, reps: int = 20, host: bool = False) -> float:
    """Device ms per call of ``fn``: ``kernel_split``'s events of ``reps``
    calls, summed, over ``reps``."""
    return sum(ms for _, ms in kernel_split(fn, own, reps, host)) / reps


def back_to_back_ms(fn, reps: int = 10) -> float:
    """ms per call of ``reps`` calls of ``fn`` between two CUDA events, after
    one warm-up: the device's time per call where the host enqueues faster
    than the card runs, the host's where it does not."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# the kernels that must run on the tensor cores: the kernels of
# csrc/fused_trunk.cu (K2/K3) and csrc/attention_pool.cu (K7, and K8's gate
# pass: pool_gates_fwd_wg; wgrad_wg in both files) in both instantiations,
# bf16 and f32 (three bf16 products per product), which must hold Hopper's
# warpgroup products (HGMMA); K8's chunk pass (csrc/attention_tiled.cu),
# which holds no products, in both; and K8's earlier mma.sync kernel, which
# must be gone
HGMMA_KERNELS = tuple(f"{k}<{t}>" for k in ("trunk_wg", "gates_fwd_wg", "gates_bwd_wg", "dx_wg",
                                            "dh_wg", "wgrad_wg", "pool_gates_fwd_wg",
                                            "pool_gates_bwd_wg", "pool_dx_wg")
                      for t in ("__nv_bfloat16", "float"))
K8_CHUNK_KERNELS = ("chunk_kernel<float>", "chunk_kernel<__nv_bfloat16>")
GONE_KERNELS = ("tiled_pool_tc",)
# the probe library's kernels (the K2/K3 ablations in
# csrc/fused_trunk_ablate.cu, their variant the second template argument: 1
# pre-lean, 2 lean2, 3 dwc only; the overlap probe's modes in
# csrc/wgmma_overlap.cu; the one-hot compaction probes' instantiations in
# csrc/compact_onehot.cu: group, band type, slab by compare, scatter or
# constant), each with HGMMA, but PROBE_NO_MMA_KERNELS; none of them in the
# kernel library
ABLATION_KERNELS = tuple(f"{k}<{t}, {v}>" for t in ("__nv_bfloat16", "float")
                         for k, v in (("trunk_ablate_wg", 1), ("gates_fwd_ablate_wg", 1),
                                      ("gates_bwd_ablate_wg", 1), ("gates_bwd_ablate_wg", 3),
                                      ("dx_ablate_wg", 1))) + (
    "dx_ablate_wg<__nv_bfloat16, 2>", "overlap_wg<0>", "overlap_wg<2>", "overlap_wg<3>") + tuple(
    f"oh::onehot_wg<{g}, {t}, {m}>" for g, t, m in (
        (1, "float", 0), (1, "float", 1), (1, "__nv_bfloat16", 0), (1, "__nv_bfloat16", 1),
        (4, "__nv_bfloat16", 0), (4, "__nv_bfloat16", 1), (4, "__nv_bfloat16", 2)))
# the probes without products: the overlap's vpu mode, the one-hot probes'
# dmafloor copy (csrc/compact_onehot.cu) and the gate-mask writer
# (csrc/gate_masks.cu)
PROBE_NO_MMA_KERNELS = ("overlap_wg<1>", "oh::onehot_dmafloor", "gate_masks_kernel")


def mangled(kernel: str) -> str:
    """The part of a kernel's mangled name that spells ``kernel``: each part
    of the name by its length (``8wgrad_wg``), then its template arguments
    as far as given (``12chunk_kernelIf``, ``10overlap_wgILi0E``; a kernel's
    further arguments, such as ``pool_gates_bwd_wg``'s partials flag, follow
    them)."""
    base, _, args = kernel.partition("<")
    out = "".join(f"{len(part)}{part}" for part in base.split("::"))
    for i, arg in enumerate(a.strip() for a in args.rstrip(">").split(",") if a.strip()):
        out += ("I" if i == 0 else "") + ("f" if arg == "float" else f"Li{arg}E" if
                                          arg.isdigit() else f"{len(arg)}{arg}")
    return out


def check_sass(probes: bool = False) -> dict:
    """``cuobjdump -sass`` (beside nvcc) over the built kernel library (with
    ``probes``, the probe library): each kernel of ``HGMMA_KERNELS``
    (defined in ``csrc/fused_trunk.cu``, ``csrc/attention_pool.cu`` and the
    headers they share; the probes' ``ABLATION_KERNELS``, in
    ``csrc/fused_trunk_ablate.cu`` and ``csrc/wgmma_overlap.cu``) must hold
    HGMMA; each of ``K8_CHUNK_KERNELS`` (``PROBE_NO_MMA_KERNELS``) must be
    there, its tensor-core instructions counted (none expected); none of
    ``GONE_KERNELS``, nor in the kernel library any probe kernel, may be.
    Returns the counts per kernel."""
    from murcl_tpu_torch.ops import _cuda

    tool = Path(_cuda._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_cuda.library_path(probes))],
                          capture_output=True, text=True, check=True).stdout
    mma, no_mma = ((ABLATION_KERNELS, PROBE_NO_MMA_KERNELS) if probes
                   else (HGMMA_KERNELS, K8_CHUNK_KERNELS))
    absent = GONE_KERNELS + (() if probes else ABLATION_KERNELS + PROBE_NO_MMA_KERNELS)
    counts, gone = {}, []
    for body in sass.split("Function : ")[1:]:
        name = body.split(None, 1)[0]
        gone += [k for k in absent if mangled(k) in name]
        for k in mma + no_mma:
            if mangled(k) in name:
                rule = r"\bHGMMA\b" if k in mma else r"\bH(G)?MMA\b"
                counts[k] = counts.get(k, 0) + sum(
                    1 for line in body.splitlines() if re.search(rule, line))
    check(set(counts) == set(mma + no_mma) and all(counts[k] for k in mma),
          f"kernels missing or without their warpgroup products: {counts}")
    check(not gone, f"kernels that should not be in the library: {sorted(set(gone))}")
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
    split_bwd = name_wgrads(kernel_split(lambda: att._bwd_cuda(h, *w[:7], mask, p, *cots,
                                                               0.25, 77, perm, lam)),
                            ("dWf", "dWa+dWb"))
    for what, split, total in (("K2", split_fwd, k_fwd), ("K3", split_bwd, k_bwd)):
        print_split(f"{what} at ({B_MAIN}, {N_MAIN}, {FIN}) bf16 gated, mixed, dropout 0.25",
                    split, total)
        print_rates(what, split, fused_work())
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


def check_fused_f32(dev, gen):
    """K2/K3's f32 route (the default dtype of both CLIs and of the runbook;
    every product as three bf16 products) at the main path's full shape,
    (1536, 1024, 512) -> 512 -> 256: gated and mixed at dropout 0.25, ungated
    and mixed, gated and unmixed with the bags' gradient, and the heatmap's
    largest f32 bag (1, 3072, 512) gated and ungated at dropout 0, each held
    within 1e-4 of the plain twin on every output; then the gated, mixed
    call timed (median of 3) beside the plain twin and the bound of its f32
    products at TF32's rate, split by sub-kernel with each one's TFLOP/s (of
    the function's f32 products) and GB/s, and the ungated, unmixed and dh
    modes timed."""
    import torch

    from murcl_tpu_torch.ops import attention as att

    names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc", "dh"]
    res = {"max_rel": 0.0, "max_abs_err_fwd": 0.0, "max_abs_err_bwd": 0.0}
    # (bags, rows, gated, mixed, need_dh, dropout)
    for b, n, gated, mixed, need_dh, rate in (
            (B_MAIN, N_MAIN, True, True, False, 0.25), (B_MAIN, N_MAIN, False, True, False, 0.25),
            (B_MAIN, N_MAIN, True, False, True, 0.25), (1, 3072, True, False, False, 0.0),
            (1, 3072, False, False, False, 0.0)):
        h, w, mask, mix, cots = fused_inputs(b, torch.float32, gen, dev, True, n)
        got = run_fused(h, w, mask, rate, 77, mix if mixed else None, cots, gated, need_dh)
        want = run_plain(h, w, mask, rate, 77, mix if mixed else (None, None), cots, gated,
                         need_dh)
        rels = {nm: rel_err(g, wv) for nm, g, wv in zip(names, got, want)
                if gated or nm not in ("dwb", "dbb")}
        what = (f"K2/K3 f32 at ({b}, {n}, {FIN}) gated={gated} mixed={mixed} dh={need_dh} "
                f"dropout {rate}")
        print(f"{what}: rel err " + ", ".join(f"{nm} {v:.2e}" for nm, v in rels.items()))
        check(max(rels.values()) <= 1e-4, f"{what}: {rels}")
        res["max_rel"] = max(res["max_rel"], *rels.values())
        res["max_abs_err_fwd"] = max(res["max_abs_err_fwd"], *(
            float((g - wv).abs().max()) for g, wv in zip(got[:3], want[:3])))
        res["max_abs_err_bwd"] = max(res["max_abs_err_bwd"], *(
            float((g - wv).abs().max()) for g, wv in zip(got[3:], want[3:])))
        del h, got, want
        torch.cuda.empty_cache()

    h, w, mask, mix, cots = fused_inputs(B_MAIN, torch.float32, gen, dev, False)
    perm, lam = mix
    _, p, _ = att._fwd_cuda(h, *w, mask, 0.25, 77, perm, lam)

    def fwd(gated=True):
        return att._fwd_cuda(h, *w, mask, 0.25, 77, perm, lam, gated=gated)

    def bwd(mixed=True, gated=True, need_dh=False):
        pm = (perm, lam) if mixed else (None, None)
        return att._bwd_cuda(h, *w[:7], mask, p, *cots, 0.25, 77, *pm, gated=gated,
                             need_dh=need_dh)

    res["fwd_ms"], res["bwd_ms"] = median_ms(fwd, reps=3), median_ms(bwd, reps=3)
    split_fwd = kernel_split(fwd)
    split_bwd = name_wgrads(kernel_split(bwd), ("dWf", "dWa+dWb"))
    for what, split, total in (("K2 f32", split_fwd, res["fwd_ms"]),
                               ("K3 f32", split_bwd, res["bwd_ms"])):
        print_split(f"{what} at ({B_MAIN}, {N_MAIN}, {FIN}) gated, mixed, dropout 0.25", split,
                    total)
        print_rates(what, split, fused_work_f32())
    res["fwd_split_ms"], res["bwd_split_ms"] = dict(split_fwd), dict(split_bwd)
    res["fwd_ungated_ms"] = median_ms(lambda: fwd(False), reps=3)
    res["bwd_ungated_ms"] = median_ms(lambda: bwd(gated=False), reps=3)
    res["bwd_unmixed_ms"] = median_ms(lambda: bwd(mixed=False), reps=3)
    res["bwd_dh_ms"] = median_ms(lambda: bwd(mixed=False, need_dh=True), reps=3)
    torch.cuda.empty_cache()
    res["fwd_plain_ms"] = median_ms(
        lambda: att.fused_trunk_plain_fwd(h, *w, mask, 0.25, 77, perm, lam), reps=3)
    res["bwd_plain_ms"] = median_ms(
        lambda: att.fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, 0.25, 77, perm, lam),
        reps=3)
    # the function's f32 products at TF32's rate (the K4 and K8 rows' convention)
    r = B_MAIN * N_MAIN
    trunk, gates = 2 * r * FIN * L1, 4 * r * L1 * D
    io = nbytes(h, mask, perm, lam) + r * 4 * 2 + B_MAIN * L1 * 4
    res["fwd_bound_ms"], res["fwd_bound_by"] = bound(trunk + gates + 2 * r * L1, io, TF32_FLOPS)
    res["bwd_bound_ms"], res["bwd_bound_by"] = bound(
        2 * trunk + 3 * gates + 2 * r * L1, nbytes(h, mask, perm, lam, p, *cots), TF32_FLOPS)
    del h, p
    torch.cuda.empty_cache()
    return res


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


def pool_inputs(b, dtype, gen, dev, masked: bool, d: int = D, n: int = N_MAIN, f: int = L1):
    """K7's operands; masked bags are live for 600 (or n / 2) to n rows, and,
    where n is not a multiple of 64, the first six for 1, 63, 65, 127, 129
    and n (the 64- and 128-row tiles' edges)."""
    import torch

    def r(*shape, sc=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * sc

    w = [r(f, d, sc=f ** -0.5), r(d, sc=0.1), r(f, d, sc=f ** -0.5), r(d, sc=0.1),
         r(d, sc=d ** -0.5), r((), sc=0.1)]
    x = torch.relu(r(b, n, f)).to(dtype)  # a trunk output: post-relu
    lengths = torch.randint(min(600, n // 2), n + 1, (b,), generator=gen, device=dev)
    if n % 64:
        lengths[:6] = torch.tensor([1, 63, 65, 127, 129, n], device=dev)
    mask = torch.arange(n, device=dev)[None, :] < lengths[:, None]
    if not masked:
        mask = torch.ones_like(mask)
    cots = [r(b, f), r(b, n, sc=0.1), r(b, n, sc=0.01)]
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
    return [(f"{n} {next(grads)}" if n.endswith("wgrad_wg") else n, ms)
            for n, ms in split]


def print_split(what, split, total) -> None:
    print(f"{what}: {total:.3f} ms (median of 3); one call by sub-kernel: "
          + ", ".join(f"{n} {ms:.3f} ms" for n, ms in split))


# K2/K3's bf16 kernels at the timed call (B_MAIN, N_MAIN, FIN -> L1 -> D,
# gated, mixed): (FLOPs, device-memory bytes) each must do, each input read
# once and each output written once (``csrc/fused_trunk.cu``'s reckoning)
def fused_work() -> dict:
    r, x = B_MAIN * N_MAIN, B_MAIN * N_MAIN * L1 * 2  # rows; one bf16 (R, L1) tensor
    h, zab = r * FIN * 2, r * 2 * D * 2
    # the mixed trunk reads h and h[perm] and writes xc and hm in both passes
    return {"trunk_wg": (2 * r * FIN * L1, 3 * h + x), "gates_fwd_wg": (4 * r * L1 * D, x + r * 4),
            "pool_kernel": (2 * r * L1, x + r * 8),
            "trunk_wg bwd": (2 * r * FIN * L1, 2 * h + x + h),
            "gates_bwd_wg": (4 * r * L1 * D, x + zab + r * 16),
            "dx_wg": (4 * r * L1 * D, zab + x + x + r * 4),
            "wgrad_wg dWf": (2 * r * FIN * L1, h + x),
            "wgrad_wg dWa+dWb": (4 * r * L1 * D, x + zab)}


# K2/K3's f32 kernels at the same call: the function's FLOPs (the products'
# f32 FLOPs, each issued as three bf16 products) and the bytes each moves:
# the (mixed) bags split into two bf16 planes, every tile through device
# memory as its planes (``csrc/fused_trunk.cu``'s reckoning)
def fused_work_f32() -> dict:
    r = B_MAIN * N_MAIN
    h, x, zab = r * FIN * 4, r * L1 * 4, r * 2 * D * 4  # f32 tensors, or their two planes
    return {"split_kernel": (0, 2 * h + h), "trunk_wg": (2 * r * FIN * L1, h + x),
            "refine_kernel": (0, r * L1 // 8),
            "gates_fwd_wg": (4 * r * L1 * D, x + r * 4), "pool_kernel": (2 * r * L1, x + r * 8),
            "trunk_wg bwd": (2 * r * FIN * L1, h + x + r * 4 * L1 // 128),
            "gates_bwd_wg": (4 * r * L1 * D, x + zab + r * 16),
            "dx_wg": (4 * r * L1 * D, zab + x // 2 + x + r * 4),
            "wgrad_wg dWf": (2 * r * FIN * L1, h + x),
            "wgrad_wg dWa+dWb": (4 * r * L1 * D, x + zab)}


# K7's kernels at (b, n, L1 -> d): (FLOPs, device-memory bytes) each must do
# (``csrc/attention_pool.cu``'s reckoning); the dz scratch is two bf16 planes
# of [dza | dzb]. bf16: dx's products are three bf16 products per gate, and
# the weight gradients read dz's hi plane. f32: the function's FLOPs (its
# f32 products, each issued as three bf16 products), x's planes as many
# bytes as the f32 x, dx f32, and the weight gradients read both planes
def pool_work(b: int, d: int, gated: bool, f32: bool, n: int = N_MAIN) -> dict:
    r, g = b * n, 2 if gated else 1
    x, z, gate = r * L1 * (4 if f32 else 2), 2 * r * g * d * 2, 2 * r * L1 * d * g
    work = {"pool_gates_fwd_wg": (gate, x + r * 4), "pool_kernel": (2 * r * L1, x + r * 9),
            "dp_kernel": (2 * r * L1, x + r * 4), "softmax_bwd_kernel": (4 * r, r * 21),
            "pool_gates_bwd_wg": (gate, x + z + r * 4),
            "pool_dx_wg": (gate if f32 else 3 * gate, z + x + r * 4),
            "wgrad_wg dWa+dWb": (gate, x + (z if f32 else z // 2))}
    if f32:
        work["split_kernel"] = (0, 2 * x)
    return work


def print_rates(what, split, work) -> None:
    """Achieved TFLOP/s and GB/s of each of ``split``'s kernels that
    ``work`` (:func:`fused_work`, :func:`fused_work_f32`, :func:`pool_work`)
    reckons; of a kernel launched more than once (the f32 route's
    split_kernel: the bags, then the weights), its longest launch."""
    longest = {}
    for name, ms in split:
        key = f"{name} bwd" if what.startswith("K3") and name == "trunk_wg" else name
        if key in work:
            longest[key] = max(ms, longest.get(key, 0.0))
    out = [f"{key.split(' bwd')[0]} {work[key][0] / ms / 1e9:.1f} TFLOP/s, "
           f"{work[key][1] / ms / 1e6:.0f} GB/s" for key, ms in longest.items()]
    print(f"{what} sub-kernels, achieved: " + "; ".join(out))


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
    """K7 through the op against the plain twin, every output within 1e-4 in
    f32 (the supervised CLIs' default; every product as three bf16
    products) and 2e-2 in bf16: bf16 at dropout 0 and 0.25 gated and
    ungated at D 256, gated at D 384 and on bags of TAIL_N rows, and in
    ABMIL's mode (ungated, D 128) at dropout 0; f32 at dropout 0 gated and
    ungated at D 256 and in ABMIL's mode, and at dropout 0 and 0.25 gated
    and ungated at D 128, 256 and 384 on bags of TAIL_N rows (those bags'
    first six end at the 128-row tiles' edges); both dtypes at dropout 0
    and 0.25, gated and ungated, at ``ODD_WIDTHS`` (zero-padded to
    multiples of 128 by the op); then the gate keep rates.
    Then K7f and K7b in both dtypes at the supervised stage-1 shape and in
    ABMIL's mode, and K7b in f32 at the heatmap's largest bag (1, 60416,
    512) gated (K8's op backward, which must beat its twin), each held to
    the twin on the same inputs at the same tolerances and timed beside it
    (median of 3), split by sub-kernel with each one's TFLOP/s and GB/s,
    beside its bound. Returns the bf16 rows of K7f and K7b and the f32
    numbers."""
    import torch

    from murcl_tpu_torch.ops import attention as att

    names = ["M", "p", "s", "dx", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
    tols = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
    errs = {dt: {"fwd": 0.0, "bwd": 0.0, "rel": 0.0} for dt in tols}

    def held(what, got, want, outs, gated, dtype):
        """Holds ``got`` to ``want`` (the outputs named ``outs``) at the
        dtype's tolerance, ungated dwb and dbb zero, and keeps the largest
        errors."""
        rels = {nm: rel_err(g, wv) for nm, g, wv in zip(outs, got, want)
                if gated or nm not in ("dwb", "dbb")}
        if not gated and "dwb" in outs:
            check(not got[outs.index("dwb")].any() and not got[outs.index("dbb")].any(),
                  f"{what}: ungated dwb/dbb not zero")
        print(f"{what}: rel err " + ", ".join(f"{k} {v:.2e}" for k, v in rels.items()))
        check(max(rels.values()) <= tols[dtype], f"{what}: {rels}")
        e = errs[dtype]
        e["rel"] = max(e["rel"], *rels.values())
        for nm, g, wv in zip(outs, got, want):
            side = "fwd" if nm in names[:3] else "bwd"
            e[side] = max(e[side], float((g.float() - wv.float()).abs().max()))

    bf16 = [(torch.bfloat16, 0.0), (torch.bfloat16, 0.25)]
    f32 = [(torch.float32, 0.0), (torch.float32, 0.25)]
    # (gated, F, D, N, cases): CLAM's pools at D 256, gated and ungated;
    # CLAM "big" (gated, D 384) in bf16; bags of TAIL_N rows (K7's row
    # tails); ABMIL's mode (ungated, D 128, dropout 0) at its own width; then
    # f32 at the three widths on TAIL_N-row bags; then the padded widths
    modes = [(True, L1, D, N_MAIN, bf16 + f32[:1]), (False, L1, D, N_MAIN, bf16 + f32[:1]),
             (True, L1, CLAM_BIG_D, N_MAIN, bf16), (True, L1, D, TAIL_N, bf16),
             (False, L1, ABMIL_D, N_MAIN, bf16[:1] + f32[:1])]
    modes += [(gated, L1, d, TAIL_N, f32) for gated in (True, False)
              for d in (ABMIL_D, D, CLAM_BIG_D)]
    modes += [(gated, f, d, TAIL_N, bf16 + f32) for gated in (True, False)
              for f, d in ODD_WIDTHS]
    for gated, f, d, n, mode_cases in modes:
        for dtype, rate in mode_cases:
            x, w, mask, cots = pool_inputs(POOL_CHECK_BAGS, dtype, gen, dev, True, d, n, f)
            xg = x.clone().requires_grad_(True)
            ws = [v.clone().requires_grad_(True) for v in w]
            outs = att._AttentionPool.apply(xg, *ws, mask, gated, rate, 77)
            torch.autograd.backward(outs, cots)
            got = [o.detach() for o in outs] + [xg.grad] + [v.grad for v in ws]
            m, p, s = att.gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, 77)
            want = [m, p, s, *att.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots,
                                                                  gated, rate, 77)]
            held(f"K7 gated={gated} F={f} D={d} N={n} {dtype} dropout {rate}", got, want, names,
                 gated, dtype)
            del x, xg, got, want
    rates = gate_keep_rates(dev)
    print(f"K7 gate keep rate at dropout 0.25: stream 1 {rates[False]:.5f}, "
          f"streams 1 and 2 {rates[True]:.5f}")
    check(abs(rates[False] - 0.75) <= 0.0075, f"gate keep rate {rates[False]}")
    check(abs(rates[True] - 0.5625) <= 0.005625, f"joint gate keep rate {rates[True]}")

    def timed(b, n, d, gated, rate, dtype, fwd_too=True):
        """K7f (with ``fwd_too``) and K7b at (b, n, L1) in ``dtype``,
        unmasked but for the heatmap's bag (b 1: a masked tail), held to the
        plain twin on the same inputs (p the twin's), then timed: median ms
        of each and of its twin, one call of each split by sub-kernel, and
        the bounds (gate products 2 R F D per gate forward; recomputed, then
        dx and dW in the backward; pool and dp 2 R F) at bf16's rate or, in
        f32, the f32 products at TF32's."""
        is32 = dtype == torch.float32
        x, w, mask, cots = pool_inputs(b, dtype, gen, dev, False, d, n)
        if b == 1:
            mask = torch.arange(n, device=dev)[None, :] < n - 416
        m, p, s = att.gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, 77)
        fns = {"fwd": lambda: att._pool_fwd_cuda(x, *w, mask, gated, rate, 77),
               "bwd": lambda: att._pool_bwd_cuda(x, *w[:5], mask, p, *cots, gated, rate, 77)}
        plain = {"fwd": lambda: att.gated_attention_pool_plain_fwd(x, *w, mask, gated, rate, 77),
                 "bwd": lambda: att.gated_attention_pool_plain_bwd(x, *w[:5], mask, p, *cots,
                                                                   gated, rate, 77)}
        mode = (f"({b}, {n}, {L1}) {'f32' if is32 else 'bf16'} "
                f"{'gated' if gated else 'ungated'}, D {d}, dropout {rate}")
        sides = ("fwd", "bwd") if fwd_too else ("bwd",)
        if fwd_too:
            held(f"K7f at {mode}", fns["fwd"](), (m, p, s), names[:3], gated, dtype)
        del m, s
        held(f"K7b at {mode}", fns["bwd"](), plain["bwd"](), names[3:], gated, dtype)
        torch.cuda.empty_cache()
        res = {}
        for k in sides:
            res[k] = median_ms(fns[k], reps=3)
            split = kernel_split(fns[k])
            res["split_" + k] = name_wgrads(split, ("dWa+dWb",)) if k == "bwd" else split
        if gated and b > 1:
            res["twice"] = determinism(f"K7b at {mode}", fns["bwd"], names[3:], ("dx",))
        torch.cuda.empty_cache()
        for k in sides:
            res[k + "_plain"] = median_ms(plain[k], reps=3)
        r, gates = b * n, 2 * b * n * L1 * d * (2 if gated else 1)
        peak = TF32_FLOPS if is32 else BF16_FLOPS
        res["fwd_bound"] = bound(gates + 2 * r * L1, nbytes(x, mask) + r * 8 + b * L1 * 4, peak)
        res["bwd_bound"] = bound(3 * gates + 2 * r * L1, 2 * nbytes(x) + nbytes(mask, p, *cots),
                                 peak)
        for k in sides:
            print_split(f"K7{k[0]} at {mode}", res["split_" + k], res[k])
        print_rates(f"K7 at {mode}", [e for k in sides for e in res["split_" + k]],
                    pool_work(b, d, gated, is32, n))
        print(f"K7 at {mode}: " + "; ".join(
            f"K7{k[0]} {res[k]:.3f} ms vs plain {res[k + '_plain']:.3f}, bound "
            f"{res[k + '_bound'][0]:.4f} (by {res[k + '_bound'][1]})" for k in sides)
            + f"; the products at {peak / 1e12:.0f} TFLOP/s"
            + (" (the f32 products at TF32's rate)" if is32 else "")
            + f", the bytes at {HBM_BPS / 1e12} TB/s")
        del x, p, cots
        torch.cuda.empty_cache()
        return res

    sup = timed(POOL_BAGS, N_MAIN, D, True, 0.25, torch.bfloat16)  # supervised stage 1
    abmil = timed(B_MAIN, N_MAIN, ABMIL_D, False, 0.0, torch.bfloat16)  # ABMIL's stage 1
    out = []
    for k in ("fwd", "bwd"):
        out.append({"ms": sup[k], "plain_ms": sup[k + "_plain"],
                    "max_abs_err": errs[torch.bfloat16][k],
                    "bound_ms": sup[k + "_bound"][0], "bound_by": sup[k + "_bound"][1],
                    "split_ms": dict(sup["split_" + k]), "abmil_ms": abmil[k],
                    "abmil_plain_ms": abmil[k + "_plain"], "abmil_bound_ms": abmil[k + "_bound"][0],
                    "abmil_split_ms": dict(abmil["split_" + k])})
    out[1]["twice"] = sup["twice"]
    # the f32 route at the same shapes, and K7b at K8's op backward
    runs32 = {"sup": timed(POOL_BAGS, N_MAIN, D, True, 0.25, torch.float32),
              "abmil": timed(B_MAIN, N_MAIN, ABMIL_D, False, 0.0, torch.float32),
              "k8": timed(*K8_MAIN, D, True, 0.0, torch.float32, fwd_too=False)}
    e = errs[torch.float32]
    res32 = {"max_rel": e["rel"], "max_abs_err_fwd": e["fwd"], "max_abs_err_bwd": e["bwd"],
             "sup_bwd_twice": runs32["sup"]["twice"]}
    for tag, t in runs32.items():
        for k in ("fwd", "bwd"):
            if k in t:
                res32.update({f"{tag}_{k}_ms": t[k], f"{tag}_{k}_plain_ms": t[k + "_plain"],
                              f"{tag}_{k}_bound_ms": t[k + "_bound"][0],
                              f"{tag}_{k}_bound_by": t[k + "_bound"][1],
                              f"{tag}_{k}_split_ms": dict(t["split_" + k])})
    check(res32["k8_bwd_ms"] < res32["k8_bwd_plain_ms"],
          f"K7b f32 at {K8_MAIN}: {res32['k8_bwd_ms']} ms, not faster than the plain twin's "
          f"{res32['k8_bwd_plain_ms']}")
    return out[0], out[1], res32


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
    side), flops, mma_flops)``; ``mma_flops``, the bf16 products the kernel
    issues (three per f32 product), is a note for the text line."""
    import torch

    gates = 4 * n * L1 * D
    rest = 2 * n * D + 2 * n * L1
    f32 = dtype == torch.float32
    io = n * L1 * (4 if f32 else 2) + n + n * 4 + L1 * 4
    return (bound(gates + rest, io, TF32_FLOPS if f32 else BF16_FLOPS), gates + rest,
            (3 if f32 else 1) * gates + rest)


def tiled_work(n: int, dtype) -> dict:
    """K8's sub-kernels at (1, n, L1 -> D) gated: (FLOPs, device-memory
    bytes) each must do (``csrc/attention_tiled.cu``'s reckoning): in f32
    split_kernel writes x's two bf16 planes (as many bytes as x), which the
    gate pass reads; the chunk pass reads x, s and the mask and writes the
    chunks' partials, which the merge reads."""
    import torch

    from murcl_tpu_torch.ops.attention import tiled_chunk

    x = n * L1 * (4 if dtype == torch.float32 else 2)
    parts = -(-n // tiled_chunk(1, n)) * (L1 + 2) * 4
    return {"split_kernel": (0, 2 * x), "pool_gates_fwd_wg": (4 * n * L1 * D, x + n * 4),
            "chunk_kernel": (2 * n * L1, x + n * 5 + parts),
            "combine_kernel": (2 * parts // 4, parts + L1 * 4)}


def check_tiled(dev, gen):
    """K8 against its twin: the heatmap's largest bag (1, 60416, 512) f32
    gated with a masked tail, and (4, 12288, 512) gated and ungated in f32
    and bf16 (bags live for 12288 rows, 11288 (ending mid-chunk), 12000 and
    5000 (later chunks all masked)). One backward through the op (K7b) at
    (1, 60416, 512) f32 against the plain backward, timed. K8 timed at (1,
    60416, 512) and (1, 12288, 512) in f32 and bf16 beside its twin and its
    bound, split by sub-kernel with each one's achieved rates; fails unless
    faster than the twin in f32 at both lengths."""
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
    for n, dtype in ((n1, torch.float32), (n4, torch.float32), (n1, torch.bfloat16),
                     (n4, torch.bfloat16)):
        x, w, mask = tiled_inputs(1, n, dtype, gen, dev, [n - 416])
        fwd = lambda: att._tiled_fwd_cuda(x, *w, mask, True)  # noqa: E731
        ms = median_ms(fwd)
        plain_ms = median_ms(lambda: att.attention_pool_tiled_plain(x, *w, mask, True))
        split = kernel_split(fwd)
        dev_ms, enq_ms = device_ms(fwd, own=False), enqueue_ms(fwd)
        (b_ms, b_by), flops, mma_flops = tiled_bound(n, dtype)
        what = f"K8 at (1, {n}, {L1}) {str(dtype).split('.')[-1]} gated"
        rate = "495 TFLOP/s (TF32)" if dtype == torch.float32 else "989 TFLOP/s (bf16)"
        print(f"{what}: {ms:.3f} ms vs plain {plain_ms:.3f} ms (device {dev_ms:.3f} ms a call, "
              f"PyTorch's softmax for p included; host enqueue {enq_ms:.3f} ms); one call by "
              "sub-kernel: " + ", ".join(f"{k} {v:.3f} ms" for k, v in split)
              + f"; bound {b_ms:.4f} ms ({b_by}: {flops / 1e9:.2f} GFLOP at {rate}), "
              f"{flops / ms / 1e9:.1f} TFLOP/s of the function's work; the kernel issues "
              f"{mma_flops / 1e9:.2f} GFLOP of bf16 products")
        print_rates(what, split, tiled_work(n, dtype))
        if dtype == torch.float32:
            check(ms < plain_ms, f"{what}: {ms} ms, not faster than the plain twin's {plain_ms}")
        tag = ("" if dtype == torch.float32 else "_bf16") + ("" if n == n1 else "_12288")
        res.update({"ms" + tag: ms, "plain_ms" + tag: plain_ms, "bound_ms" + tag: b_ms,
                    "split_ms" + tag: dict(split), "device_ms" + tag: dev_ms,
                    "enqueue_ms" + tag: enq_ms})
        if not tag:
            res["bound_by"] = b_by
        del x
        torch.cuda.empty_cache()
    return res


# the ablation path: the ports of the JAX package's K2/K3 probes
# (murcl_tpu_torch/scripts/dbg_bwd_ablate.py, dbg_vpu_lean.py,
# dbg_mxu_vpu_overlap.py), each variant under its own launch count
ABLATE_SHAPE = (B_MAIN, N_MAIN, FIN, L1, D)  # the JAX scripts' (1536, 1024, 512, 512, 256)
ABLATE_CHECK_BAGS = 64  # bags in the second comparison, with a score cotangent
ABLATE_FIN = 1000  # K2/K3's padded route: a Fin the kernels do not take
ABLATE_GRADS = ("dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc")
BWD_ZERO = {"full": (), "nodrop": (), "nowgrad": ("dwf", "dbf", "dwa", "dba", "dwb", "dbb"),
            "nodx": ("dwf", "dbf"), "recompute": ("dwf", "dbf", "dwa", "dba", "dwb", "dbb"),
            "prelean": (), "lean2": ()}
# dbg_vpu_lean's timed kernels (its names) and the variants they run
LEAN_BWD = {"bwd full": "prelean", "bwd lean": "full", "bwd lean2": "lean2"}
LEAN_FWD = {"fwd full": "prelean", "fwd lean": "lean"}
# lean2 in bf16: dWf and dbf, which its one rounding of dx moves (2.9e-3 of
# dWf from the production kernel's on the H100), held between that gap and
# the kernel's noise against its twin (3-5e-4)
LEAN2_TOL = 1e-3
OVERLAP_STEPS, OVERLAP_ROWS = 256, 1024


def ablation_work(variant: str, b: int = B_MAIN) -> float:
    """The products' FLOPs of K3's ablation ``variant`` (``fwd_lean`` and
    ``fwd_prelean``: K2) at (b, N_MAIN, FIN) -> L1 -> D, gated: K3 recomputes
    the trunk and the gates, takes dp, dx through the gates, dWa + dWb and
    dWf; nowgrad drops the weight gradients, nodx dx and dWf, recompute all
    three."""
    r = b * N_MAIN
    trunk, gates, dp = 2 * r * FIN * L1, 4 * r * L1 * D, 2 * r * L1
    return {"fwd_lean": trunk + gates + dp, "fwd_prelean": trunk + gates + dp,
            "nowgrad": trunk + 2 * gates + dp, "nodx": trunk + 2 * gates + dp,
            "recompute": trunk + gates + dp}.get(variant, 2 * trunk + 3 * gates + dp)


def trunk_abs_ds(h, w, mask, p, gm, gp, gs, rate, seed) -> float:
    """sum |ds| of K3's softmax backward, ds = p (dp - c) + gs with dp = xc .
    rnd(gm) + gp, as the twin takes it: the scale of dbc's rounding error,
    where dbc = sum ds cancels near 0 (the scripts' gs = 0)."""
    import torch

    from murcl_tpu_torch.ops.attention import _trunk

    xc = _trunk(h, *w[:6], rate, seed)[0]
    dp = (xc.float() @ gm.to(h.dtype).float().unsqueeze(-1)).squeeze(-1) + gp
    del xc
    ds = torch.where(mask, p * (dp - (p * dp).sum(-1, keepdim=True)), 0.0) + gs
    return float(ds.abs().sum())


def hold_bwd(what, got, want, variant, tol, abs_ds=None, tols=None) -> float:
    """One K3 variant's gradients against its twin's: those it skips exact
    zeros, the others within ``tol`` relative Frobenius (``tols`` per name),
    dbc, given ``abs_ds``, within ``tol`` of it. Prints the errors; returns
    the largest absolute one."""
    rels = {}
    for n, g, wv in zip(ABLATE_GRADS, got, want):
        if n in BWD_ZERO[variant]:
            check(not g.any() and not wv.any(), f"{what}: {n} not zero")
        elif n == "dbc" and abs_ds is not None:
            rels[n] = float((g - wv).abs()) / abs_ds
        else:
            rels[n] = rel_err(g, wv)
    lim = {n: (tols or {}).get(n, tol) for n in rels}
    print(f"{what} against its twin: " + ", ".join(
        f"{n} {e:.2e}" + (" of sum |ds|" if n == "dbc" and abs_ds is not None else "")
        for n, e in rels.items()))
    check(all(rels[n] <= lim[n] for n in rels), f"{what}: {rels} over {lim}")
    return max(float((g.float() - wv.float()).abs().max()) for g, wv in zip(got, want))


def ablation_path(dev):
    """The K2/K3 ablation probes: the three scripts at their JAX shapes, every
    launch count 0 before and read after (each variant must have launched),
    each kernel's outputs kept from its last timed call. Then, not counted:
    those outputs against the twins on the same inputs, the twins timed
    (bf16 2e-2, f32 1e-4 relative Frobenius; dbc, which cancels near 0 at
    the scripts' zero score cotangent, within that of the twin's sum |ds|;
    lean2's dWf and dbf in bf16 within ``LEAN2_TOL`` and further from the
    production kernel's than from its twin's; the gradients a variant skips
    exact zeros; K2's pre-lean bitwise its lean), the overlap's modes
    against theirs (2e-2) and bitwise against each other; every variant
    again at ``ABLATE_CHECK_BAGS`` bags with a score cotangent, in both
    dtypes; K2/K3 at Fin ``ABLATE_FIN`` (zero-padded) against the twin.
    Prints K3's split in both dtypes, the lean diffs and the overlap's
    verdict; returns the kernel rows' numbers (``err`` at the scripts'
    shapes, ``err64`` at 64 bags)."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.ops import attention as att
    from murcl_tpu_torch.ops.overlap import MODES, overlap_plain
    from murcl_tpu_torch.scripts import dbg_bwd_ablate, dbg_mxu_vpu_overlap, dbg_vpu_lean
    from murcl_tpu_torch.scripts.probes import median_ms as timed
    from murcl_tpu_torch.scripts.probes import trunk_inputs

    card = card_line()
    kept = {"bwd": {}, "lean": {}, "overlap": {}}
    _cuda.reset_launch_counts()
    bwd = dbg_bwd_ablate.run(str(dev), outs=kept["bwd"])
    lean = dbg_vpu_lean.run(str(dev), outs=kept["lean"])
    ovl = dbg_mxu_vpu_overlap.run(str(dev), outs=kept["overlap"])
    launches = {k: v for k, v in _cuda.LAUNCHES.items()
                if k.startswith(("trunk_", "overlap_"))}
    check(all(launches.values()), f"ablation kernels not launched: {launches}")
    check(not any(v for k, v in _cuda.LAUNCHES.items() if k not in launches),
          f"the probes launched production kernels: {_cuda.LAUNCHES}")
    for dt, t in bwd.items():
        print(f"K3 {dt} at {ABLATE_SHAPE[:3]} split by ablation: weight gradients (full - "
              f"nowgrad) {t['full'] - t['nowgrad']:.2f} ms, dx chain (full - nodx) "
              f"{t['full'] - t['nodx']:.2f} ms, floor (recompute) {t['recompute']:.2f} ms, "
              f"hash (full - nodrop) {t['full'] - t['nodrop']:.2f} ms of {t['full']:.2f} ({card})")
    print(f"K2/K3 lean (bf16): fwd max|diff| {lean['fwd_max_diff']}; bwd lean rel "
          f"{max(lean['bwd_rel']['lean'].values()):.2e}, lean2 rel dwf "
          f"{lean['bwd_rel']['lean2']['dwf']:.2e}; ms "
          + ", ".join(f"{k} {v:.2f}" for k, v in lean["ms"].items()) + f" ({card})")
    print(f"overlap: mxu {ovl['mxu']:.3f}, vpu {ovl['vpu']:.3f}, dep {ovl['dep']:.3f}, indep "
          f"{ovl['indep']:.3f} ms, verdict {'OVERLAP' if ovl['overlap'] else 'NO overlap'}, "
          f"indep hid {ovl['hidden']:.2f} of the shorter side ({card})")

    res = {"launches": launches, "bwd": bwd, "lean": lean, "overlap": ovl, "err": {},
           "err64": {}, "plain": {}}

    def note(table, key, err):
        table[key] = max(table.get(key, 0.0), err)

    # the kernels' outputs at the scripts' shape against the twins there
    for dtype, tol, dt in ((torch.bfloat16, 2e-2, "bfloat16"), (torch.float32, 1e-4, "float32")):
        sfx = "" if dt == "bfloat16" else "_f32"
        h, w, mask, p, cots = trunk_inputs(ABLATE_SHAPE, dtype, dev)
        abs_ds = {r: trunk_abs_ds(h, w, mask, p, *cots, r, dbg_bwd_ablate.SEED)
                  for r in (dbg_bwd_ablate.DROPOUT, 0.0)}
        got = {v: [("dbg_bwd_ablate", kept["bwd"][dt][v])] for v in dbg_bwd_ablate.VARIANTS}
        if dt == "bfloat16":
            for tag, v in LEAN_BWD.items():
                got.setdefault(v, []).append((f"dbg_vpu_lean {tag}", kept["lean"][tag]))
        want = {}
        for v, outs in got.items():
            res["plain"][f"trunk_bwd_{v}{sfx}"], want[v] = timed(
                lambda: att.fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots,
                                                  dbg_bwd_ablate.DROPOUT, dbg_bwd_ablate.SEED,
                                                  variant=v), dev, reps=1)
            tols = {"dwf": LEAN2_TOL, "dbf": LEAN2_TOL} if (v, dt) == ("lean2", "bfloat16") else {}
            for who, g in outs:
                note(res["err"], f"trunk_bwd_{v}{sfx}", hold_bwd(
                    f"K3 {v} {dt} at {ABLATE_SHAPE[:3]} ({who}), gs 0", g, want[v], v, tol,
                    abs_ds[0.0 if v == "nodrop" else dbg_bwd_ablate.DROPOUT], tols))
        if dt == "bfloat16":  # lean2 apart from the production kernel, nearer its own twin
            lean2, prod = kept["lean"]["bwd lean2"][0], kept["lean"]["bwd lean"][0]
            to_prod, to_twin = rel_err(lean2, prod), rel_err(lean2, want["lean2"][0])
            print(f"K3 lean2 bf16 dWf: {to_prod:.2e} from the production kernel's, "
                  f"{to_twin:.2e} from its twin's")
            check(to_prod > 2 * to_twin, f"K3 lean2: dWf {to_prod} from the production "
                  f"kernel's, {to_twin} from its twin's")
            for tag, v in LEAN_FWD.items():
                res["plain"][f"trunk_fwd_{v}"], want_f = timed(lambda: att.fused_trunk_plain_fwd(
                    h, *w, mask, 0.25, 7, lean=v == "lean"), dev, reps=1)
                rels = [rel_err(g, wv) for g, wv in zip(kept["lean"][tag], want_f)]
                print(f"K2 {v} bf16 at {ABLATE_SHAPE[:3]} against its twin: M, p, s " +
                      ", ".join(f"{e:.2e}" for e in rels))
                check(max(rels) <= tol, f"K2 {v} {dt}: {rels}")
                note(res["err"], f"trunk_fwd_{v}", max(
                    float((g - wv).abs().max()) for g, wv in zip(kept["lean"][tag], want_f)))
            check(all(torch.equal(a, b) for a, b in zip(kept["lean"]["fwd lean"],
                                                          kept["lean"]["fwd full"])),
                  f"K2 pre-lean not bitwise lean at {ABLATE_SHAPE[:3]}")
        del h, w, p, cots, want
        torch.cuda.empty_cache()

    # every variant again at 64 bags, with a score cotangent (dbc away from
    # its cancellation), in both dtypes
    for dtype, tol, dt in ((torch.bfloat16, 2e-2, "bfloat16"), (torch.float32, 1e-4, "float32")):
        sfx = "" if dt == "bfloat16" else "_f32"
        shape = (ABLATE_CHECK_BAGS, *ABLATE_SHAPE[1:])
        h, w, mask, p, (gm, gp, _) = trunk_inputs(shape, dtype, dev)
        gs = torch.randn(p.shape, device=dev) * 0.01
        outs = {}
        for v in BWD_ZERO:
            outs[v] = att.fused_trunk_ablate_bwd(v, h, *w[:7], mask, p, gm, gp, gs, 0.25, 7)
            want = att.fused_trunk_plain_bwd(h, *w[:7], mask, p, gm, gp, gs, 0.25, 7, variant=v)
            tols = {"dwf": LEAN2_TOL, "dbf": LEAN2_TOL} if (v, dt) == ("lean2", "bfloat16") else {}
            note(res["err64"], f"trunk_bwd_{v}{sfx}", hold_bwd(
                f"K3 {v} {dt} at {shape[:3]} dropout 0.25", outs[v], want, v, tol, tols=tols))
        if dt == "bfloat16":
            to_prod = rel_err(outs["lean2"][0], outs["full"][0])
            to_twin = rel_err(outs["lean2"][0], att.fused_trunk_plain_bwd(
                h, *w[:7], mask, p, gm, gp, gs, 0.25, 7, variant="lean2")[0])
            check(to_prod > 2 * to_twin, f"K3 lean2 at {shape[:3]}: dWf {to_prod} from the "
                  f"production kernel's, {to_twin} from its twin's")
        fwd = {}
        for v in ("lean", "prelean"):
            fwd[v] = att.fused_trunk_ablate_fwd(v, h, *w, mask, 0.25, 7)
            want = att.fused_trunk_plain_fwd(h, *w, mask, 0.25, 7, lean=v == "lean")
            rels = [rel_err(g, wv) for g, wv in zip(fwd[v], want)]
            check(max(rels) <= tol, f"K2 {v} {dt}: {rels}")
            note(res["err64"], f"trunk_fwd_{v}{sfx}",
                 max(float((g - wv).abs().max()) for g, wv in zip(fwd[v], want)))
        check(all(torch.equal(a, b) for a, b in zip(fwd["lean"], fwd["prelean"])),
              f"K2 pre-lean not bitwise lean ({dt})")
        del h, outs, fwd
        torch.cuda.empty_cache()

    # the overlap's modes, from their timed calls, against their twins
    x, y, wo = dbg_mxu_vpu_overlap.inputs(dev, OVERLAP_STEPS, OVERLAP_ROWS)
    got = kept["overlap"]
    for m in MODES:
        res["plain"][f"overlap_{m}"], want = timed(lambda: overlap_plain(m, x, y, wo), dev, reps=1)
        rels = [rel_err(g, wv) for g, wv in zip(got[m], want)]
        print(f"overlap {m} at ({OVERLAP_STEPS}, {OVERLAP_ROWS}, 512) against its twin: rel err "
              f"m {rels[0]:.2e}, v {rels[1]:.2e}")
        check(max(rels) <= 2e-2, f"overlap {m}: {rels}")
        res["err"][f"overlap_{m}"] = max(float((g - wv).abs().max())
                                         for g, wv in zip(got[m], want))
    check(torch.equal(got["dep"][0], got["mxu"][0]) and torch.equal(got["indep"][0], got["mxu"][0])
          and torch.equal(got["indep"][1], got["vpu"][1]), "overlap: modes' sums not bitwise")
    del x, y

    # K2/K3's padded route: Fin 1000 (to 1024), mixed bf16 and unmixed f32 with dh
    for dtype, tol, mixed, need_dh in ((torch.bfloat16, 2e-2, True, False),
                                       (torch.float32, 1e-4, False, True)):
        gen = torch.Generator(device=dev).manual_seed(4)
        h, w, mask, mix, cots = fused_inputs(8, dtype, gen, dev, True)
        h = torch.randn(*h.shape[:2], ABLATE_FIN, generator=gen, device=dev).to(dtype)
        w[0] = torch.randn(ABLATE_FIN, L1, generator=gen, device=dev) * ABLATE_FIN ** -0.5
        got = run_fused(h, w, mask, 0.25, 77, mix if mixed else None, cots, True, need_dh)
        want = run_plain(h, w, mask, 0.25, 77, mix if mixed else (None, None), cots, True,
                         need_dh)
        names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc", "dh"]
        rels = {n: rel_err(g, wv) for n, g, wv in zip(names, got, want)}
        print(f"K2/K3 at Fin {ABLATE_FIN} (zero-padded to 1024) {dtype} mixed={mixed} "
              f"dh={need_dh} dropout 0.25: rel err "
              + ", ".join(f"{n} {e:.2e}" for n, e in rels.items()))
        check(max(rels.values()) <= tol, f"K2/K3 at Fin {ABLATE_FIN}: {rels}")
        del h, got, want
    torch.cuda.empty_cache()
    return res


# the compaction and dropout probes: the ports of the JAX package's
# scripts/tpu_smoke.py mask writer (murcl_tpu_torch/scripts/dropout_smoke.py)
# and of its one-hot compaction probes (dbg_compact_ablate.py,
# dbg_grouped_ablate.py, dbg_grouped_gate.py), each variant under its own
# launch count, at the JAX scripts' shapes
PROBE_REPS = 5  # the scripts' timed calls, after one warm-up
# each compaction script times K1 on its inputs (a warm-up and PROBE_REPS
# calls); dropout_smoke runs K7 three times for its determinism and once
# through its backward for d/dwc
PROBE_PRODUCTION = {"compact": 3 * (1 + PROBE_REPS), "attention_pool_fwd": 4,
                    "attention_pool_bwd": 1}
NOONEHOT_TOL = 1e-2  # its tile sums of 128 rows in f32, taken in another order
PADDED_TRUNK = (200, 100)  # K2/K3's L1 and D, zero-padded to 256 and 128


def compaction_bound(bank, offs, ranks, nump, feat: int, window: int = 0):
    """K1's bound (bytes) for the function on these inputs: the bank rows it
    reads (each once; ``window``: the windows' first ``window`` rows,
    dmafloor's copy), the indices, and the sub-bags written."""
    import torch

    b, nmax = ranks.shape
    p = torch.arange(nmax, device=ranks.device)[None, :]
    live = (p < window) if window else ((ranks >= 0) & (p < nump[:, None]))
    read = torch.unique((offs[:, None] + p).expand(b, nmax)[live.expand(b, nmax)]).numel()
    return bound(0, read * bank.shape[1] * 2 + nbytes(ranks, offs, nump)
                 + b * feat * bank.shape[1] * 2, BF16_FLOPS)


def compaction_probe_path(dev):
    """The compaction and dropout probes: the four scripts at their JAX
    shapes, every launch count 0 before and read after (each new kernel
    must have launched, and the production kernels only as the scripts call
    them: K1's line and K7's checks), each variant's output kept from its
    last timed call. Then, not counted: the masks bitwise against their twin
    (and the script's two checks: the keep rate within 0.02 of 0.75, d/dwc
    within 1e-2 of the rebuild with the masks); each compaction variant
    against its twin on the script's inputs, bitwise (``noonehot`` within
    ``NOONEHOT_TOL`` relative Frobenius), those that keep the result also
    bitwise K1's twin's, the twins timed; K2/K3 at ``PADDED_TRUNK`` (L1 and
    D zero-padded) against the twin at the logical widths in bf16 (mixed)
    and f32 (with dh), dropout 0.25, at the K2/K3 tolerances (dbc, which
    cancels within each bag, of the twin's sum |ds|). Returns the kernel
    rows' numbers."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.ops.compact import gather_compact_plain
    from murcl_tpu_torch.ops.compact_probes import KEEPS_RESULT, PROBES, onehot_compact_plain
    from murcl_tpu_torch.ops.gate_masks import gate_keep_masks_plain
    from murcl_tpu_torch.ops.mixup import apply_mix
    from murcl_tpu_torch.scripts import (dbg_compact_ablate, dbg_grouped_ablate,
                                         dbg_grouped_gate, dropout_smoke)
    from murcl_tpu_torch.scripts.probes import median_ms as timed

    card = card_line()
    scripts = {"compact": dbg_compact_ablate, "grouped": dbg_grouped_ablate,
               "gate": dbg_grouped_gate}
    kept = {k: {} for k in ("dropout", *scripts)}
    _cuda.reset_launch_counts()
    drop = dropout_smoke.run(str(dev), reps=PROBE_REPS, outs=kept["dropout"])
    times = {k: m.run(str(dev), reps=PROBE_REPS, outs=kept[k]) for k, m in scripts.items()}
    launches = {k: v for k, v in _cuda.LAUNCHES.items()
                if k == "gate_masks" or k.startswith("onehot_")}
    check(all(launches.values()), f"probe kernels not launched: {launches}")
    production = {k: v for k, v in _cuda.LAUNCHES.items() if v and k not in launches}
    check(production == PROBE_PRODUCTION, f"the probes' production launches: {production}, "
          f"expected {PROBE_PRODUCTION}")
    res = {"launches": launches, "times": times, "dropout": drop, "err": {}, "plain": {},
           "bound": {}, "floor": {}}

    # the masks against their twin
    b, n, _, d = dropout_smoke.SHAPE
    res["plain"]["gate_masks"], want = timed(lambda: gate_keep_masks_plain(
        dropout_smoke.MASK_SEED, dropout_smoke.RATE, b, n, d, dev), dev, reps=1)
    check(all(torch.equal(g, wv) for g, wv in zip(kept["dropout"]["masks"], want)),
          "gate masks not bitwise their twin")
    res["err"]["gate_masks"] = 0.0
    res["bound"]["gate_masks"] = bound(0, 2 * b * n * d, BF16_FLOPS)
    print(f"gate masks at {(b, n, d)} seed {dropout_smoke.MASK_SEED}: bitwise the twin, keep "
          f"rate {drop['keep_rate'][0]:.4f} / {drop['keep_rate'][1]:.4f}, d/dwc rel "
          f"{drop['grad_rel']:.2e}; writer {drop['ms']:.4f} ms vs twin "
          f"{res['plain']['gate_masks']:.3f} ms ({card})")

    # each compaction variant against its twin on the script's inputs
    for script, mod in scripts.items():
        bank, offs, ranks, nump = kept[script].pop("inputs")
        slides = mod.SHAPE[0] if script != "compact" else 0
        feat = mod.SHAPE[-1]
        k1 = gather_compact_plain(bank, offs, ranks, feat, nump)
        fn_bound = compaction_bound(bank, offs, ranks, nump, feat)
        for v in mod.VARIANTS:
            name = f"onehot_{script}_{v}"
            probe = PROBES[script][v]
            res["plain"][name], want = timed(lambda: onehot_compact_plain(
                probe, bank, offs, ranks, feat, nump, slides), dev, reps=1)
            got = kept[script].pop(v)
            if v == "noonehot":
                err = rel_err(got.float(), want.float())
                check(err <= NOONEHOT_TOL, f"{name}: rel err {err}")
            else:
                check(torch.equal(got.view(torch.int16), want.view(torch.int16)),
                      f"{name} not bitwise its twin")
            if (script, v) in KEEPS_RESULT:
                check(torch.equal(got, k1), f"{name} not bitwise K1's twin")
            res["err"][name] = float((got.float() - want.float()).abs().max())
            res["bound"][name] = (compaction_bound(bank, offs, ranks, nump, feat, feat)
                                  if probe.dmafloor else fn_bound)
            bsz, nmax = ranks.shape
            if probe.dmafloor:  # its own bytes: each window (a group's once) read, F rows written
                rows = bsz // probe.group * nmax
                res["floor"][name] = bound(0, rows * bank.shape[1] * 2
                                           + bsz * feat * bank.shape[1] * 2, BF16_FLOPS)
            else:  # the one-hot products: a (256 x 128) by (128 x D) product per tile
                res["floor"][name] = bound(bsz * (nmax // 128) * 2 * 256 * 128 * bank.shape[1],
                                           0, BF16_FLOPS)
            del got, want
        print(f"{script} probes at {mod.SHAPE}: every variant against its twin (bitwise; "
              f"noonehot {NOONEHOT_TOL:g}); K1 {times[script]['production']:.3f} ms, "
              + ", ".join(f"{v} {times[script][v]:.3f}" for v in mod.VARIANTS)
              + f" ms; function bound {fn_bound[0]:.3f} ms ({card})")
        del bank, offs, ranks, nump, k1
        torch.cuda.empty_cache()

    # K2/K3 at L1 and D the kernels do not take (zero-padded by the op)
    l1, d = PADDED_TRUNK
    res["padded_trunk"] = {}
    for dtype, tol, mixed, need_dh in ((torch.bfloat16, 2e-2, True, False),
                                       (torch.float32, 1e-4, False, True)):
        gen = torch.Generator(device=dev).manual_seed(5)
        h, w, mask, mix, cots = fused_inputs(8, dtype, gen, dev, True, l1=l1, d=d)
        got = run_fused(h, w, mask, 0.25, 77, mix if mixed else None, cots, True, need_dh)
        want = run_plain(h, w, mask, 0.25, 77, mix if mixed else (None, None), cots, True,
                         need_dh)
        names = ["M", "p", "s", "dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc", "dh"]
        rels = {nm: rel_err(g, wv) for nm, g, wv in zip(names, got, want) if nm != "dbc"}
        # dbc = sum ds cancels within each bag: held, as the ablation path
        # holds it, against the scale of its rounding error, sum |ds|
        abs_ds = trunk_abs_ds(apply_mix(h, *mix) if mixed else h, w, mask, want[1], *cots, 0.25,
                              77)
        rels["dbc"] = float((got[10] - want[10]).abs()) / abs_ds
        print(f"K2/K3 at L1 {l1}, D {d} (zero-padded to 256, 128) {dtype} mixed={mixed} "
              f"dh={need_dh} dropout 0.25: rel err "
              + ", ".join(f"{nm} {e:.2e}" for nm, e in rels.items()) + " (dbc of sum |ds|)")
        check(max(rels.values()) <= tol, f"K2/K3 at L1 {l1}, D {d}: {rels}")
        res["padded_trunk"]["float32" if dtype == torch.float32 else "bfloat16"] = max(
            rels.values())
        del h, got, want
    torch.cuda.empty_cache()
    return res


# the preprocessing path: synthetic 40x slides of this (height, width), tiled
# at 20x with 256-pixel patches (each read at 512 px and resized, as
# Camelyon16's 40x slides are cut) and a 1/32 mask; ResNet18 at batch 256;
# its encoder timed alone over PRE_TIMED patches; k-means K 10 per slide
PRE_SLIDES, PRE_HW, PRE_MAG, PRE_PATCH, PRE_SCALE = 2, (12288, 16384), 20, 256, 32
PRE_BATCH, PRE_TIMED, PRE_CHECK = 256, 4096, 64
# the slide files: deflate TIFF pyramids of 256-pixel tiles at downsamples 1, 4 and 16
PRE_TILE, PRE_LEVELS = 256, (1, 4, 16)
PRE_JPEG_SLIDES = 2  # JPEG-tiled pyramids of the same size and levels


def encoder_flops(name: str, size: int) -> float:
    """The encoder's multiply-adds x 2 for one ``size``-pixel patch, counted
    from its convolutions' and products' output shapes."""
    import torch

    from murcl_tpu_torch.preprocess.resnet import create_encoder

    model, _ = create_encoder(name)
    total = [0]

    def hook(mod, inp, out):
        if isinstance(mod, torch.nn.Conv2d):
            k = mod.in_channels // mod.groups * mod.kernel_size[0] * mod.kernel_size[1]
            total[0] += 2 * out.numel() * k
        elif isinstance(mod, torch.nn.Linear):
            total[0] += 2 * out.numel() * mod.in_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear))]
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size))
    for h in handles:
        h.remove()
    return float(total[0])


def nvjpeg_path(dev, root):
    """nvJPEG on the card against PIL: the committed fixture's tiles
    (``preprocess/fixtures/jpeg_tiles.npz``: 48 x 48 tiles with their
    JPEGTables split out, YCbCr 4:4:4 and 4:2:0, and RGB without an Adobe
    marker) decoded and held to ``FIXTURE_BOUND`` (max and mean absolute
    difference from PIL's decode), then decoded for half a second on one
    thread (tiles/s, MB/s of JPEG in and of pixels out); and per variant a
    JPEG-tiled TIFF of those tiles (2 x 16 tiles) read whole through
    ``TiffSlide`` on the card, held to the same bound. Fails where
    libnvjpeg cannot be loaded."""
    import numpy as np

    from murcl_tpu_torch.data.synthetic import write_jpeg_fixture_tiff
    from murcl_tpu_torch.preprocess.nvjpeg import (FIXTURE_BOUND, NvJpegDecoder,
                                                   library_candidates, load_fixture)
    from murcl_tpu_torch.preprocess.slide_io import TiffSlide

    root = Path(root)
    root.mkdir(parents=True)
    dec = NvJpegDecoder(dev)
    print(f"nvJPEG: libnvjpeg from {[str(p) for p in library_candidates()][:1]}")
    try:
        for variant, fx in load_fixture().items():
            top, mean = FIXTURE_BOUND[variant]
            streams = [fx["tables"][:-2] + s[2:] for s in fx["streams"]]
            diffs = [np.abs(dec(st, fx["photometric"]).astype(int) - want)
                     for st, want in zip(streams, fx["decoded"])]
            worst = max(int(d.max()) for d in diffs)
            avg = float(np.mean([d.mean() for d in diffs]))
            check(worst <= top and avg <= mean,
                  f"nvJPEG {variant}: max {worst}, mean {avg:.4f} against PIL; bound {top}, "
                  f"{mean}")
            n, t = 0, time.perf_counter()
            while time.perf_counter() - t < 0.5:
                for st in streams:
                    dec(st, fx["photometric"])
                n += len(streams)
            dt = time.perf_counter() - t
            nbytes_in = sum(len(st) for st in streams) * n / len(streams)
            nbytes_out = fx["decoded"][0].nbytes * n
            path = root / f"{variant}.tif"
            img = write_jpeg_fixture_tiff(path, variant, repeat=8)
            slide = TiffSlide(path, device=dev)
            got = slide.read_region((0, 0), 0, slide.dimensions)[..., :3]
            tiles = slide._jpeg.decoded
            slide.close()
            d = np.abs(got.astype(int) - img)
            check(d.max() <= top and d.mean() <= mean and tiles == 32,
                  f"TiffSlide {variant} on the card: max {d.max()}, mean {d.mean():.4f}, "
                  f"{tiles} tiles decoded")
            print(f"nvJPEG {variant} (Photometric {fx['photometric']}): 4 fixture tiles against "
                  f"PIL max {worst}, mean {avg:.4f} (bound {top}, {mean}); "
                  f"{n / dt:.0f} tiles/s of 48 x 48 on one thread, {nbytes_in / dt / 1e6:.2f} "
                  f"MB/s of JPEG in, {nbytes_out / dt / 1e6:.2f} MB/s of RGB out; TiffSlide of "
                  f"{img.shape[1]} x {img.shape[0]} ({tiles} tiles) on the card: max {d.max()}, "
                  f"mean {d.mean():.4f} ({card_line()})")
    finally:
        dec.close()


def write_pre_slides(root) -> Path:
    """``PRE_SLIDES`` synthetic slides as ``.svs`` files: deflate TIFF
    pyramids (``PRE_LEVELS``, tiles of ``PRE_TILE``) with an Aperio
    description at 40x; slide 0 also as a single-level file under
    ``single/``. Returns the slides' directory."""
    import numpy as np

    from murcl_tpu_torch.data.synthetic import aperio_description, synthetic_slide, write_tiff

    root = Path(root)
    slide_dir, single = root / "slides", root / "single"
    slide_dir.mkdir(parents=True)
    single.mkdir()
    desc = aperio_description(PRE_HW[1], PRE_HW[0], PRE_TILE, app_mag=40)
    t0 = time.time()
    for i in range(PRE_SLIDES):
        img = synthetic_slide(*PRE_HW, seed=i)
        levels = [img] + [np.ascontiguousarray(img[::d, ::d]) for d in PRE_LEVELS[1:]]
        write_tiff(slide_dir / f"wsi_{i}.svs", levels, tile=PRE_TILE, description=desc)
        if i == 0:
            write_tiff(single / "wsi_0.svs", [img], tile=PRE_TILE, description=desc)
    size = sum(f.stat().st_size for f in slide_dir.iterdir()) / 2**20
    print(f"preprocess: {PRE_SLIDES} slides of {PRE_HW[1]} x {PRE_HW[0]} RGB at 40x written as "
          f"deflate TIFF pyramids (downsamples {PRE_LEVELS}, {PRE_TILE}-pixel tiles, "
          f"{size:.0f} MiB) and slide 0 single-level, in {time.time() - t0:.1f} s")
    return slide_dir


def preprocess_path(dev, root):
    """The preprocessing path through its three entry points, on
    ``PRE_SLIDES`` synthetic slides written as TIFF pyramids and read
    through ``open_slide``: ``create_patches`` (``rgb``; slide 0 also
    ``otsu`` and ``adaptive``, and ``rgb`` from its single-level file; host
    ms per phase), ``extract_features`` on the card three times (threads
    with the exact resize on the card, threads with ``--resize_on_device``,
    and the process decode pool; random weights, as without
    ``--weights``), each under torch.profiler for the device's idle share,
    with 64 patches' features held against the port's CPU f32 forward
    (relative error <= 1e-4: TF32 is off) and the card's resize held
    bitwise against the host's; the encoder alone timed over 4,096 patches in f32
    and bf16; ``features_clustering`` on the card, each slide's inertia
    within 1e-4 of the port's CPU k-means; then ``WSIWithCluster`` loads the
    output and MuRCL CLAM_SB stage 1 (feat_size 1024, bf16, ``--profile
    2``: the trace must name ``trunk_wg``) trains on it, launch counts reset
    first. Returns those launch counts."""
    import collections

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from murcl_tpu_torch import create_patches, extract_features, features_clustering
    from murcl_tpu_torch.data import contract
    from murcl_tpu_torch.data.datasets import WSIWithCluster
    from murcl_tpu_torch.drivers.murcl import run
    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.preprocess import extract, filters, tiling
    from murcl_tpu_torch.preprocess.kmeans import kmeans_torch
    from murcl_tpu_torch.preprocess.slide_io import open_slide
    from murcl_tpu_torch.utils.general import dump_json, load_json

    root = Path(root)
    slide_dir = write_pre_slides(root)

    ms = collections.defaultdict(float)

    def timed(key, fn):
        def wrapped(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                ms[key] += 1e3 * (time.perf_counter() - t)
        return wrapped

    def tiling_ms(n):
        mask = ms["mask"] - ms["downsample"]
        grid = ms["tiling"] - ms["mask"] - ms["json"]
        return (f"downsample {ms['downsample'] / n:.1f}, mask {mask / n:.1f}, grid "
                f"{grid / n:.1f}, json {ms['json'] / n:.1f} ms (host) per slide")

    saved = (filters.downsample_image, tiling.save_coord_json, tiling.tiling,
             dict(filters.MASK_ALGORITHMS))
    filters.downsample_image = timed("downsample", filters.downsample_image)
    filters.MASK_ALGORITHMS.update({k: timed("mask", f)
                                    for k, f in filters.MASK_ALGORITHMS.items()})
    tiling.save_coord_json = timed("json", tiling.save_coord_json)
    tiling.tiling = timed("tiling", tiling.tiling)
    try:
        create_patches.main(["--slide_dir", str(slide_dir), "--save_dir", str(root / "patches"),
                             "--magnification", str(PRE_MAG), "--patch_size", str(PRE_PATCH),
                             "--scale_factor", str(PRE_SCALE), "--method", "rgb",
                             "--device", str(dev)])
        coords = [load_json(root / "patches" / "coord" / f"wsi_{i}.json")
                  for i in range(PRE_SLIDES)]
        counts = [c["num_patches"] for c in coords]
        check(all(c["patch_size_level0"] == 2 * PRE_PATCH for c in coords)
              and min(counts) >= PRE_CHECK, f"tiling: {counts} patches")
        print(f"tiling rgb from the pyramids: {counts} patches of {2 * PRE_PATCH} px at level 0 "
              f"on {coords[0]['num_row']} x {coords[0]['num_col']} grids; "
              f"{tiling_ms(PRE_SLIDES)} ({card_line()})")
        ms.clear()
        (root / "single_coord").mkdir()
        out = tiling.tiling(str(root / "single" / "wsi_0.svs"), magnification=PRE_MAG,
                            patch_size=PRE_PATCH, scale_factor=PRE_SCALE, method="rgb",
                            coord_dir=root / "single_coord", filename="wsi_0", device=dev)
        check(out["num_patches"] > 0, "tiling the single-level file: no patch")
        print(f"tiling rgb (slide 0) from its single-level file: {out['num_patches']} patches "
              f"(pyramid: {counts[0]}); {tiling_ms(1)} ({card_line()})")
        for method in ("otsu", "adaptive"):
            ms.clear()
            (root / method).mkdir()
            out = tiling.tiling(str(slide_dir / "wsi_0.svs"), magnification=PRE_MAG,
                                patch_size=PRE_PATCH, scale_factor=PRE_SCALE, method=method,
                                coord_dir=root / method, filename="wsi_0", device=dev)
            check(out["num_patches"] > 0, f"tiling {method}: no patch")
            print(f"tiling {method} (slide 0): {out['num_patches']} patches; {tiling_ms(1)}")

        feats = {}
        for mode, extra in (("exact resize", []), ("device resize", ["--resize_on_device"]),
                            ("process pool", ["--decode_pool", "process"])):
            save = root / ("feat_" + mode.split()[0])
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                records = extract_features.main(
                    ["--patch_dir", str(root / "patches"), "--save_dir", str(save),
                     "--device", str(dev), "--batch_size", str(PRE_BATCH),
                     "--num_workers", "8", *extra])
                torch.cuda.synchronize()
                wall_ms = 1e3 * (time.perf_counter() - t)
            busy = profiling().busy_union_ms(profiling().device_events(prof))
            n = sum(r["num_patches"] for r in records)
            check(n == sum(counts), f"extract {mode}: {n} patches")
            feats[mode] = {i: np.load(save / "resnet18" / f"wsi_{i}.npz")["img_features"]
                           for i in range(PRE_SLIDES)}
            check(all(np.isfinite(f).all() and f.shape == (c, 512)
                      for f, c in zip(feats[mode].values(), counts)), f"extract {mode} output")
            print(f"extract ({mode}, {PRE_SLIDES} slides, first call included): {n} patches in "
                  f"{wall_ms:.1f} ms = {1e3 * n / wall_ms:.1f} patches/s; host read "
                  f"(crop) {sum(r['read_ms'] for r in records) / n:.3f} ms per patch on 8 "
                  f"{'processes' if mode == 'process pool' else 'threads'}; "
                  f"encode {sum(r['encode_ms'] for r in records):.1f} ms; device busy "
                  f"{busy:.1f} ms, idle share {1 - busy / wall_ms:.3f} (traced) ({card_line()})")
        for i in range(PRE_SLIDES):  # the same pixels through processes as through threads
            err = rel_err(torch.from_numpy(feats["process pool"][i]),
                          torch.from_numpy(feats["exact resize"][i]))
            check(err <= 1e-5, f"extract wsi_{i}: process pool against threads, rel err {err}")

        # the card's features against the port's CPU f32 forward on the same patches
        first = coords[0]["coords"][:PRE_CHECK]
        slide0 = open_slide(slide_dir / "wsi_0.svs", device=dev)
        t = time.perf_counter()
        one = extract._read_patches(slide0, first, 2 * PRE_PATCH, PRE_PATCH, 1)
        t_read = (time.perf_counter() - t) / PRE_CHECK
        crops = extract._read_patches(slide0, first, 2 * PRE_PATCH, PRE_PATCH, 1,
                                      resize_on_host=False).numpy()
        from murcl_tpu_torch.preprocess.resample import resize_u8, resize_u8_torch

        t = time.perf_counter()
        host = np.stack([resize_u8(c, (PRE_PATCH, PRE_PATCH)) for c in crops])
        t_resize = (time.perf_counter() - t) / PRE_CHECK
        check(one.shape == (PRE_CHECK, PRE_PATCH, PRE_PATCH, 3), "one-thread read")
        on_card = torch.from_numpy(crops).to(dev)
        card_ms = median_ms(lambda: resize_u8_torch(on_card, (PRE_PATCH, PRE_PATCH)))
        same = np.array_equal(resize_u8_torch(on_card, (PRE_PATCH, PRE_PATCH)).cpu().numpy(), host)
        check(same, "the card's exact resize against the host's")
        region = slide0.read_rgb((0, 0), (4096, 3072))
        small = resize_u8_torch(torch.from_numpy(region).to(dev)[None], (256, 192))[0]
        check(np.array_equal(small.cpu().numpy(), resize_u8(region, (256, 192))),
              "the card's downsample of a 4096 x 3072 region against the host's")
        print(f"host, one thread, {PRE_CHECK} patches of slide 0 freshly opened: read (tiles "
              f"inflated into the tile cache) + resize {1e3 * t_read:.3f} ms per patch; the "
              f"exact bicubic {2 * PRE_PATCH} -> {PRE_PATCH} resize alone "
              f"{1e3 * t_resize:.3f} ms per patch on the host, {card_ms:.3f} ms for the "
              f"{PRE_CHECK} on the card ({card_ms / PRE_CHECK:.4f} ms per patch), bit for bit "
              f"the same, and a 4096 x 3072 region downsampled 16 times on the card equal to "
              f"the host's; tile cache {slide0.cache.hits} hits, {slide0.cache.misses} misses "
              f"({card_line()})")
        for mode, on_device in (("exact resize", False), ("device resize", True)):
            patches = extract._read_patches(slide0, first, 2 * PRE_PATCH, PRE_PATCH, 8,
                                            resize_on_host=not on_device)
            cpu = extract.PatchEncoder("resnet18", batch_size=PRE_CHECK, patch_size=PRE_PATCH,
                                       resize_on_device=on_device,
                                       device="cpu").encode_patches(patches)
            got = torch.from_numpy(feats[mode][0][:PRE_CHECK])
            err = rel_err(got, torch.from_numpy(cpu))
            check(err <= 1e-4, f"extract {mode}: card against CPU, rel err {err}")
            print(f"extract ({mode}): {PRE_CHECK} patches' features on the card against the "
                  f"CPU f32 forward, rel err {err:.2e}, max abs "
                  f"{float((got - torch.from_numpy(cpu)).abs().max()):.2e}")
        a, b = (torch.from_numpy(feats[m][0]) for m in ("exact resize", "device resize"))
        print(f"exact (bicubic) against device (bilinear) resize: features rel diff "
              f"{rel_err(b, a):.3e}")

        # the encoder alone
        flops = encoder_flops("resnet18", PRE_PATCH)
        x = torch.randint(0, 256, (PRE_TIMED, PRE_PATCH, PRE_PATCH, 3), dtype=torch.uint8,
                          device=dev, generator=torch.Generator(device=dev).manual_seed(1))
        for dtype, peak in (("float32", F32_FLOPS), ("bfloat16", BF16_FLOPS)):
            enc = extract.PatchEncoder("resnet18", batch_size=PRE_BATCH, patch_size=PRE_PATCH,
                                       dtype=dtype, device=str(dev))

            def encode_all():
                with torch.no_grad(), extract.full_f32():
                    for s in range(0, PRE_TIMED, PRE_BATCH):
                        enc._encode(x[s:s + PRE_BATCH])

            bound_ms = PRE_TIMED * flops / peak * 1e3
            for autotune in (False, True):  # cuDNN's heuristics, then its autotuner
                saved_bench = torch.backends.cudnn.benchmark
                torch.backends.cudnn.benchmark = autotune
                try:
                    total = median_ms(encode_all, reps=3)
                finally:
                    torch.backends.cudnn.benchmark = saved_bench
                print(f"encoder resnet18 {dtype} ({'TF32 off' if dtype == 'float32' else 'bf16'}"
                      f", cudnn.benchmark {autotune}), {PRE_TIMED} patches of {PRE_PATCH}^2 at "
                      f"batch {PRE_BATCH}: {total:.1f} ms, "
                      f"{total / (PRE_TIMED // PRE_BATCH):.2f} ms per batch, "
                      f"{1e3 * PRE_TIMED / total:.0f} patches/s; bound {bound_ms:.1f} ms "
                      f"({flops / 1e9:.2f} GFLOP per patch at {peak / 1e12:.0f} TFLOP/s, "
                      f"{1e3 * PRE_TIMED / bound_ms:.0f} patches/s)")
            del enc
        del x
        torch.cuda.empty_cache()

        # k-means on the card, held against the port's CPU k-means
        feat_dir = root / "feat_exact" / "resnet18"
        records = features_clustering.main(["--feat_dir", str(feat_dir), "--num_clusters",
                                            str(K), "--device", str(dev)])
        check(len(records) == PRE_SLIDES, f"clustering: {records}")
        for i, rec in enumerate(records):
            f = feats["exact resize"][i]
            torch.cuda.synchronize()
            t = time.perf_counter()
            card = kmeans_torch(torch.from_numpy(f).to(dev), K)
            card_ms = 1e3 * (time.perf_counter() - t)
            cpu = kmeans_torch(torch.from_numpy(f), K)
            err = abs(card["inertia"] - cpu["inertia"]) / cpu["inertia"]
            check(err <= 1e-4, f"k-means {rec['case_id']}: inertia {card['inertia']} against "
                  f"CPU {cpu['inertia']}")
            with np.load(feat_dir / f"k-means-{K}" / f"{rec['case_id']}.npz") as z:
                labels = z["features_cluster_indices"][:, 0]
            check(np.array_equal(labels, card["labels"].cpu().numpy()),
                  f"k-means {rec['case_id']}: the CLI's labels")
            print(f"k-means {rec['case_id']} ({rec['num_features']} x 512, K {K}, n_init 10): "
                  f"CLI {rec['ms']:.1f} ms, again {card_ms:.1f} ms on the card, "
                  f"{card['iterations']} iterations (CPU {cpu['iterations']}), inertia "
                  f"{card['inertia']:.6g} against CPU {cpu['inertia']:.6g} (rel {err:.1e})")

        # MuRCL stage 1 on the features and clusters made here
        rows = [{"case_id": f"wsi_{i}", "features_filepath": str(feat_dir / f"wsi_{i}.npz"),
                 "label": i % 2,
                 "clusters_filepath": str(feat_dir / f"k-means-{K}" / f"wsi_{i}.npz"),
                 "clusters_json_filepath": str(feat_dir / f"k-means-{K}" / f"wsi_{i}.json")}
                for i in range(PRE_SLIDES)]
        csv = root / f"preprocessed_{K}.csv"
        contract.save_manifest(csv, rows)
        ids = [r["case_id"] for r in rows]
        dump_json({"train": ids, "valid": ids, "test": ids}, root / "split.json")
        ds = WSIWithCluster(csv)
        for i in range(len(ds)):
            f, clusters, _, case = ds[i]
            check(f.shape == (counts[i], 512) and len(clusters) == K
                  and sorted(j for c in clusters for j in c) == list(range(counts[i])),
                  f"WSIWithCluster {case}")
        args = murcl_args(dev, {"data_csv": str(csv), "data_split_json": str(root / "split.json")},
                          root / "murcl", "CLAM_SB", 1)
        args.batch_size, args.data_repeat, args.profile = PRE_SLIDES, 4, 2
        _cuda.reset_launch_counts()
        out = run(args)
        torch.cuda.synchronize()
        launches = dict(_cuda.LAUNCHES)
        check(math.isfinite(out["best_loss"]), f"MuRCL on preprocessed features: {out}")
        trace = Path(out["save_dir"]) / "profile" / "steps_1-2.pt.trace.json"
        check(trace.exists() and "trunk_wg" in trace.read_text(),
              f"--profile 2: no trace naming trunk_wg at {trace}")
        print(f"--profile 2: {trace.name} ({trace.stat().st_size / 2**20:.1f} MiB) names "
              "trunk_wg")
        used, unused = MURCL_KERNELS["CLAM_SB"][1]
        check(all(launches[k] > 0 for k in used) and all(launches[k] == 0 for k in unused),
              f"MuRCL on preprocessed features: launches {launches}")
        print(f"MuRCL CLAM_SB stage 1 on the preprocessed slides (batch {PRE_SLIDES}, "
              f"feat_size {N_MAIN}, bf16): loss {out['best_loss']:.6f}, launches {launches}")
    finally:
        (filters.downsample_image, tiling.save_coord_json, tiling.tiling, masks) = saved
        filters.MASK_ALGORITHMS.update(masks)
    return launches


def jpeg_slide_path(dev, root):
    """Slides as Aperio's and Camelyon16's scanners write them: JPEG-tiled
    pyramids whose tiles nvJPEG decodes on the card. ``PRE_JPEG_SLIDES``
    files of ``PRE_HW`` at 40x (downsamples ``PRE_LEVELS``), each level made
    of the four 256-pixel YCbCr 4:2:0 tiles of
    ``preprocess/fixtures/jpeg_tiles_256.npz`` with their JPEGTables split
    out; ``create_patches`` on them (``rgb``, host ms per slide); the cost
    of opening a decoder (``nvjpegCreateSimple``, once per slide opened)
    and of a thread's first and later decodes of one tile, and the tiles/s
    of one decoder on 1 and 8 threads; ``csrc/ycc_rgb.cu`` (libjpeg's
    upsampling and colour conversion on nvJPEG's planes) bitwise with its
    plain twin on a tile, both timed; then ``extract_features`` by 8
    threads under torch.profiler (patches/s, the host's read per patch, the
    device's idle share), which must launch that kernel. ``PRE_CHECK`` patches
    of slide 0 are held against PIL's decode of the same tiles (the
    fixture's): their pixels within ``FIXTURE_BOUND``, and their features
    on the card within 1e-2 relative (the pixels' differences, through the
    random encoder) and the CLI's within 1e-4 of those."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from murcl_tpu_torch import create_patches, extract_features
    from murcl_tpu_torch.data.synthetic import aperio_description, write_jpeg_fixture_tiff
    from murcl_tpu_torch.preprocess import extract
    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.preprocess.nvjpeg import (FIXTURE_256, FIXTURE_BOUND, NvJpegDecoder,
                                                   load_fixture, ycc_to_rgb, ycc_to_rgb_plain)
    from murcl_tpu_torch.preprocess.slide_io import ImageSlide, open_slide
    from murcl_tpu_torch.utils.general import load_json

    root = Path(root)
    slide_dir = root / "slides"
    slide_dir.mkdir(parents=True)
    h, w = PRE_HW
    t0 = time.time()
    mosaic = write_jpeg_fixture_tiff(slide_dir / "jpeg_0.svs", "ycbcr420", fixture=FIXTURE_256,
                                     size=(w, h), downsamples=PRE_LEVELS,
                                     description=aperio_description(w, h, 256, app_mag=40))
    for i in range(1, PRE_JPEG_SLIDES):
        shutil.copy(slide_dir / "jpeg_0.svs", slide_dir / f"jpeg_{i}.svs")
    size = (slide_dir / "jpeg_0.svs").stat().st_size / 2**20
    print(f"JPEG slides: {PRE_JPEG_SLIDES} of {w} x {h} at 40x, JPEG-tiled pyramids (YCbCr "
          f"4:2:0, JPEGTables, 256-pixel tiles, downsamples {PRE_LEVELS}, {size:.1f} MiB each), "
          f"written in {time.time() - t0:.1f} s")

    t = time.perf_counter()
    create_patches.main(["--slide_dir", str(slide_dir), "--save_dir", str(root / "patches"),
                         "--magnification", str(PRE_MAG), "--patch_size", str(PRE_PATCH),
                         "--scale_factor", str(PRE_SCALE), "--method", "rgb",
                         "--device", str(dev)])
    tiling_ms = 1e3 * (time.perf_counter() - t) / PRE_JPEG_SLIDES
    coords = [load_json(root / "patches" / "coord" / f"jpeg_{i}.json")
              for i in range(PRE_JPEG_SLIDES)]
    counts = [c["num_patches"] for c in coords]
    check(min(counts) >= PRE_CHECK, f"tiling the JPEG slides: {counts} patches")
    print(f"tiling rgb from the JPEG pyramids: {counts} patches; {tiling_ms:.1f} ms (host) per "
          f"slide, the 16x level's tiles decoded by nvJPEG ({card_line()})")

    fx = load_fixture(FIXTURE_256)["ycbcr420"]
    stream = fx["tables"][:-2] + fx["streams"][0][2:]
    opened, first, later = [], [], []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        dec = NvJpegDecoder(dev)
        opened.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        dec(stream, fx["photometric"])
        first.append(1e3 * (time.perf_counter() - t))
        t = time.perf_counter()
        for _ in range(20):
            dec(stream, fx["photometric"])
        later.append(1e3 * (time.perf_counter() - t) / 20)
        dec.close()
    rates = {}
    dec = NvJpegDecoder(dev)
    try:
        for threads in (1, 8):
            with ThreadPoolExecutor(threads) as pool:  # each thread's state made first
                list(pool.map(lambda _: dec(stream, fx["photometric"]), range(threads)))
                t = time.perf_counter()
                list(pool.map(lambda _: dec(stream, fx["photometric"]), range(400)))
                rates[threads] = 400 / (time.perf_counter() - t)
    finally:
        dec.close()
    print(f"nvJPEG decoder: opened in {statistics.median(opened):.2f} ms (median of 5; one per "
          f"slide opened), a thread's first 256 x 256 tile {statistics.median(first):.2f} ms "
          f"(its state and stream made), later tiles {statistics.median(later):.3f} ms each on "
          f"one thread ({len(stream)} bytes of JPEG); one decoder {rates[1]:.0f} tiles/s on 1 "
          f"thread, {rates[8]:.0f} on 8 ({card_line()})")
    gen = torch.Generator(device=dev).manual_seed(3)
    y = torch.randint(0, 256, (256, 256), generator=gen, device=dev, dtype=torch.uint8)
    cb, cr = (torch.randint(0, 256, (128, 128), generator=gen, device=dev, dtype=torch.uint8)
              for _ in range(2))
    check(torch.equal(ycc_to_rgb(y, cb, cr), ycc_to_rgb_plain(y, cb, cr)),
          "ycc_to_rgb kernel against its plain twin")
    k_ms = median_ms(lambda: ycc_to_rgb(y, cb, cr))
    plain_ms = median_ms(lambda: ycc_to_rgb_plain(y, cb, cr))
    print(f"ycc_to_rgb (csrc/ycc_rgb.cu) on a 256 x 256 4:2:0 tile: bitwise with its plain twin; "
          f"{k_ms:.4f} ms against {plain_ms:.4f} ms ({card_line()})")

    torch.cuda.synchronize()
    _cuda.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        records = extract_features.main(
            ["--patch_dir", str(root / "patches"), "--save_dir", str(root / "feat"),
             "--device", str(dev), "--batch_size", str(PRE_BATCH), "--num_workers", "8"])
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    busy = profiling().busy_union_ms(profiling().device_events(prof))
    n = sum(r["num_patches"] for r in records)
    ycc_launches = _cuda.LAUNCHES["ycc_to_rgb"]
    check(n == sum(counts) and ycc_launches > 0,
          f"extract (JPEG): {n} patches, ycc_to_rgb launched {ycc_launches} times")
    feats = np.load(root / "feat" / "resnet18" / "jpeg_0.npz")["img_features"]
    check(np.isfinite(feats).all() and feats.shape == (counts[0], 512), "extract (JPEG) output")
    print(f"extract (JPEG pyramids, exact resize, {PRE_JPEG_SLIDES} slides, first call "
          f"included): {n} patches in {wall_ms:.1f} ms = {1e3 * n / wall_ms:.1f} patches/s; host "
          f"read (crop, tiles decoded by nvJPEG) {sum(r['read_ms'] for r in records) / n:.3f} "
          f"ms per patch on 8 threads; encode {sum(r['encode_ms'] for r in records):.1f} ms; "
          f"device busy {busy:.1f} ms, idle share {1 - busy / wall_ms:.3f} (traced); "
          f"ycc_to_rgb launched {ycc_launches} times ({card_line()})")

    # against PIL's decode of the same tiles
    near = coords[0]["coords"][:PRE_CHECK]
    slide = open_slide(slide_dir / "jpeg_0.svs", device=dev)
    got = extract._read_patches(slide, near, 2 * PRE_PATCH, PRE_PATCH, 8,
                                resize_on_host=False).numpy()
    slide.close()
    want = extract._read_patches(ImageSlide("pil.png", image=mosaic), near, 2 * PRE_PATCH,
                                 PRE_PATCH, 8, resize_on_host=False).numpy()
    d = np.abs(got.astype(int) - want)
    top, mean = FIXTURE_BOUND["ycbcr420"]
    check(d.max() <= top and d.mean() <= mean,
          f"JPEG slide on the card against PIL: max {d.max()}, mean {d.mean():.4f}")
    enc = extract.PatchEncoder("resnet18", batch_size=PRE_CHECK, patch_size=PRE_PATCH,
                               device=str(dev))
    a, b = (torch.from_numpy(enc.encode_patches(x)) for x in (got, want))
    err, cli = rel_err(a, b), rel_err(torch.from_numpy(feats[:PRE_CHECK]), a)
    check(err <= 1e-2 and cli <= 1e-4,
          f"JPEG slide features: nvJPEG against PIL rel err {err}, CLI against the same "
          f"pixels {cli}")
    print(f"JPEG slide 0, {PRE_CHECK} patches on the card against PIL's decode of the same "
          f"tiles: pixels max {d.max()}, mean {d.mean():.4f} (bound {top}, {mean}); features "
          f"rel err {err:.2e}; the CLI's features against these pixels' {cli:.2e}")


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

    extra.setdefault("compute_dtype", "bfloat16")
    return default_args(data_csv=ds["data_csv"], data_split_json=ds["data_split_json"],
                        device=str(dev), train_stage=stage, arch=arch, batch_size=BATCH,
                        feat_size=N_MAIN, T=T,
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


def murcl_cli_path(dev, ds, results):
    """MuRCL CLAM_SB stages 1 -> 2 -> 3 through the CLI (``train_MuRCL.main``)
    with the runbook's pretraining flags (``murcl_tpu_torch/scripts/
    run_camelyon.sh``, step 5) and no ``--compute_dtype``: the default,
    float32, so K2/K3 take their f32 route; the bench.py shape, 2 steps in
    stage 1 (``--data_repeat 4``) and 1 in stages 2 and 3, one PPO epoch. Per
    stage a finite loss, float32 in args.json and the kernels of
    ``MURCL_KERNELS``. Returns the launch counts per stage."""
    import torch

    from murcl_tpu_torch import train_MuRCL
    from murcl_tpu_torch.ops import _cuda

    per_stage = {}
    for stage in (1, 2, 3):
        argv = ["--dataset", "Camelyon16", "--data_csv", ds["data_csv"], "--data_split_json",
                ds["data_split_json"], "--feat_size", str(N_MAIN), "--preload", "--train_stage",
                str(stage), "--T", str(T), "--scheduler", "CosineAnnealingLR", "--batch_size",
                str(BATCH), "--epochs", "1", "--ppo_epochs", "1",
                "--data_repeat", "4" if stage == 1 else "2", "--patience", "10", "--arch",
                "CLAM_SB", "--device", str(dev.index), "--base_save_dir", str(results),
                "--seed", "985", "--exist_ok", "--resume"]
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = train_MuRCL.main(argv)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        per_stage[stage] = launches
        run_dir = Path(out["save_dir"])
        what = f"MuRCL CLI CLAM_SB stage {stage}, default dtype"
        check(math.isfinite(out["best_loss"]), f"{what}: loss {out['best_loss']}")
        dtype = json.loads((run_dir / "args.json").read_text())["compute_dtype"]
        check(dtype == "float32", f"{what}: compute_dtype {dtype}")
        used, unused = MURCL_KERNELS["CLAM_SB"][stage]
        check(all(launches[k] > 0 for k in used) and all(launches[k] == 0 for k in unused),
              f"{what}: launches {launches}")
        print(f"{what} ({dtype}): loss {out['best_loss']:.6f}, {out['steps_per_sec']:.4f} "
              f"steps/s over the epoch (first step included), main() wall {wall:.2f} s, "
              f"launches {launches}")
    return per_stage


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


def twin_step(what, grads, kernels):
    """Run ``grads()`` (``(step losses, {name: gradient})``) through the
    kernels, which must launch each of ``kernels``, then through their plain
    twins, which launch nothing. Step losses must agree within 1e-4
    absolute and every gradient within a Frobenius error of 2e-2 relative to
    the larger of its norm and 1e-4 of the largest gradient's norm (the
    floor holds the gradients that cancel: the score bias's is zero in exact
    arithmetic, as softmax ignores a shift). Returns ``(loss_err, {name: rel
    err}, kernels' gradients)``."""
    from murcl_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    k_loss, k_grads = grads()
    check(all(_cuda.LAUNCHES[k] > 0 for k in kernels), f"{what}, kernels: {_cuda.LAUNCHES}")
    _cuda.reset_launch_counts()
    with plain_twins():
        p_loss, p_grads = grads()
    check(not any(_cuda.LAUNCHES.values()), f"{what}, plain: launched {_cuda.LAUNCHES}")
    loss_err = float((k_loss - p_loss).abs().max())
    check(k_grads.keys() == p_grads.keys() and len(k_grads) >= 10,
          f"{what}: gradients of {sorted(k_grads)} against {sorted(p_grads)}")
    floor = 1e-4 * max(float(g.norm()) for g in p_grads.values())
    rels = {k: float((k_grads[k].double() - p_grads[k].double()).norm()
                     / max(float(p_grads[k].norm()), floor)) for k in k_grads}
    worst = max(rels, key=rels.get)
    print(f"{what}, kernels against plain twins: step losses "
          f"{[round(float(v), 6) for v in k_loss]} (max abs diff {loss_err:.2e}); "
          f"{len(rels)} gradients, worst rel err {rels[worst]:.2e} ({worst}), "
          f"norms {min(float(g.norm()) for g in k_grads.values()):.3e} to "
          f"{max(float(g.norm()) for g in k_grads.values()):.3e}")
    check(loss_err <= 1e-4, f"{what}: step losses {k_loss} against plain {p_loss}")
    check(rels[worst] <= 2e-2, f"{what}: gradients against plain: {rels}")
    return loss_err, rels, k_grads


def check_step_moves(what, train_step, named, grads) -> None:
    """One optimizer step must move every weight that has a gradient."""
    import torch

    before = {k: v.detach().clone() for k, v in named}
    train_step()
    still = [k for k in grads if torch.equal(before[k], dict(named)[k])]
    check(not still, f"{what} left {still} unchanged")


def abmil_step_check(dev, ds, results):
    """One ABMIL stage-1 step at the bench.py shape through the kernels, then
    through their plain twins on the card, from the same weights and draws
    (``twin_step``); then one optimizer step must move every weight that has
    a gradient. Prints the embeddings' spread across bags (norm of the std
    over bags / norm of the mean)."""
    import torch

    from murcl_tpu_torch.drivers.murcl import setup

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
        total, stats = eng.rollout_batched(s.source.bank, ids,
                                           torch.Generator().manual_seed(0))
        total.backward()
        torch.cuda.synchronize()
        return stats.step_losses.clone(), {k: v.grad.clone() for k, v in named
                                           if v.grad is not None}

    loss_err, rels, k_grads = twin_step(
        "ABMIL stage-1 step", grads, ("compact", "mixup_rows", "attention_pool_fwd",
                                      "attention_pool_bwd", "ntxent_fwd", "ntxent_bwd"))
    hook.remove()
    emb_k, emb_p = embs[0].float(), embs[1].float()
    spread = float(emb_k.std(dim=0).norm() / emb_k.mean(dim=0).norm())
    print(f"ABMIL stage-1 step: embedding rel err {rel_err(emb_k, emb_p):.2e}, spread across "
          f"bags {spread:.3e}")
    check_step_moves("ABMIL stage-1 step",
                     lambda: eng.train_step(s.source.bank, ids,
                                           torch.Generator().manual_seed(0)),
                     named, k_grads)
    del s, eng, k_grads
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_rel_err": max(rels.values()), "spread": spread}


def supervised_step_check(dev, ds, results, pretrained):
    """One supervised ABMIL stage-1 step at batch 64 (finetune from the ABMIL
    MuRCL checkpoint) through the kernels (K1, K7f, K7b), then through their
    plain twins, from the same weights and draws (``twin_step``); then one
    optimizer step must move every weight that has a gradient."""
    import torch

    from murcl_tpu_torch.drivers.rlmil import setup

    s = setup(rlmil_args(dev, ds, results, 1, pretrained, arch="ABMIL", exist_ok=True))
    eng, bank = s.engine, s.sources["train"].bank
    named = ([(f"model.{k}", v) for k, v in eng.model.named_parameters()]
             + [(f"fc.{k}", v) for k, v in eng.fc.named_parameters()])
    ids = torch.arange(RL_BATCH, device=dev)
    labels, valid = bank.labels[ids], torch.ones(RL_BATCH, dtype=torch.bool, device=dev)

    def grads():
        eng.model.train()
        eng.fc.train()
        eng.optimizer.zero_grad(set_to_none=True)
        total, stats, _ = eng.rollout_batched(bank, ids, labels, valid,
                                              torch.Generator().manual_seed(0))
        total.backward()
        torch.cuda.synchronize()
        return stats.step_losses.clone(), {k: v.grad.clone() for k, v in named
                                           if v.grad is not None}

    loss_err, rels, k_grads = twin_step(
        "supervised ABMIL stage-1 step", grads,
        ("compact", "attention_pool_fwd", "attention_pool_bwd"))
    check_step_moves("supervised ABMIL stage-1 step",
                     lambda: eng.train_step(bank, ids, torch.Generator().manual_seed(0)),
                     named, k_grads)
    del s, eng, k_grads
    torch.cuda.empty_cache()
    return {"loss_err": loss_err, "grad_rel_err": max(rels.values())}


# the PPO learning check's runs, with the same seeds: route, compute dtype
# and widths (dim, L, D): ABMIL's, and the JAX script's (K7 zero-padded to
# multiples of 128)
PPO_ABMIL, PPO_JAX = (512, 512, 128), (32, 32, 8)
PPO_RUNS = {"a": ("kernels", "float32", PPO_ABMIL), "b": ("kernels", "float32", PPO_ABMIL),
            "c": ("plain twins", "float32", PPO_ABMIL), "d": ("kernels", "bfloat16", PPO_ABMIL),
            "e": ("kernels", "float32", PPO_JAX), "f": ("plain twins", "float32", PPO_JAX)}
# the pairs of runs compared: the second of each is the plain twins' or, (a)
# and (b), two kernel runs
PPO_PAIRS = (("a", "b"), ("a", "c"), ("b", "c"), ("d", "c"), ("e", "f"))
PPO_KERNELS = ("compact", "attention_pool_fwd", "attention_pool_bwd")


def ppo_run_diffs(x, y) -> dict:
    """Largest differences of two ``ppo_sanity`` runs: per-epoch rewards,
    mean actions, the two confidences, the first stage-1 loss and the first
    stage-1 step whose losses differ by over 1e-3 (None if none), and the
    largest relative Frobenius difference of a final weight (aggregator,
    head, policy) with its name."""
    rel = {k: float((x.weights[k].double() - y.weights[k].double()).norm()
                    / y.weights[k].double().norm().clamp_min(1e-30)) for k in x.weights}
    worst = max(rel, key=rel.get)
    apart = [i for i, (u, v) in enumerate(zip(x.stage1_losses, y.stage1_losses))
             if abs(u - v) > 1e-3]
    return {"rewards": max(abs(u - v) for u, v in zip(x.rewards, y.rewards)),
            "actions": max(abs(u - v) for u, v in zip(x.actions, y.actions)),
            "confidence_random": abs(x.conf_random - y.conf_random),
            "confidence_policy": abs(x.conf_policy - y.conf_policy),
            "stage1_first_loss": abs(x.stage1_losses[0] - y.stage1_losses[0]),
            "stage1_apart_from_step": apart[0] if apart else None,
            "weights_rel": rel[worst], "weights_rel_at": worst}


def ppo_sanity_path(dev):
    """The PPO learning check (``murcl_tpu_torch/scripts/ppo_sanity.py``)
    six times with the same seeds (``PPO_RUNS``): at ABMIL's widths (dim
    512, L 512, D 128), (a) and (b) through the kernels in f32, (c) through
    their plain twins in f32, (d) through the kernels in bf16; at the JAX
    script's widths (32, 32, 8), (e) through the kernels in f32 and (f)
    through the plain twins in f32. The draws are on the host's generators,
    so K1 and the draws are the same in every run of a width; what
    separates (a) from (b) is K7b's split-K atomics. Prints each run's
    report line, wall time and directions, and the differences of
    ``PPO_PAIRS`` (``ppo_run_diffs``).

    Holds in every run: finite readings and weights, the path's kernels
    (K1, K7f, K7b) launched by the kernel runs and nothing launched by the
    plain twins' runs, stage 1's last ten losses below half its first ten,
    and both confidences above 0.75 (chance is 0.5); the first stage-1 loss
    (the same weights and draws, before any update) of each f32 kernel run
    within 1e-4 of the plain twins' at its widths, of (d) within 2e-2. The
    three PPO directions are printed, not held, as the JAX script holds
    none: at ABMIL's widths stage 1 alone reaches a confidence of
    0.93-0.998 with random windows, and on the plain path on the CPU the
    thread count alone decides which directions hold (PERF.md, section 6).
    Returns the kernel runs' launch counts."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.scripts import ppo_sanity as ps

    card = card_line()
    runs, launches = {}, []
    for key, (route, dtype, (dim, L, D)) in PPO_RUNS.items():
        _cuda.reset_launch_counts()
        t0 = time.time()
        with plain_twins() if route == "plain twins" else contextlib.nullcontext():
            s = ps.run(dev, dim=dim, L=L, D=D, compute_dtype=dtype)
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        report = s.report()
        runs[key] = s
        print(f"ppo_sanity ({key}) {route}, {dtype}, (dim, L, D) = {(dim, L, D)}: {wall:.2f} s, "
              f"launches {counts}, directions {ps.directions(report)} ({card})")
        print(f"ppo_sanity ({key}) report: {json.dumps(report)}")
        if route == "kernels":
            check(set(counts) == set(PPO_KERNELS), f"ppo_sanity ({key}): launches {counts}")
            launches.append(dict(_cuda.LAUNCHES))
        else:
            check(not counts, f"ppo_sanity ({key}): the plain twins launched {counts}")
        values = [*s.stage1_losses, *s.rewards, *s.actions, s.conf_random, s.conf_policy]
        check(all(math.isfinite(v) for v in values)
              and all(bool(w.isfinite().all()) for w in s.weights.values()),
              f"ppo_sanity ({key}): readings or weights not finite")
        l1 = s.stage1_losses
        check(statistics.mean(l1[-10:]) < 0.5 * statistics.mean(l1[:10]),
              f"ppo_sanity ({key}): stage 1 did not learn: losses {l1[:10]} ... {l1[-10:]}")
        check(min(s.conf_random, s.conf_policy) > 0.75,
              f"ppo_sanity ({key}): confidences {s.conf_random}, {s.conf_policy}")
    for x, y in PPO_PAIRS:
        diff = ppo_run_diffs(runs[x], runs[y])
        print(f"ppo_sanity ({x}) - ({y}): {json.dumps(diff)} ({card})")
        tol = 2e-2 if PPO_RUNS[x][1] == "bfloat16" else 1e-4
        if PPO_RUNS[y][0] == "plain twins":
            check(diff["stage1_first_loss"] <= tol,
                  f"ppo_sanity ({x}): first stage-1 loss {runs[x].stage1_losses[0]} against the "
                  f"plain twins' {runs[y].stage1_losses[0]}")
            same = ps.directions(runs[x].report()) == ps.directions(runs[y].report())
            print(f"ppo_sanity ({x}): directions {'the same as' if same else 'other than'} the "
                  f"plain twins' ({y})")
    del runs
    torch.cuda.empty_cache()
    return launches


def make_slides(root):
    """The heatmap path's data: one feature npz per slide (dim 512, f32) in
    the data contract, a manifest, coord JSONs as the tiling step writes
    them, and each slide as a single-level deflate TIFF file that
    ``open_slide`` reads."""
    import numpy as np

    from murcl_tpu_torch.data import contract
    from murcl_tpu_torch.data.synthetic import write_tiff
    from murcl_tpu_torch.utils.general import dump_json

    cols, rows = HEAT_GRID
    rng = np.random.default_rng(11)
    root = Path(root)
    (root / "features").mkdir(parents=True)
    (root / "coords").mkdir()
    manifest = []
    for n in HEAT_SLIDES:
        case_id = f"slide_{n}"
        cells = np.sort(rng.choice(cols * rows, size=n, replace=False))
        grid = np.stack([cells // cols, cells % cols], axis=1)
        feat_path = root / "features" / f"{case_id}.npz"
        contract.save_features_npz(feat_path, case_id, rows, cols,
                                   rng.standard_normal((n, FIN), dtype=np.float32), grid)
        slide_path = str(root / f"{case_id}.svs")
        write_tiff(slide_path, [rng.integers(0, 256, (rows * HEAT_PATCH, cols * HEAT_PATCH, 3),
                                             dtype=np.uint8)], tile=256)
        dump_json({"slide_filepath": slide_path, "magnification": 20,
                   "magnification_level0": 20, "num_row": rows, "num_col": cols,
                   "patch_size": 224, "patch_size_level0": HEAT_PATCH, "num_patches": n,
                   "coords": [{"row": int(r), "col": int(c), "x": int(c) * HEAT_PATCH,
                               "y": int(r) * HEAT_PATCH} for r, c in grid]},
                  root / "coords" / f"{case_id}.json")
        manifest.append({"case_id": case_id, "features_filepath": str(feat_path), "label": 0})
    contract.save_manifest(root / "slides.csv", manifest)


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
    make_slides(root)
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
    saved = hm.AttentionScorer
    hm.AttentionScorer = TimedScorer
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
        hm.AttentionScorer = saved
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


def rlmil_args(dev, ds, results, stage, pretrained, arch="CLAM_SB", **extra):
    """Supervised args: finetune from ``pretrained``, or scratch without one;
    bf16 unless ``compute_dtype`` says otherwise."""
    from murcl_tpu_torch.drivers.rlmil import default_args

    extra.setdefault("compute_dtype", "bfloat16")
    return default_args(data_csv=ds["data_csv"], data_split_json=ds["rlmil_split_json"],
                        device=str(dev), arch=arch,
                        train_method="finetune" if pretrained else "scratch",
                        train_stage=stage,
                        checkpoint_pretrained=pretrained if stage < 3 else None,
                        batch_size=RL_BATCH, feat_size=N_MAIN, T=T, epochs=1, ppo_epochs=1, save_model=True,
                        base_save_dir=str(results), **extra)


# per arch, the kernels each supervised stage launches: in every stage, in
# stages 1 and 3 only (never in stage 2), and never
RLMIL_KERNELS = {
    "CLAM_SB": (("compact", "attention_pool_fwd"), ("attention_pool_bwd",), ()),
    "ABMIL": (("compact", "attention_pool_fwd"), ("attention_pool_bwd",),
              ("fused_trunk_fwd", "fused_trunk_bwd", "mixup_rows")),
    "DSMIL": (("compact",), (), ("attention_pool_fwd", "attention_pool_bwd",
                                 "fused_trunk_fwd", "fused_trunk_bwd", "mixup_rows")),
}


def rlmil_path(dev, ds, results, pretrained, arch="CLAM_SB"):
    """Supervised stages 1 -> 2 -> 3 of ``arch``; per stage the launch counts."""
    import torch

    from murcl_tpu_torch.drivers.rlmil import run
    from murcl_tpu_torch.ops import _cuda

    every, trained, never = RLMIL_KERNELS[arch]
    per_stage = {}
    for stage in (1, 2, 3):
        args = rlmil_args(dev, ds, results, stage, pretrained, arch=arch)
        what = f"RLMIL {arch} {args.train_method} stage {stage}"
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = run(args)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = dict(_cuda.LAUNCHES)
        per_stage[stage] = launches
        run_dir = Path(out["save_dir"])
        check(run_dir.name == f"stage_{stage}", f"{what} ran in {run_dir}")
        check(all(math.isfinite(v) for v in out["final"] + tuple(out["train_losses"])),
              f"{what}: {out['final']} {out['train_losses']}")
        for name in ("checkpoint.pth.tar", "model_best.pth.tar", "pred.csv", "final_res.csv"):
            check((run_dir / name).exists(), f"{what}: no {name}")
        ckpt = torch.load(run_dir / "checkpoint.pth.tar", map_location="cpu", weights_only=True)
        check((ckpt["policy"] is not None) == (stage > 1), f"{what}: policy entry")
        check(all(launches[k] > 0 for k in every)
              and all((launches[k] > 0) == (stage != 2) for k in trained)
              and all(launches[k] == 0 for k in never), f"{what}: launches {launches}")
        print(f"{what}: train loss {out['train_losses'][0]:.6f}, final test "
              f"(loss, acc, auc, precision, recall, f1) {out['final']}, "
              f"{out['steps_per_sec']:.4f} steps/s over the epoch (first step included), "
              f"run() wall {wall:.2f} s, launches {launches}")
    return per_stage


def rlmil_cli_path(dev, ds, results, pretrained):
    """Supervised CLAM_SB stage 1 through the CLI (``train_RLMIL.main``) with
    the runbook's fine-tuning flags (``murcl_tpu_torch/scripts/
    run_camelyon.sh``, step 6) and no ``--compute_dtype``: the default,
    float32, so K7 takes its f32 route; batch 64 (the runbook's batch of 1
    would take 128 steps an epoch), one epoch of 2 steps, from the CLAM_SB
    MuRCL stage-3 ``model_best``. A finite loss, float32 in args.json, and
    the kernels of ``RLMIL_KERNELS`` (K1 and K7f, K7b in stage 1). Returns
    the launch counts."""
    import torch

    from murcl_tpu_torch import train_RLMIL
    from murcl_tpu_torch.ops import _cuda

    argv = ["--dataset", "Camelyon16", "--data_csv", ds["data_csv"], "--data_split_json",
            ds["rlmil_split_json"], "--train_data", "train", "--feat_size", str(N_MAIN),
            "--preload", "--train_method", "finetune", "--train_stage", "1",
            "--checkpoint_pretrained", str(pretrained), "--T", str(T), "--scheduler",
            "CosineAnnealingLR", "--batch_size", str(RL_BATCH), "--epochs", "1",
            "--backbone_lr", "0.0001", "--fc_lr", "0.00005", "--arch", "CLAM_SB", "--device",
            str(dev.index), "--base_save_dir", str(results), "--seed", "985", "--save_model",
            "--exist_ok", "--resume"]
    _cuda.reset_launch_counts()
    t0 = time.time()
    out = train_RLMIL.main(argv)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(_cuda.LAUNCHES)
    run_dir = Path(out["save_dir"])
    what = "RLMIL CLI CLAM_SB finetune stage 1, default dtype"
    check(all(math.isfinite(v) for v in out["final"] + tuple(out["train_losses"])),
          f"{what}: {out['final']} {out['train_losses']}")
    dtype = json.loads((run_dir / "args.json").read_text())["compute_dtype"]
    check(dtype == "float32", f"{what}: compute_dtype {dtype}")
    every, trained, never = RLMIL_KERNELS["CLAM_SB"]
    check(all(launches[k] > 0 for k in every + trained)
          and all(launches[k] == 0 for k in never), f"{what}: launches {launches}")
    print(f"{what} ({dtype}): train loss {out['train_losses'][0]:.6f}, final test "
          f"{out['final']}, {out['steps_per_sec']:.4f} steps/s over the epoch (first step "
          f"included), main() wall {wall:.2f} s, launches {launches}")
    return launches


def timed_step(step) -> tuple:
    """``(ms, enqueue ms, peak GiB)`` of a steady step: 2 warm-up steps, then
    the medians over 5 synchronised steps of the step and of the host's
    enqueue (when the step call returns), and the peak device memory."""
    import torch

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times, host = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        host.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return (statistics.median(times), statistics.median(host),
            torch.cuda.max_memory_allocated() / 2**30)


def steady_steps(dev, ds, results, runs):
    """Steady supervised steps at batch 64, one per ``(arch, stage,
    pretrained, compute dtype)`` of ``runs`` (a stage 3 chains on its path's
    stage 2): 2 warm-up steps, a host clock around 5 synchronised steps,
    then a torch.profiler trace of 3 more. Returns ``{name: ms per step}``."""
    import torch

    from murcl_tpu_torch.drivers.rlmil import setup

    out = {}
    for arch, stage, pretrained, dtype in runs:
        s = setup(rlmil_args(dev, ds, results, stage, pretrained, arch=arch, exist_ok=True,
                             compute_dtype=dtype))
        bank = s.sources["train"].bank
        gen = torch.Generator().manual_seed(0)
        ids = torch.arange(RL_BATCH, device=dev)

        def step():
            s.engine.train_step(bank, ids, gen)

        name = f"supervised {arch} stage {stage}" + (" f32" if dtype == "float32" else "")
        out[name], enqueue, peak = timed_step(step)
        print(f"{name}, batch {RL_BATCH}: median step {out[name]:.2f} ms "
              f"({1e3 / out[name]:.3f} steps/s), host enqueue {enqueue:.2f} ms, "
              f"peak device memory {peak:.2f} GiB")
        profiling().profile_steps(step, name, out[name])
        del s
        torch.cuda.empty_cache()
    return out


def steady_murcl_steps(dev, ds, results):
    """Steady MuRCL steps at batch 128: CLAM_SB stage 1 (the ``bench.py``
    step), ABMIL stage 1, then CLAM_SB stage 3 (which chains on the CLAM_SB
    path's stage 2), in bf16; then CLAM_SB stages 1 and 3 and ABMIL stage 1
    in float32, the CLIs' and the runbook's default. Returns ``{name:
    ms}``."""
    import torch

    from murcl_tpu_torch.drivers.murcl import setup

    out = {}
    for arch, stage, dtype in (("CLAM_SB", 1, "bfloat16"), ("ABMIL", 1, "bfloat16"),
                               ("CLAM_SB", 3, "bfloat16"), ("CLAM_SB", 1, "float32"),
                               ("CLAM_SB", 3, "float32"), ("ABMIL", 1, "float32")):
        s = setup(murcl_args(dev, ds, results, arch, stage, exist_ok=True, compute_dtype=dtype))
        gen = torch.Generator().manual_seed(0)
        ids = torch.arange(BATCH, device=dev) % SLIDES

        def step():
            s.engine.train_step(s.source.bank, ids, gen)

        name = f"MuRCL {arch} stage {stage}" + (" f32" if dtype == "float32" else "")
        out[name], enqueue, peak = timed_step(step)
        print(f"{name}, batch {BATCH}: median step {out[name]:.2f} ms "
              f"({1e3 / out[name]:.3f} steps/s), host enqueue {enqueue:.2f} ms, "
              f"peak device memory {peak:.2f} GiB")
        profiling().profile_steps(step, name, out[name])
        del s
        torch.cuda.empty_cache()
    return out


# The step diagnostics (``step_diagnostics_path``): the ports of the JAX
# package's scripts/profile_step.py, profile_stages.py (stages 2 and 3),
# dbg_step.py and scale_smoke.py at their JAX shapes, and the kernels each
# run launches (every other count of LAUNCHES stays 0): stage 1 K1, K2, K3
# and K4; stage 2 no backward; dbg_step also K6 (its selection and mixup
# piece); scale_smoke's supervised CLAM_SB steps K1 and K7, and its
# 10,000-patch slide K8 (20 MiB of f32 rows, past the 6 MiB route rule)
STAGE13 = ("compact", "fused_trunk_fwd", "fused_trunk_bwd", "ntxent_fwd", "ntxent_bwd")
STEP_DIAG_KERNELS = {
    "profile_step": STAGE13,
    "profile_stages 2": ("compact", "fused_trunk_fwd", "ntxent_fwd"),
    "profile_stages 3": STAGE13,
    "dbg_step": STAGE13 + ("mixup_rows",),
    "scale_smoke": ("compact", "attention_pool_fwd", "attention_pool_bwd",
                    "attention_pool_tiled"),
}
# the hand-written kernels each profile table must name among its rows
STEP_DIAG_ROWS = {
    "profile_step": ("compact_kernel", "trunk_wg", "gates_fwd_wg", "gates_bwd_wg", "dx_wg",
                     "wgrad_wg", "ntxent_fwd_kernel", "ntxent_bwd_kernel"),
    "profile_stages 2": ("compact_kernel", "trunk_wg", "gates_fwd_wg", "ntxent_fwd_kernel"),
    "profile_stages 3": ("compact_kernel", "trunk_wg", "gates_fwd_wg", "gates_bwd_wg", "dx_wg",
                         "wgrad_wg", "ntxent_fwd_kernel", "ntxent_bwd_kernel"),
}


def step_diagnostics_path(dev, root):
    """The four step scripts' ``run()`` on ``dev`` at their JAX shapes:
    ``profile_step``, ``profile_stages`` at stages 2 and 3, ``dbg_step`` and
    ``scale_smoke`` (its slides under ``root``), every launch count 0 before
    a script and read after it, failing unless the launched kernels are
    ``STEP_DIAG_KERNELS``' of the script; every loss and score finite, the
    profile tables naming ``STEP_DIAG_ROWS``' kernels, and dbg_step's
    forward-only rollout faster than its full step. Prints the phase's wall
    time; returns ``(launch counts per script, {script: numbers})``."""
    import torch

    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.scripts import dbg_step, profile_stages, profile_step, scale_smoke

    t_phase = time.time()
    counts, res = [], {}

    def counted(name, fn):
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = fn()
        used = {k: v for k, v in _cuda.LAUNCHES.items() if v}
        print(f"{name}: {time.time() - t0:.1f} s, launches {used}", flush=True)
        check(set(used) == set(STEP_DIAG_KERNELS[name]),
              f"{name}: launched {sorted(used)}, expected {sorted(STEP_DIAG_KERNELS[name])}")
        counts.append(dict(_cuda.LAUNCHES))
        res[name] = out
        torch.cuda.empty_cache()
        return out

    def profiled(name, out):
        check(all(math.isfinite(x) for x in out["losses"]), f"{name}: losses {out['losses']}")
        check(out["on_device"], f"{name}: the trace recorded no device event")
        ops = " ".join(r["op"] for r in out["rows"])
        missing = [k for k in STEP_DIAG_ROWS[name] if k not in ops]
        check(not missing, f"{name}: the table names none of {missing}")
        del out["prof"]

    profiled("profile_step", counted("profile_step", lambda: profile_step.run(
        dev, out=root / "profile_step.trace.json")))
    for stage in (2, 3):
        name = f"profile_stages {stage}"
        profiled(name, counted(name, lambda: profile_stages.run(
            dev, stage=stage, out=root / f"profile_stage{stage}.trace.json")))
    outs = {}
    dbg = counted("dbg_step", lambda: dbg_step.run(dev, outs=outs))
    check(all(math.isfinite(x) for x in outs["losses"].values()), f"dbg_step: {outs['losses']}")
    check(dbg["fwd"] < dbg["full"], f"dbg_step: forward-only {dbg['fwd']} ms, not below the "
          f"full step's {dbg['full']}")
    del outs
    scale = counted("scale_smoke", lambda: scale_smoke.run(dev, root=root / "scale"))
    check(all(math.isfinite(x) for x in scale["losses"]) and scale["attention_finite"],
          f"scale_smoke: losses {scale['losses']}, scores finite {scale['attention_finite']}")
    print(f"step diagnostics phase in {time.time() - t_phase:.1f} s ({card_line()})")
    return counts, res


# The A/B against the parent commit: its tree unpacked under build/parent
# (``git archive <parent> | tar -x -C build/parent``; absent from a checkout,
# so the A/B is skipped there), whose package and kernels each side process
# imports and builds from that tree
PARENT_TREE = REPO / "build" / "parent"


# K7's timed calls in the A/B: the supervised stage-1 shape (gated, D 256,
# dropout 0.25) and ABMIL's mode (ungated, D 128, dropout 0), in bf16 and in
# f32 (the supervised CLIs' default)
AB_POOL = {"sup": (POOL_BAGS, D, True, 0.25, "bf16"),
           "abmil": (B_MAIN, ABMIL_D, False, 0.0, "bf16"),
           "sup_f32": (POOL_BAGS, D, True, 0.25, "f32"),
           "abmil_f32": (B_MAIN, ABMIL_D, False, 0.0, "f32")}
# K8's timed calls in the A/B: (rows of the one bag, dtype), gated, a masked tail
AB_K8 = {"k8_f32": (K8_MAIN[1], "f32"), "k8_f32_12288": (K8_CHECK[1], "f32"),
         "k8_bf16": (K8_MAIN[1], "bf16"), "k8_bf16_12288": (K8_CHECK[1], "bf16")}
# the steady steps of the A/B: (package module, arch, stage, compute dtype)
AB_STEPS = {"supervised": ("rlmil", "CLAM_SB", 1, "bfloat16"),
            "murcl_abmil": ("murcl", "ABMIL", 1, "bfloat16"),
            "murcl_clam_f32": ("murcl", "CLAM_SB", 1, "float32"),
            "supervised_f32": ("rlmil", "CLAM_SB", 1, "float32"),
            "supervised_s3_f32": ("rlmil", "CLAM_SB", 3, "float32"),
            "supervised_abmil_f32": ("rlmil", "ABMIL", 1, "float32"),
            "murcl_abmil_f32": ("murcl", "ABMIL", 1, "float32")}


def ab_side(tree: str, ds: dict, results: str) -> dict:
    """One side of the A/B, in a process of its own that imports the port
    from ``tree``: K7f and K7b through ``_pool_fwd_cuda`` / ``_pool_bwd_cuda``
    at ``AB_POOL``'s shapes and dtypes, K2 (the op's forward, under
    no_grad) and K3 (its backward) at the timed call of ``check_fused``, in
    bf16 and in f32, K8 through ``_tiled_fwd_cuda`` at ``AB_K8``'s, and K1
    through ``_gather_compact_cuda`` at each of ``COMPACT_SHAPES`` and at a
    TCGA-like shape (``tcga_like_inputs``) in both dtypes
    (median ms of 5, and one call's device ms by kernel),
    then the steady steps of ``AB_STEPS`` (supervised at batch 64, finetuned
    from ``ds["pretrained"]`` or, ABMIL, ``ds["abmil_pretrained"]``, stage 3
    chaining on the RLMIL path's stage 2 under ``<results>/rlmil``; MuRCL at
    batch 128) as ``steady_steps`` times them (step and enqueue ms, the
    device's busy ms over 3 traced steps, peak memory)."""
    sys.path.insert(0, tree)
    import torch

    from murcl_tpu_torch.drivers import murcl, rlmil
    from murcl_tpu_torch.ops import _cuda
    from murcl_tpu_torch.ops import attention as att
    from murcl_tpu_torch.ops import compact as comp

    check(Path(_cuda.__file__).resolve().is_relative_to(Path(tree).resolve()),
          f"A/B side imported {_cuda.__file__}, not {tree}'s port")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    _cuda.library()
    gen = torch.Generator(device=dev).manual_seed(0)
    res = {"tree": tree}
    for key, (b, d, gated, rate, dt) in AB_POOL.items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, w, mask, cots = pool_inputs(b, dtype, gen, dev, False, d)
        p = att._pool_fwd_cuda(x, *w, mask, gated, rate, 77)[1]

        def fwd():
            return att._pool_fwd_cuda(x, *w, mask, gated, rate, 77)

        def bwd():
            return att._pool_bwd_cuda(x, *w[:5], mask, p, *cots, gated, rate, 77)

        res[f"k7f_{key}_ms"], res[f"k7b_{key}_ms"] = median_ms(fwd), median_ms(bwd)
        res[f"k7f_{key}_split"], res[f"k7b_{key}_split"] = kernel_split(fwd), kernel_split(bwd)
        del x, p, cots
        torch.cuda.empty_cache()
    for dtype, tag in ((torch.bfloat16, ""), (torch.float32, "_f32")):
        h, w, mask, mix, cots = fused_inputs(B_MAIN, dtype, gen, dev, False)
        ws = [x.detach().clone().requires_grad_(True) for x in w]

        def k2():
            with torch.no_grad():
                return att.fused_trunk_attention_pool(h, *ws, mask=mask, dropout=0.25, seed=77,
                                                      mix=mix)

        outs = att.fused_trunk_attention_pool(h, *ws, mask=mask, dropout=0.25, seed=77, mix=mix)

        def k3():
            return torch.autograd.grad(outs, ws, cots, retain_graph=True)

        res.update({f"k2{tag}_ms": median_ms(k2), f"k3{tag}_ms": median_ms(k3),
                    f"k2{tag}_split": kernel_split(k2), f"k3{tag}_split": kernel_split(k3)})
        del outs, ws, h
        torch.cuda.empty_cache()
    for key, (n, dt) in AB_K8.items():
        dtype = torch.bfloat16 if dt == "bf16" else torch.float32
        x, w, mask = tiled_inputs(1, n, dtype, gen, dev, [n - 416])

        def k8():
            return att._tiled_fwd_cuda(x, *w, mask, True)

        res[key + "_ms"], res[key + "_split"] = median_ms(k8), kernel_split(k8)
        del x
        torch.cuda.empty_cache()
    # K1 at every bag count of the main paths and at a TCGA-like shape, both
    # dtypes, each call through the side's wrapper (the same inputs on both
    # sides: the generator seeded alike)
    cgen = torch.Generator(device=dev).manual_seed(5)
    feats32, shapes = compaction_inputs(dev, cgen)
    tcga = tcga_like_inputs(dev, cgen)
    cases = [(str(b), feats32, *v) for b, v in shapes.items()] + [("tcga", *tcga)]
    for name, f32, ranks, offs, nump in cases:
        for dt, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            feats = f32.to(dtype)

            def k1():
                return comp._gather_compact_cuda(feats, offs, ranks, N_MAIN, nump)

            key = f"compact_{name}_{dt}"
            res[key + "_ms"], res[key + "_split"] = median_ms(k1, reps=20), kernel_split(k1)
            del feats
            torch.cuda.empty_cache()
    del feats32, shapes, tcga, cases
    torch.cuda.empty_cache()
    for key, (mod, arch, stage, dtype) in AB_STEPS.items():
        if mod == "rlmil":
            pretrained = ds["pretrained" if arch == "CLAM_SB" else "abmil_pretrained"]
            base = Path(results) / ("rlmil" if stage == 3 else "ab_rlmil")
            s = rlmil.setup(rlmil_args(dev, ds, base, stage, pretrained, arch=arch,
                                       exist_ok=True, compute_dtype=dtype))
        else:
            s = murcl.setup(murcl_args(dev, ds, Path(results) / "murcl", arch, stage,
                                       exist_ok=True, compute_dtype=dtype))
        g = torch.Generator().manual_seed(0)
        if mod == "rlmil":
            bank, ids = s.sources["train"].bank, torch.arange(RL_BATCH, device=dev)
        else:
            bank, ids = s.source.bank, torch.arange(BATCH, device=dev) % SLIDES

        def step():
            s.engine.train_step(bank, ids, g)

        ms, enqueue, peak = timed_step(step)
        busy = profiling().profile_steps(step, f"A/B {Path(tree).name} {key}", ms)
        res[key] = {"ms": ms, "enqueue_ms": enqueue, "busy_ms": busy, "busy_pct": 100 * busy / ms,
                    "peak_gib": peak}
        del s, bank
        torch.cuda.empty_cache()
    return res


def ab_parent(ds, results):
    """K7f/K7b and K2/K3 in bf16 and f32, K8 and K1 (every bag count of the
    main paths, and a TCGA-like shape) in both, and the steady steps
    of ``AB_STEPS`` of the parent's tree and of this one, in turns (parent,
    this, this, parent), each side a process of its own on this card; all
    printed, none held. Returns ``{"parent": [side, side], "this": [side,
    side]}``, or None without a parent tree."""
    import torch

    if not (PARENT_TREE / "murcl_tpu_torch").is_dir():
        print(f"A/B against the parent: skipped (no parent tree at {PARENT_TREE})")
        return None
    torch.cuda.empty_cache()
    sides = {"parent": [], "this": []}
    for name, tree in (("parent", PARENT_TREE), ("this", REPO), ("this", REPO),
                       ("parent", PARENT_TREE)):
        t0 = time.time()
        proc = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--ab-side",
                               str(tree), json.dumps(ds), str(results)],
                              capture_output=True, text=True, timeout=900)
        check(proc.returncode == 0, f"A/B side {name}: {proc.stdout[-2000:]}{proc.stderr[-3000:]}")
        lines = proc.stdout.splitlines()
        for line in lines[:-1]:
            print(f"  [{name}] {line}")
        sides[name].append(json.loads(lines[-1]))
        print(f"A/B side {name} ({tree}) in {time.time() - t0:.1f} s")
    card = card_line()
    calls = [(f"k7{k}_{key}", f"K7{k} at ({b}, {N_MAIN}, {L1}) {dt} "
              f"{'gated' if gated else 'ungated'}, D {d}, dropout {rate}")
             for key, (b, d, gated, rate, dt) in AB_POOL.items() for k in ("f", "b")]
    calls += [("k2", f"K2 (the op's forward) at ({B_MAIN}, {N_MAIN}, {FIN}) bf16 gated, mixed, "
                     "dropout 0.25"),
              ("k3", "K3 (the op's backward), the same call"),
              ("k2_f32", f"K2 (the op's forward) at ({B_MAIN}, {N_MAIN}, {FIN}) f32 gated, mixed, "
                         "dropout 0.25"),
              ("k3_f32", "K3 f32 (the op's backward), the same call")]
    calls += [(key, f"K8 at (1, {n}, {L1}) {dt} gated") for key, (n, dt) in AB_K8.items()]
    calls += [(f"compact_{b}_{dt}", f"K1 at ({b}, {N_MAIN}, {FIN}) {dt}")
              for b in (*COMPACT_SHAPES, "tcga") for dt in ("bf16", "f32")]
    for key, what in calls:
        print(f"A/B {what}, in turns: " + "; ".join(
            f"{n} {[round(s[key + '_ms'], 3) for s in v]} ms, device "
            f"{[round(sum(ms for _, ms in s[key + '_split']), 3) for s in v]} ms"
            for n, v in sides.items()) + f" ({card})")
        for n, v in sides.items():
            print(f"  {n} {key} one call by kernel: "
                  + ", ".join(f"{k} {ms:.3f}" for k, ms in v[0][key + "_split"]))
    for key, (mod, arch, stage, dtype) in AB_STEPS.items():
        what = (f"{'supervised' if mod == 'rlmil' else 'MuRCL'} {arch} stage {stage} "
                f"{dtype}, batch {RL_BATCH if mod == 'rlmil' else BATCH}")
        print(f"A/B {what}, in turns: " + "; ".join(
            f"{n} " + ", ".join(
                f"{s[key]['ms']:.2f} ms (enqueue {s[key]['enqueue_ms']:.2f}, busy "
                f"{s[key]['busy_pct']:.2f}%, peak {s[key]['peak_gib']:.2f} GiB)" for s in v)
            for n, v in sides.items()) + f" ({card})")
    return sides


# the dp phase: MuRCL and RLMIL through the CLIs with --dp_devices DP_RANKS;
# the files a run directory holds, all rank 0's
DP_RANKS = 2
DP_MURCL_FILES = {"args.json", "losses.csv", "results.csv", "checkpoint.pth.tar",
                  "model_best.pth.tar"}
DP_RLMIL_FILES = DP_MURCL_FILES | {"accs.csv", "aucs.csv", "pred.csv", "final_res.csv"}


def nonzero(rank_launches) -> list:
    return [{k: v for k, v in launches.items() if v} for launches in rank_launches]


def dp_check_ranks(what, out, used, unused, files) -> dict:
    """A dp CLI run's checks: rank 0's files alone in its run directory,
    each rank's launches (``used`` > 0 and ``unused`` == 0 on every rank).
    Returns the launches summed over the ranks."""
    run_dir = Path(out["save_dir"])
    names = {p.name for p in run_dir.iterdir()}
    check(names == files, f"{what}: files {sorted(names)}")
    ranks = out["rank_launches"]
    check(len(ranks) == DP_RANKS, f"{what}: {len(ranks)} ranks reported")
    for r, launches in enumerate(ranks):
        check(all(launches[k] > 0 for k in used) and all(launches[k] == 0 for k in unused),
              f"{what}: rank {r} launches {launches}")
    return {k: sum(launches[k] for launches in ranks) for k in ranks[0]}


def dp_cli_path(dev, ds, results):
    """``train_MuRCL --dp_devices 2`` CLAM_SB stages 1 -> 2 -> 3 at the bench.py
    shape (2 steps each), a single-process stage 2 from the dp stage 1's
    ``model_best``, then ``train_RLMIL --dp_devices 2`` CLAM_SB stages 1 -> 2
    -> 3 at batch 64, finetuned from the dp MuRCL stage 3. Returns the
    launches of each dp run, summed over its ranks."""
    import torch

    from murcl_tpu_torch import train_MuRCL, train_RLMIL
    from murcl_tpu_torch.drivers.murcl import run
    from murcl_tpu_torch.ops import _cuda

    common = ["--data_csv", ds["data_csv"], "--device", str(dev.index), "--arch", "CLAM_SB",
              "--feat_size", str(N_MAIN), "--T", str(T), "--compute_dtype", "bfloat16",
              "--epochs", "1", "--ppo_epochs", "1", "--dp_devices", str(DP_RANKS)]
    counts, murcl_runs = [], []
    for stage in (1, 2, 3):
        what = f"dp MuRCL CLAM_SB stage {stage}"
        _cuda.reset_launch_counts()
        t0 = time.time()
        out = train_MuRCL.main(common + [
            "--data_split_json", ds["data_split_json"], "--train_stage", str(stage),
            "--batch_size", str(BATCH), "--data_repeat", str(2 * BATCH // SLIDES),
            "--base_save_dir", str(results / "murcl")])
        wall = time.time() - t0
        check(not any(_cuda.LAUNCHES.values()), f"{what}: the launching process launched")
        check(math.isfinite(out["best_loss"]), f"{what}: loss {out['best_loss']}")
        used, unused = MURCL_KERNELS["CLAM_SB"][stage]
        counts.append(dp_check_ranks(what, out, used, unused, DP_MURCL_FILES))
        murcl_runs.append(Path(out["save_dir"]))
        print(f"{what}: loss {out['best_loss']:.6f}, {out['steps_per_sec']:.4f} steps/s over "
              f"the epoch, main() wall {wall:.2f} s (spawn and load included), launches per "
              f"rank {nonzero(out['rank_launches'])}")
    args = murcl_args(dev, ds, results / "single", "CLAM_SB", 2,
                      checkpoint=str(murcl_runs[0] / "model_best.pth.tar"))
    out = run(args)
    torch.cuda.synchronize()
    check(math.isfinite(out["best_loss"]), f"single-process stage 2 from dp stage 1: {out}")
    print(f"single-process MuRCL CLAM_SB stage 2 from the dp stage 1's model_best: loss "
          f"{out['best_loss']:.6f}")
    pretrained = str(murcl_runs[2] / "model_best.pth.tar")
    every, trained, _ = RLMIL_KERNELS["CLAM_SB"]
    for stage in (1, 2, 3):
        what = f"dp RLMIL CLAM_SB finetune stage {stage}"
        t0 = time.time()
        out = train_RLMIL.main(common + [
            "--data_split_json", ds["rlmil_split_json"], "--train_stage", str(stage),
            "--batch_size", str(RL_BATCH), "--train_method", "finetune", "--save_model",
            "--base_save_dir", str(results / "rlmil"),
            *(("--checkpoint_pretrained", pretrained) if stage < 3 else ())])
        wall = time.time() - t0
        check(all(math.isfinite(v) for v in out["final"] + tuple(out["train_losses"])),
              f"{what}: {out['final']} {out['train_losses']}")
        used = every + (trained if stage != 2 else ())
        counts.append(dp_check_ranks(what, out, used, trained if stage == 2 else (),
                                     DP_RLMIL_FILES))
        print(f"{what}: train loss {out['train_losses'][0]:.6f}, final test {out['final']}, "
              f"main() wall {wall:.2f} s, launches per rank {nonzero(out['rank_launches'])}")
    return counts


def dp_draws(gen):
    """One global draw of a MuRCL stage-1 step's actions and per-rank mixup
    draws (partners within each rank's rows), as ``(per rank, single)``."""
    import torch

    from murcl_tpu_torch.ops.mixup import mixup_factors

    b = BATCH // DP_RANKS
    actions = torch.rand((T, 2, BATCH, K), generator=gen)
    ranks = []
    for r in range(DP_RANKS):
        mix = [mixup_factors(gen, b, 0.9) for _ in range(T * 2)]
        ranks.append({"actions": actions[:, :, r * b:(r + 1) * b].clone(),
                      "mix": (torch.stack([m[0] for m in mix]),
                              torch.stack([m[1] for m in mix]))})
    single = {"actions": actions,
              "mix": (torch.cat([d["mix"][0] for d in ranks], dim=1),
                      torch.cat([d["mix"][1] + r * b for r, d in enumerate(ranks)], dim=1))}
    return ranks, single


def dp_step(dp, args, draws, steady: int):
    """One MuRCL CLAM_SB stage-1 step at the bench.py shape with the injected
    ``draws[dp.rank]`` and dropout off, on rank ``dp`` (or the single process), then
    ``steady`` timed steps. Returns the step losses, the (all-reduced)
    gradients, the weights after the step and the timings."""
    import numpy as np
    import torch

    from murcl_tpu_torch.drivers.murcl import setup
    from murcl_tpu_torch.engine.optim import fill_missing_grads

    torch.backends.cuda.matmul.allow_tf32 = False
    s = setup(args, dp)
    s.model.encoder.dropout = 0.0  # the ranks' dropout masks are keyed per rank
    eng, bank, dev = s.engine, s.source.bank, s.device
    ids = torch.as_tensor(dp.local(np.arange(BATCH) % SLIDES), device=dev)
    named = ([(f"model.{k}", v) for k, v in eng.model.named_parameters()]
             + [(f"fc.{k}", v) for k, v in eng.fc.named_parameters()])
    gen = torch.Generator().manual_seed(0)
    stats = eng.train_step(bank, ids, gen, **draws[dp.rank])
    torch.cuda.synchronize()
    out = {"step_losses": stats.step_losses.cpu(),
           "grads": {k: v.grad.detach().cpu() for k, v in named if v.grad is not None},
           "weights": {k: v.detach().cpu() for k, v in named}}
    if steady:
        for _ in range(2):
            eng.train_step(bank, ids, gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times, host = [], []
        for _ in range(steady):
            t0 = time.perf_counter()
            eng.train_step(bank, ids, gen)
            host.append((time.perf_counter() - t0) * 1e3)  # enqueued, not yet synced
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        params = [p for g in eng.optimizer.param_groups for p in g["params"]]
        fill_missing_grads(params)
        reduce_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nbytes = dp.all_reduce_grads(params)
            torch.cuda.synchronize()
            reduce_ms.append((time.perf_counter() - t0) * 1e3)
        out.update(step_ms=statistics.median(times), steps=times,
                   enqueue_ms=statistics.median(host), reduce_bytes=nbytes,
                   reduce_ms=statistics.median(reduce_ms),
                   peak_gib=torch.cuda.max_memory_allocated() / 2**30,
                   params=sum(p.numel() for p in params))
    del s, eng
    torch.cuda.empty_cache()
    return out


def dp_step_path(dev, ds, results):
    """The dp-2 step against the single-process step from the same weights
    and draws (bf16: step losses within 2e-2 relative; the all-reduced
    gradients within 2e-2 relative Frobenius, floored as ``twin_step``
    floors; the ranks' gradients and weights after the Adam step bitwise
    equal), then steady steps in turns: single, dp, single."""
    import torch

    from murcl_tpu_torch.drivers.common import resolve_save_dir
    from murcl_tpu_torch.drivers.murcl import murcl_save_dir
    from murcl_tpu_torch.parallel import SINGLE, launch, rank_devices

    gen = torch.Generator().manual_seed(5)
    rank_draws, single_draws = dp_draws(gen)
    args = murcl_args(dev, ds, results / "dp_step", "CLAM_SB", 1, exist_ok=True)
    resolve_save_dir(args, murcl_save_dir)
    devices, backend = rank_devices(DP_RANKS, dev)
    shared = len(set(devices)) < DP_RANKS
    where = (f"{DP_RANKS} ranks over {backend} on {', '.join(map(str, devices))}"
             + (": the ranks share one card, so this is the collectives' overhead, not "
                "scaling" if shared else ""))
    before = dp_step(SINGLE, args, [{}], steady=5)
    torch.cuda.empty_cache()
    ranks = [v for v, _ in launch(DP_RANKS, dp_step, args, rank_draws, 5, device=dev,
                                  run_dir=args.save_dir)]
    single = dp_step(SINGLE, args, [single_draws], steady=5)
    what = "dp MuRCL CLAM_SB stage-1 step against the single-process step"
    for r in range(1, DP_RANKS):
        check(all(torch.equal(ranks[0]["weights"][k], ranks[r]["weights"][k])
                  for k in ranks[0]["weights"]), f"{what}: rank {r}'s weights differ from rank 0's")
        check(all(torch.equal(ranks[0]["grads"][k], ranks[r]["grads"][k])
                  for k in ranks[0]["grads"]), f"{what}: rank {r}'s gradients differ")
    loss_rel = float(((ranks[0]["step_losses"] - single["step_losses"]).abs()
                      / single["step_losses"].abs()).max())
    grads, want = ranks[0]["grads"], single["grads"]
    check(grads.keys() == want.keys() and len(grads) >= 10, f"{what}: gradients {sorted(grads)}")
    floor = 1e-4 * max(float(g.norm()) for g in want.values())
    rels = {k: float((grads[k].double() - want[k].double()).norm()
                     / max(float(want[k].norm()), floor)) for k in grads}
    worst = max(rels, key=rels.get)
    print(f"{what} ({where}): step losses {[round(float(v), 6) for v in ranks[0]['step_losses']]}"
          f" vs {[round(float(v), 6) for v in single['step_losses']]} (max rel diff "
          f"{loss_rel:.2e}); {len(rels)} all-reduced gradients, worst rel err "
          f"{rels[worst]:.2e} ({worst}); the ranks' weights after Adam bitwise equal")
    check(loss_rel <= 2e-2, f"{what}: step losses rel diff {loss_rel}")
    check(rels[worst] <= 2e-2, f"{what}: gradients {rels}")
    card = card_line()
    for name, r in [("single", before)] + [(f"dp rank {i}", v) for i, v in enumerate(ranks)] \
            + [("single", single)]:
        line = (f"steady MuRCL CLAM_SB stage 1, batch {BATCH}, {name}: median step "
                f"{r['step_ms']:.2f} ms, host enqueue {r['enqueue_ms']:.2f} ms, steps "
                f"{[round(t, 2) for t in r['steps']]}, peak device memory {r['peak_gib']:.2f} GiB")
        if name.startswith("dp"):
            line += (f", gradient all-reduce {r['reduce_bytes'] / 1e6:.1f} MB "
                     f"({r['params']} params) in {r['reduce_ms']:.2f} ms")
        print(f"{line} ({where}; {card})")
    if torch.cuda.device_count() < DP_RANKS:
        print(f"dp nccl: not run ({torch.cuda.device_count()} card)")
    return {"loss_rel": loss_rel, "grad_rel": rels[worst], "backend": backend}


# the streaming phase: a corpus of TCGA-sized slides drawn as the JAX
# package's scripts/bench_tcga_scale.py:41-49 draws them (patch counts uniform
# in 3,000-10,240; dim 512, K 10); the K1 check stages its tables at
# the JAX bench's Nmax of 10,240; as many slides as a batch, so that a
# batch can hold as many distinct slides as one drawn from TCGA's 10,000+
STREAM_SLIDES, STREAM_PATCHES, STREAM_NMAX = 128, (3000, 10240), 10240
STREAM_REPEAT = 3  # MuRCL's data_repeat: 384 bags, 3 steps of 128
STREAM_WARM, STREAM_TIMED, STREAM_TRACED = 2, 5, 3


def make_stream_dataset(root):
    """128 synthetic slides of 3,000-10,240 patches (about 1.7 GB of f32
    npz); MuRCL trains on all of them, RLMIL on the generator's 64 / 32 / 32
    split."""
    from murcl_tpu_torch.data.synthetic import generate_synthetic_dataset
    from murcl_tpu_torch.utils.general import dump_json

    ds = generate_synthetic_dataset(root, num_slides=STREAM_SLIDES, dim=FIN, num_clusters=K,
                                    min_patches=STREAM_PATCHES[0],
                                    max_patches=STREAM_PATCHES[1], seed=985)
    ds["murcl_split_json"] = str(Path(root) / "murcl_split.json")
    dump_json({"train": ds["case_ids"], "valid": ds["case_ids"][:2],
               "test": ds["case_ids"][:2]}, ds["murcl_split_json"])
    return ds


def _same_files(run_a, run_b, names) -> None:
    for name in names:
        a, b = (Path(r) / name for r in (run_a, run_b))
        check(a.read_bytes() == b.read_bytes(),
              f"streaming: {name} differs from the resident run's ({a} vs {b})")


def _run_counted(run, args, used):
    """``run(args)`` with every launch count set to 0 before and read after;
    fails unless each kernel of ``used`` was launched."""
    from murcl_tpu_torch.ops import _cuda

    _cuda.reset_launch_counts()
    out = run(args)
    launches = dict(_cuda.LAUNCHES)
    check(all(launches[k] > 0 for k in used), f"{args.save_dir}: launches {launches}")
    return out, launches


def stream_equality(dev, sds, results):
    """The CLIs with and without ``--streaming`` on the same seed, at a
    learning rate of 0 for the aggregator and the head: K3's and K7b's
    split-K weight gradients add with atomics, so two runs that train
    differ in their last bits after the first update whatever feeds them;
    at lr 0 every step's loss depends on its batch's data alone, which is
    what the feed must get right. MuRCL CLAM_SB stage 1 (3 steps): equal
    ``losses.csv``. RLMIL CLAM_SB scratch, batch 64: stage 1, stage 2 once
    (its PPO trains), stage 3 from that stage 2: equal ``final_res.csv`` and
    ``pred.csv``. Returns the streaming runs' launch counts."""
    from murcl_tpu_torch.drivers import murcl, rlmil

    counts, frozen = [], dict(backbone_lr=0.0, fc_lr=0.0)
    runs = {}
    for streaming in (False, True):
        args = murcl.default_args(
            data_csv=sds["data_csv"], data_split_json=sds["murcl_split_json"],
            device=str(dev), batch_size=BATCH, feat_size=N_MAIN, T=T,
            compute_dtype="bfloat16", data_repeat=STREAM_REPEAT, epochs=1,
            base_save_dir=str(results / "murcl" / ("stream" if streaming else "resident")),
            streaming=streaming, **frozen)
        t0 = time.time()
        out, launches = _run_counted(murcl.run, args, MURCL_KERNELS["CLAM_SB"][1][0])
        runs[streaming] = out["save_dir"]
        if streaming:
            counts.append(launches)
        print(f"MuRCL CLAM_SB stage 1 {'streaming' if streaming else 'resident'} at lr 0: "
              f"loss {out['best_loss']:.6f}, {out['steps_per_sec']:.3f} steps/s, run() "
              f"{time.time() - t0:.2f} s")
    _same_files(runs[False], runs[True], ["losses.csv"])
    print("MuRCL CLAM_SB stage 1: losses.csv equal with and without --streaming")

    rl_runs = {}
    for stage in (1, 2, 3):
        for streaming in ((False, True) if stage != 2 else (False,)):
            side = "stream" if streaming else "resident"
            args = rlmil.default_args(
                data_csv=sds["data_csv"], data_split_json=sds["data_split_json"],
                device=str(dev), train_method="scratch", train_stage=stage,
                batch_size=RL_BATCH, feat_size=N_MAIN, T=T, compute_dtype="bfloat16",
                epochs=1, ppo_epochs=1, save_model=True, streaming=streaming,
                base_save_dir=str(results / "rlmil" / side), **frozen)
            if stage == 3:  # both from the one stage 2
                args.checkpoint_stage = str(Path(rl_runs["stage2"]) / "model_best.pth.tar")
            used = RLMIL_KERNELS["CLAM_SB"][0] + (RLMIL_KERNELS["CLAM_SB"][1]
                                                  if stage != 2 else ())
            t0 = time.time()
            out, launches = _run_counted(rlmil.run, args, used)
            if streaming:
                counts.append(launches)
            key = "stage2" if stage == 2 else (stage, streaming)
            rl_runs[key] = out["save_dir"]
            print(f"RLMIL CLAM_SB stage {stage} {side} at lr 0: final test {out['final']}, "
                  f"run() {time.time() - t0:.2f} s")
        if stage != 2:
            _same_files(rl_runs[stage, False], rl_runs[stage, True], ["final_res.csv",
                                                                       "pred.csv"])
            print(f"RLMIL CLAM_SB stage {stage}: final_res.csv and pred.csv equal with and "
                  "without --streaming")
    return counts, runs[True], rl_runs[1, True]


def policy_conv_runs(dev, sds, results, murcl_stage1, rlmil_stage1):
    """``--policy_conv`` (and ``--streaming``): one MuRCL stage 2 from the
    streaming stage-1 run, one RLMIL stage 2 (finetune, its policy from that
    MuRCL stage 2); each checkpoint's conv policy loads back into a fresh
    policy with nothing skipped."""
    import torch

    from murcl_tpu_torch.drivers import murcl, rlmil
    from murcl_tpu_torch.engine.checkpoint import load_checkpoint, transfer_state
    from murcl_tpu_torch.models import ActorCritic

    args = murcl.default_args(
        data_csv=sds["data_csv"], data_split_json=sds["murcl_split_json"], device=str(dev),
        batch_size=BATCH, feat_size=N_MAIN, T=T, compute_dtype="bfloat16", data_repeat=1,
        epochs=1, ppo_epochs=1, train_stage=2, policy_conv=True, streaming=True,
        checkpoint=str(Path(murcl_stage1) / "model_best.pth.tar"),
        base_save_dir=str(results / "conv_murcl"))
    out, _ = _run_counted(murcl.run, args, MURCL_KERNELS["CLAM_SB"][2][0])
    murcl_best = Path(out["save_dir"]) / "model_best.pth.tar"
    args = rlmil.default_args(
        data_csv=sds["data_csv"], data_split_json=sds["data_split_json"], device=str(dev),
        train_method="finetune", train_stage=2, batch_size=RL_BATCH, feat_size=N_MAIN, T=T,
        compute_dtype="bfloat16", epochs=1, ppo_epochs=1, save_model=True, policy_conv=True,
        streaming=True, checkpoint_pretrained=str(murcl_best),
        checkpoint_stage=str(Path(rlmil_stage1) / "model_best.pth.tar"),
        base_save_dir=str(results / "conv_rlmil"))
    out, _ = _run_counted(rlmil.run, args, RLMIL_KERNELS["CLAM_SB"][0])
    for what, path in (("MuRCL", murcl_best), ("RLMIL", Path(out["save_dir"])
                                                / "model_best.pth.tar")):
        policy = load_checkpoint(path)["policy"]
        fresh = ActorCritic(L1, 512, action_size=K, policy_conv=True)
        skipped = transfer_state(fresh, policy)
        check(not skipped and policy["state_encoder.0.weight"].shape == (32, L1, 1, 1)
              and all(torch.equal(v, policy[k]) for k, v in fresh.state_dict().items()),
              f"{what} --policy_conv stage 2: its checkpoint's policy did not load back "
              f"({skipped})")
        print(f"{what} CLAM_SB stage 2 with --policy_conv: finished, {path.name} holds the "
              "conv policy (state_encoder.0 (32, 512, 1, 1), state_encoder.3) and loads back")


def check_compaction_tcga(dev, sds):
    """K1 against its twin on a staged mini-bank at the TCGA shape: a batch of
    128 distinct slides of the corpus, patch tables 10,240 wide, ranks
    (1536, 10240); bitwise in f32 and bf16, timed in both
    (``compaction_times``)."""
    import numpy as np
    import torch

    from murcl_tpu_torch.data.streaming import StreamingBank
    from murcl_tpu_torch.ops.compact import _gather_compact_cuda, gather_compact_plain
    from murcl_tpu_torch.ops.select import select_ranks

    stream = StreamingBank(sds["data_csv"], device=dev, max_patches=STREAM_NMAX)
    ids = np.random.default_rng(1).permutation(STREAM_SLIDES)[:BATCH]
    bank, sid = stream.stage(ids)
    flat = torch.cat([sid, sid]).repeat(T)
    gen = torch.Generator(device=dev).manual_seed(2)
    actions = torch.rand(flat.shape[0], K, generator=gen, device=dev)
    ranks, offs, _ = select_ranks(flat, bank.offsets, bank.num_patches, bank.cluster_sizes,
                                  actions, bank.patch_cluster, bank.patch_pos, N_MAIN)
    check(tuple(ranks.shape) == (B_MAIN, STREAM_NMAX), f"K1 TCGA ranks {tuple(ranks.shape)}")
    nump = bank.num_patches[flat]
    res = {"tcga_slides": bank.num_slides, "tcga_rows": int(bank.feats.shape[0])}
    for dtype, view, tag in ((torch.float32, torch.int32, "_f32"),
                             (torch.bfloat16, torch.int16, "")):
        feats = bank.feats.to(dtype)
        got = _gather_compact_cuda(feats, offs, ranks, N_MAIN, nump)
        want = gather_compact_plain(feats, offs, ranks, N_MAIN, nump)
        check(torch.equal(got.view(view), want.view(view)),
              f"K1 at ({B_MAIN}, {STREAM_NMAX}) on a staged mini-bank ({dtype})")
        del got, want
        r = compaction_times(feats, ranks, offs, nump)
        res.update({f"tcga{tag}_{k}": v for k, v in r.items()})
        del feats
    return res


def steady_stream_steps(dev, sds, results):
    """Steady MuRCL CLAM_SB stage-1 steps (the ``bench.py`` step) on the
    corpus, streaming and resident in turns, twice round, each turn 2
    warm-up steps and 5 timed (a host clock around each synchronised step,
    the producer's wait included); the second round also traces 3 steps of
    each. Each batch is 128 distinct slides, as a batch drawn from TCGA's
    10,000+ slides nearly always is. Per side the step, the host's staging
    time per batch (reading the slides' rows into the pinned buffer), the
    bytes and rate of the copy to the card (CUDA events on the side
    stream), and the peak device memory."""
    import numpy as np
    import torch

    from murcl_tpu_torch.data.streaming import StreamingBank
    from murcl_tpu_torch.drivers.murcl import default_args, setup

    s = setup(default_args(data_csv=sds["data_csv"], data_split_json=sds["murcl_split_json"],
                           device=str(dev), batch_size=BATCH, feat_size=N_MAIN, T=T,
                           compute_dtype="bfloat16", base_save_dir=str(results / "steady")))
    resident = s.source.bank
    stream = StreamingBank(sds["data_csv"], device=dev, dtype=torch.bfloat16)
    per_turn = STREAM_WARM + STREAM_TIMED + STREAM_TRACED
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    stats = {name: {"ms": [], "host": [], "staging": [], "bytes": [], "copy_ms": [],
                    "peak": 0.0} for name in ("streaming", "resident")}
    for rnd in range(2):
        for name in stats:
            batches = [rng.permutation(STREAM_SLIDES)[:BATCH] for _ in range(per_turn)]
            if name == "resident":
                feed = iter([(resident, torch.as_tensor(b, device=dev)) for b in batches])
            else:
                stream.stage_log.clear()
                feed = stream.iter_epoch(batches)

            def step():
                bank, sid = next(feed)
                s.engine.train_step(bank, sid, gen)

            for _ in range(STREAM_WARM):
                step()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(STREAM_TIMED):
                t0 = time.perf_counter()
                step()
                stats[name]["host"].append((time.perf_counter() - t0) * 1e3)
                torch.cuda.synchronize()
                stats[name]["ms"].append((time.perf_counter() - t0) * 1e3)
            stats[name]["peak"] = max(stats[name]["peak"],
                                      torch.cuda.max_memory_allocated() / 2**30)
            if rnd == 1:
                profiling().profile_steps(step, f"MuRCL CLAM_SB stage 1, {name}, TCGA corpus",
                                          statistics.median(stats[name]["ms"]))
            if name != "resident":
                for _ in feed:  # the producer's staged-ahead batch
                    pass
                torch.cuda.synchronize()
                for rec in stream.stage_log:
                    start, ready = rec["events"]
                    stats[name]["staging"].append(rec["host_ms"])
                    stats[name]["bytes"].append(rec["bytes"])
                    stats[name]["copy_ms"].append(start.elapsed_time(ready))
    out = {}
    for name, r in stats.items():
        ms = statistics.median(r["ms"])
        line = (f"steady MuRCL CLAM_SB stage 1 on the TCGA corpus, {name}: median step "
                f"{ms:.2f} ms, steps {[round(t, 2) for t in r['ms']]}, host enqueue "
                f"{statistics.median(r['host']):.2f} ms, peak device memory "
                f"{r['peak']:.2f} GiB")
        if r["staging"]:
            gbps = [b / c / 1e6 for b, c in zip(r["bytes"], r["copy_ms"])]
            line += (f"; host staging {statistics.median(r['staging']):.2f} ms per batch "
                     f"(range {min(r['staging']):.2f}-{max(r['staging']):.2f}), copy to the "
                     f"card {statistics.median(r['bytes']) / 1e9:.3f} GB per batch in "
                     f"{statistics.median(r['copy_ms']):.2f} ms ("
                     f"{statistics.median(gbps):.2f} GB/s, side stream incl. the cast)")
        print(line)
        out[name] = ms
    del s, stream
    torch.cuda.empty_cache()
    return out


def streaming_path(dev, root):
    """The streaming phase: the corpus, the CLIs' equality, ``--policy_conv``,
    K1 at the TCGA shape and the steady steps in turns. Returns ``(launch
    counts of the streaming runs, K1's TCGA fields, steady ms)``."""
    t0 = time.time()
    sds = make_stream_dataset(root / "data")
    size = sum(p.stat().st_size for p in (root / "data" / "features").iterdir())
    print(f"streaming corpus: {STREAM_SLIDES} slides of {STREAM_PATCHES[0]}-"
          f"{STREAM_PATCHES[1]} patches x {FIN}, {size / 1e9:.3f} GB of npz, written in "
          f"{time.time() - t0:.1f} s")
    counts, murcl_stage1, rlmil_stage1 = stream_equality(dev, sds, root / "eq")
    policy_conv_runs(dev, sds, root, murcl_stage1, rlmil_stage1)
    k1 = check_compaction_tcga(dev, sds)
    print(f"K1 on a staged mini-bank ({k1['tcga_slides']} distinct slides, {k1['tcga_rows']} "
          f"rows) at ranks ({B_MAIN}, {STREAM_NMAX}) bitwise ok; bf16 "
          + compaction_line({k: k1["tcga_" + k] for k in COMPACTION_KEYS}) + "; f32 "
          + compaction_line({k: k1["tcga_f32_" + k] for k in COMPACTION_KEYS})
          + f" ({card_line()})")
    steady = steady_stream_steps(dev, sds, root)
    print(f"streaming phase in {time.time() - t0:.1f} s")
    return counts, k1, steady


def ablation_rows(abl) -> list:
    """The kernels line's rows of the probes' kernels (:func:`ablation_path`):
    each variant's ms at the script's shape in bf16 (K3's also in f32, under
    ``f32``) beside its twin's and its bound (the products at the bf16 peak,
    f32's at TF32's; the overlap's vpu mode its bytes), launches from the
    path's run, ``max_abs_err`` from the same calls against their twins;
    the f32 lean variants, not timed, only at 64 bags."""
    base = "murcl_tpu_torch/csrc/"
    bwd_site, lean_fwd, lean_bwd = ("scripts/dbg_bwd_ablate.py:152",
                                    "scripts/dbg_vpu_lean.py:122", "scripts/dbg_vpu_lean.py:280")
    # bytes read once: the bags, their mask and the cotangents (K3: p, gp,
    # gs per row, gm per bag) or written once (K2: M, p, s); the weights'
    # and gradients' few MB left out
    r = B_MAIN * N_MAIN
    h_bytes = {dt: r * FIN * size + 13 * r + 4 * B_MAIN * L1
               for dt, size in (("bf16", 2), ("f32", 4))}
    rows = []

    def row(name, src, rep, ms, plain, flops, nbytes, peak, err, extra=None):
        b_ms, b_by = bound(flops, nbytes, peak)
        rows.append({"name": name, "route": "cuda", "source": base + src, "replaces": rep,
                     "launches": abl["launches"][name], "max_abs_err": err, "ms": ms,
                     "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                     **(extra or {})})

    for v in ("full", "nodrop", "nowgrad", "nodx", "recompute"):
        name = f"trunk_bwd_{v}"
        b_f32 = bound(ablation_work(v), h_bytes["f32"], TF32_FLOPS)
        f32 = {"ms": abl["bwd"]["float32"][v], "plain_ms": abl["plain"][name + "_f32"],
               "bound_ms": b_f32[0], "bound_by": b_f32[1], "max_abs_err": abl["err"][name + "_f32"]}
        rep = bwd_site + (f" ({v}); {lean_bwd} (lean)" if v == "full" else f" ({v})")
        row(name, "fused_trunk.cu", rep, abl["bwd"]["bfloat16"][v], abl["plain"][name],
            ablation_work(v), h_bytes["bf16"], BF16_FLOPS, abl["err"][name], {"f32": f32})
    for v, tag in (("prelean", "bwd full"), ("lean2", "bwd lean2")):
        name = f"trunk_bwd_{v}"
        row(name, "fused_trunk.cu", f"{lean_bwd} ({tag.split()[1]})", abl["lean"]["ms"][tag],
            abl["plain"][name], ablation_work(v), h_bytes["bf16"], BF16_FLOPS, abl["err"][name],
            {"f32_max_abs_err_64_bags": abl["err64"][name + "_f32"]})
    for v, tag in (("lean", "fwd lean"), ("prelean", "fwd full")):
        name = f"trunk_fwd_{v}"
        row(name, "fused_trunk.cu", f"{lean_fwd} ({tag.split()[1]})", abl["lean"]["ms"][tag],
            abl["plain"][name], ablation_work("fwd_" + v), h_bytes["bf16"], BF16_FLOPS,
            abl["err"][name], {"f32_max_abs_err_64_bags": abl["err64"][name + "_f32"]})
    # the overlap: 4 products of (256 x 1024, 512) @ (512, 512); x and y read
    r = OVERLAP_STEPS * OVERLAP_ROWS
    mxu, io = 4 * 2 * r * 512 * 512, 2 * r * 512 * 2 + 512 * 512 * 2
    vpu = 3 * 8 * r * 512  # tanh, sigmoid and their product, 8 rounds
    for m in ("mxu", "vpu", "dep", "indep"):
        flops, peak = (vpu, F32_FLOPS) if m == "vpu" else (mxu, BF16_FLOPS)
        row(f"overlap_{m}", "wgmma_overlap.cu", f"scripts/dbg_mxu_vpu_overlap.py:96 ({m})",
            abl["overlap"][m], abl["plain"][f"overlap_{m}"], flops, io, peak,
            abl["err"][f"overlap_{m}"])
    return rows


def compaction_rows(cp) -> list:
    """The kernels line's rows of the compaction and dropout probes
    (:func:`compaction_probe_path`): each variant's ms at its script's shape
    beside its twin's and its function's bound (bytes: K1's rule; dmafloor's
    function the windows' first rows copied), K1's ms on the same inputs
    (``production_ms``), the formulation's floor (``formulation_floor_ms``:
    the one-hot products at the bf16 peak, dmafloor's own bytes), launches
    from the path's run, ``max_abs_err`` from the same calls against their
    twins."""
    base = "murcl_tpu_torch/csrc/"
    sites = {"compact": "scripts/dbg_compact_ablate.py:160", "grouped":
             "scripts/dbg_grouped_ablate.py:176", "gate": "scripts/dbg_grouped_gate.py:187"}
    b_ms, b_by = cp["bound"]["gate_masks"]
    rows = [{"name": "gate_masks", "route": "cuda", "source": base + "gate_masks.cu",
             "replaces": "scripts/tpu_smoke.py:101 (mask_kernel :96-99)",
             "launches": cp["launches"]["gate_masks"], "max_abs_err": cp["err"]["gate_masks"],
             "ms": cp["dropout"]["ms"], "plain_ms": cp["plain"]["gate_masks"], "bound_ms": b_ms,
             "bound_by": b_by, "library_ms": None, "keep_rate": cp["dropout"]["keep_rate"],
             "wc_grad_rel": cp["dropout"]["grad_rel"]}]
    for script, times in cp["times"].items():
        for v, ms in times.items():
            if v == "production":
                continue
            name = f"onehot_{script}_{v}"
            b_ms, b_by = cp["bound"][name]
            rows.append({"name": name, "route": "cuda", "source": base + "compact_onehot.cu",
                         "replaces": f"{sites[script]} ({v})", "launches": cp["launches"][name],
                         "max_abs_err": cp["err"][name], "ms": ms, "plain_ms": cp["plain"][name],
                         "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                         "production_ms": times["production"],
                         "formulation_floor_ms": cp["floor"][name][0]})
    return rows


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
    print("warpgroup products (HGMMA) in the K2/K3 and K7 kernels' SASS (K8's gate pass is "
          "pool_gates_fwd_wg), and tensor-core instructions in K8's chunk pass: "
          + ", ".join(f"{k} {v}" for k, v in counts.items())
          + f"; {', '.join(GONE_KERNELS)} and the probes' kernels not in the library")
    # the probes' own library (the ablation phase's), built apart from the
    # kernels' so that no training path waits for it
    t0 = time.time()
    _cuda.probe_library()
    print(f"probe library built and loaded in {time.time() - t0:.1f} s")
    counts = check_sass(probes=True)
    print("warpgroup products (HGMMA) in the probes' SASS (K2/K3's ablations, the overlap's "
          "modes), and tensor-core instructions in the overlap's vpu mode: "
          + ", ".join(f"{k} {v}" for k, v in counts.items()))

    k1 = check_compaction(dev, gen)
    print(f"K1 compaction bitwise ok; at ({B_MAIN}, {N_MAIN}, {FIN}) bf16 "
          + compaction_line(k1["shapes"][f"{B_MAIN}_bf16"]) + f"; at K5's shape ({RL_BATCH}, "
          f"{N_MAIN}, {FIN}) " + compaction_line(k1["shapes"][f"{RL_BATCH}_bf16"])
          + f", {k1['k5_slices']} slot slices per bag ({card})")
    sel = select_probe_path(dev)
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
    f32 = check_fused_f32(dev, gen)
    print(f"K2 f32 (three bf16 products per product) at ({B_MAIN}, {N_MAIN}, {FIN}) gated, mixed, "
          f"dropout 0.25: {f32['fwd_ms']:.2f} ms vs plain {f32['fwd_plain_ms']:.2f} ms, bound "
          f"{f32['fwd_bound_ms']:.3f} ms ({f32['fwd_bound_by']}, TF32); K3 f32 "
          f"{f32['bwd_ms']:.2f} ms vs plain {f32['bwd_plain_ms']:.2f} ms, bound "
          f"{f32['bwd_bound_ms']:.3f} ms; K2 ungated {f32['fwd_ungated_ms']:.2f} ms; K3 ungated "
          f"{f32['bwd_ungated_ms']:.2f}, unmixed {f32['bwd_unmixed_ms']:.2f}, unmixed with dh "
          f"{f32['bwd_dh_ms']:.2f} ms; largest rel err {f32['max_rel']:.2e} ({card})")
    k7f, k7b, k7_f32 = check_pool(dev, gen)
    print(f"K7 pool fwd {k7f['ms']:.2f} ms vs plain {k7f['plain_ms']:.2f} ms, bound "
          f"{k7f['bound_ms']:.4f} ms; K7 bwd {k7b['ms']:.2f} ms vs plain {k7b['plain_ms']:.2f} ms, "
          f"bound {k7b['bound_ms']:.4f} ms at ({POOL_BAGS}, {N_MAIN}, {L1}) bf16 gated, D {D}, "
          f"dropout 0.25 ({card})")
    print(f"K7 ABMIL mode (ungated, D {ABMIL_D}, dropout 0) at ({B_MAIN}, {N_MAIN}, {L1}) "
          f"bf16: fwd {k7f['abmil_ms']:.2f} ms vs plain {k7f['abmil_plain_ms']:.2f} ms, bound "
          f"{k7f['abmil_bound_ms']:.4f} ms; bwd {k7b['abmil_ms']:.2f} ms vs plain "
          f"{k7b['abmil_plain_ms']:.2f} ms, bound {k7b['abmil_bound_ms']:.4f} ms ({card})")
    print(f"K7 f32 (three bf16 products per product) at ({POOL_BAGS}, {N_MAIN}, {L1}) gated, D "
          f"{D}, dropout 0.25: fwd {k7_f32['sup_fwd_ms']:.3f} ms vs plain "
          f"{k7_f32['sup_fwd_plain_ms']:.3f} ms, bound {k7_f32['sup_fwd_bound_ms']:.4f} ms "
          f"({k7_f32['sup_fwd_bound_by']}); bwd {k7_f32['sup_bwd_ms']:.3f} ms vs plain "
          f"{k7_f32['sup_bwd_plain_ms']:.3f} ms, bound {k7_f32['sup_bwd_bound_ms']:.4f} ms; ABMIL "
          f"mode ({B_MAIN}, {N_MAIN}, {L1}) ungated D {ABMIL_D}: fwd {k7_f32['abmil_fwd_ms']:.3f} "
          f"vs {k7_f32['abmil_fwd_plain_ms']:.3f} ms (bound {k7_f32['abmil_fwd_bound_ms']:.4f}), "
          f"bwd {k7_f32['abmil_bwd_ms']:.3f} vs {k7_f32['abmil_bwd_plain_ms']:.3f} ms (bound "
          f"{k7_f32['abmil_bwd_bound_ms']:.4f}); K8's op backward at {K8_MAIN} "
          f"{k7_f32['k8_bwd_ms']:.3f} vs {k7_f32['k8_bwd_plain_ms']:.3f} ms; largest rel err "
          f"{k7_f32['max_rel']:.2e} ({card})")
    k6 = check_mixup(dev, gen)
    print(f"K6 mixup bitwise ok; {k6['ms']:.3f} ms vs plain {k6['plain_ms']:.3f} ms at "
          f"({B_MAIN}, {N_MAIN}, {FIN}) bf16 ({k6['gbps']:.0f} GB/s moved); "
          f"{k6['ms_f32']:.3f} ms vs plain {k6['plain_ms_f32']:.3f} ms at "
          f"({B_MAIN // 8}, {N_MAIN}, {FIN}) f32 ({card})")
    k8 = check_tiled(dev, gen)
    print(f"K8 gated f32 at (1, 60416, {L1}) {k8['ms']:.3f} ms vs plain {k8['plain_ms']:.3f} ms, "
          f"bound {k8['bound_ms']:.4f} ms (TF32); at (1, 12288, {L1}) {k8['ms_12288']:.3f} vs "
          f"{k8['plain_ms_12288']:.3f} ms; bf16 at (1, 60416, {L1}) {k8['ms_bf16']:.3f} vs "
          f"{k8['plain_ms_bf16']:.3f} ms, at (1, 12288, {L1}) {k8['ms_bf16_12288']:.3f} vs "
          f"{k8['plain_ms_bf16_12288']:.3f} ms; the op's backward (K7b) at (1, 60416, {L1}) f32 "
          f"{k8['bwd_ms']:.3f} vs {k8['bwd_plain_ms']:.3f} ms ({card})")

    t0 = time.time()
    abl = ablation_path(dev)
    print(f"ablation phase in {time.time() - t0:.1f} s")
    t0 = time.time()
    cprobe = compaction_probe_path(dev)
    print(f"compaction probe phase in {time.time() - t0:.1f} s")

    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=work))
    try:
        t0 = time.time()
        nvjpeg_path(dev, tmp / "nvjpeg")
        print(f"nvJPEG phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        pre = preprocess_path(dev, tmp / "preprocess")
        jpeg_slide_path(dev, tmp / "jpeg")
        print(f"preprocessing phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        ds = make_dataset(tmp / "data")
        print(f"synthetic dataset written in {time.time() - t0:.1f} s")
        clam_stages, pretrained = murcl_path(dev, ds, tmp / "murcl", "CLAM_SB")
        cli_stages = murcl_cli_path(dev, ds, tmp / "murcl_cli")
        heat = heatmap_path(dev, tmp / "slides", pretrained)
        abmil_stages, abmil_pretrained = murcl_path(dev, ds, tmp / "murcl", "ABMIL")
        abmil_step_check(dev, ds, tmp / "murcl")
        rl_stages = [rlmil_path(dev, ds, tmp / "rlmil", pretrained),
                     rlmil_path(dev, ds, tmp / "rlmil", abmil_pretrained, "ABMIL"),
                     rlmil_path(dev, ds, tmp / "rlmil", None, "DSMIL")]
        supervised_step_check(dev, ds, tmp / "rlmil", abmil_pretrained)
        t0 = time.time()
        ppo_counts = ppo_sanity_path(dev)
        print(f"ppo_sanity phase in {time.time() - t0:.1f} s")
        rl_cli = rlmil_cli_path(dev, ds, tmp / "rlmil_cli", pretrained)
        steady_steps(dev, ds, tmp / "rlmil", [("CLAM_SB", 3, pretrained, "bfloat16"),
                                              ("CLAM_SB", 1, pretrained, "bfloat16"),
                                              ("ABMIL", 1, abmil_pretrained, "bfloat16"),
                                              ("DSMIL", 1, None, "bfloat16"),
                                              ("CLAM_SB", 1, pretrained, "float32"),
                                              ("CLAM_SB", 3, pretrained, "float32"),
                                              ("ABMIL", 1, abmil_pretrained, "float32")])
        steady_murcl_steps(dev, ds, tmp / "murcl")
        diag_counts, _ = step_diagnostics_path(dev, tmp / "diag")
        t0 = time.time()
        ab = ab_parent({**{k: str(ds[k]) for k in ("data_csv", "data_split_json",
                                                   "rlmil_split_json")},
                        "pretrained": str(pretrained),
                        "abmil_pretrained": str(abmil_pretrained)}, tmp)
        print(f"A/B phase in {time.time() - t0:.1f} s")
        t0 = time.time()
        dp_counts = dp_cli_path(dev, ds, tmp / "dp")
        dp_step_path(dev, ds, tmp / "dp")
        print(f"dp phase in {time.time() - t0:.1f} s")
        stream_counts, k1_tcga, _ = streaming_path(dev, tmp / "stream")
        k1.update(k1_tcga)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    for counts in [pre, *clam_stages.values(), *cli_stages.values(), *abmil_stages.values(), heat,
                   rl_cli, *ppo_counts, *diag_counts,
                   *(c for path in rl_stages for c in path.values()), *dp_counts,
                   *stream_counts]:
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
                            + ("; bags' gradient dh" if row["name"].endswith("bwd") else "")
                            + "; bf16, and f32 as three bf16 products (f32)")
            r = k2 if row["name"].endswith("fwd") else k3
            row["split_ms"] = r["split_ms"]
            # the f32 route (the CLIs' default) at the same call; its bound
            # counts the f32 products at TF32's rate
            side = "fwd" if row["name"].endswith("fwd") else "bwd"
            row["f32"] = {k[len(side) + 1:]: v for k, v in f32.items() if k.startswith(side)}
            row["f32"]["max_rel"] = f32["max_rel"]
            row["f32"]["max_abs_err"] = f32[f"max_abs_err_{side}"]
            # L1 200, D 100, zero-padded by the op: the largest relative
            # Frobenius error of the forward and backward against the twin
            row["padded_l1_d_max_rel"] = cprobe["padded_trunk"]
            if ab:  # the op timed in turns beside the parent's, ms per side run
                key = "k2" if row["name"].endswith("fwd") else "k3"
                row["ab_ms"] = [s[key + "_ms"] for s in ab["this"]]
                row["ab_parent_ms"] = [s[key + "_ms"] for s in ab["parent"]]
                row["f32"]["ab_ms"] = [s[key + "_f32_ms"] for s in ab["this"]]
                row["f32"]["ab_parent_ms"] = [s[key + "_f32_ms"] for s in ab["parent"]]
        if row["name"] in ("attention_pool_fwd", "attention_pool_bwd"):
            row["modes"] = (f"gated and ungated at D {D}; gated at D {CLAM_BIG_D} (bf16) and on "
                            f"{TAIL_N}-row bags; ungated at D {ABMIL_D} (ABMIL: MuRCL and "
                            "supervised); f32 as three bf16 products (f32): gated and ungated "
                            f"at D {ABMIL_D}, {D} and {CLAM_BIG_D}, dropout 0 and 0.25, "
                            f"{TAIL_N}-row bags ending at the 128-row tiles' edges")
            # the f32 route (the supervised CLIs' default) at the supervised
            # shape and in ABMIL's mode, and (K7b) K8's op backward; its
            # bounds count the f32 products at TF32's rate
            side = "fwd" if row["name"].endswith("fwd") else "bwd"
            row["f32"] = {k.replace(f"_{side}_", "_", 1): v for k, v in k7_f32.items()
                          if f"_{side}_" in k}
            row["f32"]["max_rel"] = k7_f32["max_rel"]
            row["f32"]["max_abs_err"] = k7_f32[f"max_abs_err_{side}"]
            if ab:  # timed in turns beside the parent's, ms per side run, per AB_POOL shape
                k = "k7f" if side == "fwd" else "k7b"
                row["ab_ms"] = {s: [r[f"{k}_{s}_ms"] for r in ab["this"]] for s in AB_POOL}
                row["ab_parent_ms"] = {s: [r[f"{k}_{s}_ms"] for r in ab["parent"]]
                                       for s in AB_POOL}
        if row["name"] == "attention_pool_tiled":
            row["modes"] = ("gated and ungated, f32 and bf16; timed f32 gated at (1, 60416, 512); "
                            "bound of the function's f32 products at the TF32 rate; the gate "
                            "pass on K7f's warpgroup kernel, then the chunk pass and the merge")
            row.update({k: k8[k] for k in ("ms_12288", "plain_ms_12288", "bound_ms_12288",
                                           "ms_bf16", "plain_ms_bf16", "bound_ms_bf16",
                                           "ms_bf16_12288", "plain_ms_bf16_12288",
                                           "bound_ms_bf16_12288", "split_ms", "split_ms_bf16",
                                           "device_ms", "enqueue_ms", "device_ms_bf16",
                                           "enqueue_ms_bf16", "bwd_ms", "bwd_plain_ms")})
            if ab:  # timed in turns beside the parent's, ms per side run
                row["ab_ms"] = {k: [r[k + "_ms"] for r in ab["this"]] for k in AB_K8}
                row["ab_parent_ms"] = {k: [r[k + "_ms"] for r in ab["parent"]] for k in AB_K8}
        if row["name"] == "compact":
            # every bag count of the main paths in both dtypes (device_ms and
            # share: torch.profiler's device time, the order kernel included),
            # the TCGA shape, and selection's breakdown (dbg_select)
            row.update({k: v for k, v in k1.items() if k.startswith(("k5_", "tcga"))})
            row.update({"device_ms": k1["device_ms"], "shapes": k1["shapes"],
                        "dbg_select_ms": sel})
            if ab:  # timed in turns beside the parent's: ms and device ms per side run
                keys = [k[:-3] for k in ab["this"][0] if k.startswith("compact_")
                        and k.endswith("_ms")]
                for side in ("this", "parent"):
                    row[f"ab{'_parent' if side == 'parent' else ''}_ms"] = {
                        k: [r[k + "_ms"] for r in ab[side]] for k in keys}
                    row[f"ab{'_parent' if side == 'parent' else ''}_device_ms"] = {
                        k: [sum(ms for _, ms in r[k + "_split"]) for r in ab[side]]
                        for k in keys}
        if row["name"].startswith("ntxent"):
            r = k4f if row["name"] == "ntxent_fwd" else k4b
            row.update({k: r[k] for k in ("device_ms", "plain_device_ms", "autograd_ms",
                                          "autograd_plain_ms")})
            row["modes"] = (f"{', '.join(f'({b}, {d})' for b, d in NTXENT_SHAPES)} x 2 f32, with "
                            f"and without a zero row; timed at ({BATCH}, 128)")
    kernels += ablation_rows(abl) + compaction_rows(cprobe)
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab-side"]:
        print(json.dumps(ab_side(sys.argv[2], json.loads(sys.argv[3]), sys.argv[4])))
        sys.exit(0)
    sys.exit(main())
