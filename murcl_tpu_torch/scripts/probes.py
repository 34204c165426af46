"""What the ports of the JAX package's TPU probes share (``dbg_bwd_ablate``,
``dbg_vpu_lean``, ``dbg_mxu_vpu_overlap``): the device rule, the timer and
the trunk probes' inputs.

Each probe runs on ``cuda:0`` unless told otherwise; with ``--device cpu`` it
runs the kernels' plain twins at the size the caller gives, timed by the
host's clock (a CPU time, no device number). A CUDA device that is not there
is an error: no probe falls back to the CPU.
"""

from __future__ import annotations

import statistics
import time

import torch


def probe_device(device: str) -> torch.device:
    """``device`` as a torch device; raises where it names a card this
    machine does not have."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: no CUDA device here (the probes time the card's "
                           "kernels; --device cpu runs their plain twins)")
    return dev


def where(dev: torch.device) -> str:
    """The line's note of what timed it: the card's name, or the CPU's clock."""
    if dev.type == "cuda":
        return f"{torch.cuda.get_device_name(dev)}, CUDA events"
    return "CPU, plain twins, host clock"


def median_ms(fn, dev: torch.device, reps: int = 5):
    """``(ms, out)``: ms of one call of ``fn``, the median of ``reps`` calls
    after one warm-up, each between two CUDA events on a card, by the host's
    clock on the CPU; ``out`` what the last timed call returned (a probe's
    outputs at the size it was timed, for a check against its twin)."""
    out = fn()
    times = []
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            out = fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def trunk_inputs(shape, dtype, dev, seed: int = 0):
    """The JAX trunk probes' operands (``scripts/dbg_bwd_ablate.py`` and
    ``dbg_vpu_lean.py``), drawn on ``dev`` from ``seed``: bags ``h (B, N,
    Fin)`` of normals times 0.3 in ``dtype``, weights of normals times 0.05
    (``wc`` a vector), zero biases, every row live, ``p = 1 / N``, the
    pooled output's cotangent ``gm`` of normals times 0.1 and zero
    cotangents for ``p`` and ``s``. Returns ``(h, w, mask, p, cots)``, ``w``
    the eight weights of ``fused_trunk_attention_pool`` and ``cots`` ``(gm,
    gp, gs)``."""
    b, n, fin, l1, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    f32 = dict(device=dev, dtype=torch.float32)

    def r(*size, sc):
        return torch.randn(*size, generator=gen, **f32) * sc

    h = r(b, n, fin, sc=0.3).to(dtype)
    w = [r(fin, l1, sc=0.05), torch.zeros(l1, **f32), r(l1, d, sc=0.05), torch.zeros(d, **f32),
         r(l1, d, sc=0.05), torch.zeros(d, **f32), r(d, sc=0.05), torch.zeros((), **f32)]
    mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    p = torch.full((b, n), 1.0 / n, **f32)
    cots = (r(b, l1, sc=0.1), torch.zeros(b, n, **f32), torch.zeros(b, n, **f32))
    return h, w, mask, p, cots
