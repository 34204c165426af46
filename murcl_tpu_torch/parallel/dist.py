"""Data-parallel training over ``torch.distributed`` (counterpart of
``murcl_tpu/parallel/mesh.py`` and of the engines' ``mesh=`` mode).

The JAX package shards the batch axis over a ``('data',)`` mesh and runs each
step as a per-shard ``shard_map`` program. The port runs one process per
shard, a *rank*, with the same global-batch semantics:

- parameters, optimizer state and the feature bank are replicated: every rank
  builds the same engine and loads the whole bank, and :meth:`Ranks.broadcast`
  copies rank 0's weights to the others after init or a checkpoint load;
- rank ``r`` of ``N`` takes rows ``[r*b, (r+1)*b)`` of each global batch of
  ``N*b`` slides (:meth:`Ranks.rows`), as ``P("data")`` does;
- the loss's batch reductions are global (:meth:`Ranks.all_sum`), NT-Xent runs
  over the gathered projections (:meth:`Ranks.gather`), the reported stats are
  global means (:meth:`Ranks.mean`), and the gradients are summed
  (:meth:`Ranks.all_reduce_grads`) before the optimizer step, which every rank
  then takes on the same numbers.

The gradients' route: each rank's autograd reaches only its own rows.
``gather``'s backward hands a rank the cotangent of its own slice, and
``all_sum``'s backward passes the gradient through as if the other ranks'
terms were constants. The loss is the same number on every rank, so rank r's
gradient is the part of the global-batch gradient that flows through its
rows, and the SUM over the ranks is the whole of it. (JAX takes the other
route: the gather's transpose hands each shard the sum of all shards'
cotangents, N times its own contribution, and the engines ``pmean``.) No
collective runs in a backward pass, so the ranks' collectives stay in one
order.

:func:`launch` starts ``N`` rank processes by the ``spawn`` start method (never
``fork``: the caller may have initialised CUDA), meets them at a ``file://``
rendezvous in the run's directory, gives every collective an explicit
timeout, and hands back each rank's return value with its kernel launch
counts, or re-raises the first rank failure it sees after stopping the other
ranks.

:func:`rank_devices` is the device and backend rule: rank r runs on
``cuda:(r % cards)``, as ``data_mesh(n)`` takes the first n devices. The
backend is ``nccl`` when each rank has a card of its own and ``gloo`` when
ranks share a card (NCCL refuses two ranks on one device) or run on the CPU.
Unlike JAX's ``dp_mesh``, N may exceed the cards: ranks that share a card
still compute on it, and only their collectives pass through the host.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pickle
import queue
import sys
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from murcl_tpu_torch.ops import _cuda

RENDEZVOUS = ".dp_rendezvous"  # the file store's name in the run's directory
TIMEOUT_S = 600.0  # a collective waiting longer than this fails the run


class _Gather(torch.autograd.Function):
    """Rows of every rank in rank order: an all-reduce of a zero-filled
    ``(world*b, ...)`` buffer holding this rank's rows in its slice (exact,
    as x + 0 = x, and on CUDA tensors under gloo too). Backward: this rank's
    slice of the cotangent."""

    @staticmethod
    def forward(ctx, x, rank: int, world: int):
        b = x.shape[0]
        out = x.new_zeros((world * b, *x.shape[1:]))
        out[rank * b:(rank + 1) * b] = x
        dist.all_reduce(out)
        ctx.rows = (rank * b, (rank + 1) * b)
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None


class _AllSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is this rank's alone."""

    @staticmethod
    def forward(ctx, x):
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad


class Ranks:
    """This process's place among ``world`` data-parallel ranks, and the
    collectives the engines call. With ``world == 1`` (:data:`SINGLE`, the
    single-process run) every collective returns its input."""

    def __init__(self, rank: int = 0, world: int = 1, device=None):
        self.rank = rank
        self.world = world
        self.device = torch.device(device) if device is not None else None

    @property
    def main(self) -> bool:
        """Rank 0: the one that writes the run's files and prints."""
        return self.rank == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n`` (a multiple of world)."""
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def local(self, x):
        """This rank's rows of ``x``."""
        return x[self.rows(len(x))]

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order
        (autograd: this rank's slice of the cotangent)."""
        if self.world == 1:
            return x
        if dim:
            return self.gather(x.movedim(dim, 0)).movedim(0, dim)
        return _Gather.apply(x, self.rank, self.world)

    def all_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, its gradient this rank's part."""
        return x if self.world == 1 else _AllSum.apply(x)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks, without gradient."""
        if self.world == 1:
            return x
        out = x.detach().clone()
        dist.all_reduce(out)
        return out

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean of ``x`` over the ranks, without gradient (equal shards:
        the mean of per-rank batch means is the global batch mean)."""
        return x if self.world == 1 else self.sum(x) / self.world

    def all_reduce_grads(self, params) -> int:
        """Sum the gradients of ``params`` (each must have one) over the
        ranks, as one flat buffer per dtype; returns the bytes reduced."""
        if self.world == 1:
            return 0
        grads = [p.grad for p in params]
        nbytes = 0
        for dtype in dict.fromkeys(g.dtype for g in grads):
            group = [g for g in grads if g.dtype == dtype]
            flat = torch.cat([g.reshape(-1) for g in group])
            dist.all_reduce(flat)
            offset = 0
            for g in group:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()
            nbytes += flat.numel() * flat.element_size()
        return nbytes

    def broadcast(self, *modules: torch.nn.Module) -> None:
        """Copy rank 0's parameters and buffers of ``modules`` to every rank."""
        if self.world == 1:
            return
        for module in modules:
            for t in module.state_dict().values():
                dist.broadcast(t, 0)


SINGLE = Ranks()


def rank_devices(world: int, device) -> Tuple[List[torch.device], str]:
    """``(device of each rank, backend)`` for ``world`` ranks on ``device``
    (``cpu``, or any CUDA device: the ranks take the first cards)."""
    device = torch.device(device)
    if device.type == "cpu":
        return [device] * world, "gloo"
    cards = torch.cuda.device_count()
    if cards == 0:
        raise RuntimeError(f"{world} data-parallel ranks on {device}: no CUDA device")
    devices = [torch.device(f"cuda:{r % cards}") for r in range(world)]
    return devices, ("nccl" if cards >= world else "gloo")


def _picklable(error: BaseException) -> BaseException:
    try:
        return pickle.loads(pickle.dumps(error))
    except Exception:  # an exception type that does not pickle
        return RuntimeError(f"{type(error).__name__}: {error}")


def _rank_main(fn, args, rank, world, device, backend, init, results) -> None:
    """One rank: join the group, run ``fn(Ranks, *args)``, post the result
    (or the error, before leaving the group, which may wait on the others)."""
    if rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 prints the run's lines
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:  # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // world))
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=timedelta(seconds=TIMEOUT_S))
        value = fn(Ranks(rank, world, dev), *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # pickled to bytes here: torch would pass the tensors' storage as file
        # descriptors of this process, which may be gone when they are read
        results.put((rank, True, pickle.dumps((value, dict(_cuda.LAUNCHES)))))
    except BaseException as e:
        results.put((rank, False, pickle.dumps((_picklable(e), traceback.format_exc()))))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _collect(procs, results, world: int) -> list:
    """Each rank's payload in rank order; re-raises a rank's exception, and
    raises if a rank dies without posting one."""
    done = {}
    while len(done) < world:
        try:
            rank, ok, payload = results.get(timeout=1.0)
        except queue.Empty:
            dead = [(r, p.exitcode) for r, p in enumerate(procs)
                    if r not in done and p.exitcode is not None]
            if not dead:
                continue
            try:  # a rank's last message may still be in the pipe
                rank, ok, payload = results.get(timeout=5.0)
            except queue.Empty:
                r, code = dead[0]
                raise RuntimeError(f"data-parallel rank {r} exited with code {code} "
                                   "and no result") from None
        payload = pickle.loads(payload)  # what _rank_main pickled
        if not ok:
            error, tb = payload
            raise error from RuntimeError(f"data-parallel rank {rank} failed:\n{tb}")
        done[rank] = payload
    return [done[r] for r in range(world)]


def launch(world: int, fn: Callable, *args, device="cpu",
           run_dir) -> List[Tuple[object, dict]]:
    """Run ``fn(ranks, *args)`` in ``world`` spawned rank processes.

    ``fn`` and ``args`` are pickled (``fn`` by its import path). Returns, per
    rank, ``(fn's return value, that rank's kernel launch counts)``. If a
    rank raises, the others are stopped and its exception is re-raised here,
    chained to the rank's traceback. On CUDA the kernel library is built
    here first, so the ranks load it and none compiles.
    """
    devices, backend = rank_devices(world, device)
    shared = " (ranks share a card)" if backend == "gloo" and devices[0].type == "cuda" else ""
    print(f"data parallel: {world} ranks over {backend}{shared}: "
          + ", ".join(f"rank {r} on {d}" for r, d in enumerate(devices)), flush=True)
    if devices[0].type == "cuda":
        _cuda.build()
    store = Path(run_dir).resolve() / RENDEZVOUS
    store.unlink(missing_ok=True)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, name=f"dp-rank-{r}",
                         args=(fn, args, r, world, str(devices[r]), backend, f"file://{store}",
                               results))
             for r in range(world)]
    finished = False
    try:
        for p in procs:
            p.start()
        out = _collect(procs, results, world)
        finished = True
        return out
    finally:
        for p in procs:  # after a failure, the other ranks may wait in a collective
            if finished:
                p.join(timeout=60.0)
            if p.is_alive():
                p.terminate()
                p.join()
        store.unlink(missing_ok=True)
