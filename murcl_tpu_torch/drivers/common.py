"""Driver plumbing (counterpart of ``murcl_tpu/drivers/common.py``): the
reference save-dir schemes, the per-epoch batch order, epoch metrics, the
policy loading both drivers share, the TensorBoard writer
(``--use_tensorboard``), the profiler hook (``--profile N``), and the
data-parallel rank count (``--dp_devices``, :func:`dp_world`) with each rank's
generator (:func:`rank_generator`)."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from murcl_tpu_torch.engine.checkpoint import transfer_state
from murcl_tpu_torch.ops.metrics import get_metrics
from murcl_tpu_torch.parallel import Ranks
from murcl_tpu_torch.utils.general import CSVWriter, increment_path
from murcl_tpu_torch.utils.trace import host_waits, reset_host_waits


def murcl_save_dir(args) -> str:
    """MuRCL pretraining run dir (``train_MuRCL.py:18-55`` of the reference)."""
    murcl = (f"T{args.T}_pd{args.projection_dim}_as{args.action_std}_pg{args.ppo_gamma}"
             f"_tau{args.temperature}_alpha{args.alpha}")
    if args.arch == "ABMIL":
        arch_setting = f"L{args.model_dim}_D{args.D}_dpt{args.dropout}"
    elif args.arch == "CLAM_SB":
        arch_setting = f"size_{args.size_arg}_ks_{args.k_sample}"
    else:
        raise ValueError(args.arch)
    exp = "exp" if args.save_dir_flag is None else f"exp_{args.save_dir_flag}"
    return str(
        Path(args.base_save_dir) / f"{args.dataset}_np_{args.feat_size}" / "MuRCL" / murcl
        / args.arch / arch_setting / exp / f"seed{args.seed}" / f"stage_{args.train_stage}")


def rlmil_save_dir(args) -> str:
    """Downstream RLMIL run dir (``train_RLMIL.py:20-57`` of the reference)."""
    rl = (f"T{args.T}_as{args.action_std}_pg{args.ppo_gamma}_phd{args.policy_hidden_dim}"
          f"_fhd{args.fc_hidden_dim}")
    if args.arch == "ABMIL":
        arch_setting = f"L{args.L}_D{args.D}_dpt{args.dropout}"
    elif args.arch == "DSMIL":
        arch_setting = "default"
    elif args.arch == "CLAM_SB":
        arch_setting = f"size_{args.size_arg}_ks_{args.k_sample}_bw_{args.bag_weight}"
    else:
        raise ValueError(args.arch)
    exp = "exp" if args.save_dir_flag is None else f"exp_{args.save_dir_flag}"
    return str(
        Path(args.base_save_dir) / f"{args.dataset}_np_{args.feat_size}" / "RLMIL" / rl
        / args.arch / arch_setting / args.train_method / exp / f"seed{args.seed}"
        / f"stage_{args.train_stage}")


def resolve_save_dir(args, scheme) -> str:
    """Set ``args.save_dir`` to the run's directory and create it: the
    reference scheme ``scheme(args)``, or ``--save_dir`` under
    ``--base_save_dir``, incremented (``_2``, ...) unless ``--exist_ok``.
    Under data parallelism the launching process resolves it once, before
    the ranks start."""
    if args.save_dir is None:
        args.save_dir = scheme(args)
    else:
        args.save_dir = str(Path(args.base_save_dir) / args.save_dir)
    args.save_dir = increment_path(Path(args.save_dir), exist_ok=args.exist_ok, sep="_")
    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    print(f"save_dir: {args.save_dir}")
    return args.save_dir


def dp_world(args) -> int:
    """The data-parallel rank count of ``--dp_devices`` (0 and 1: one
    process), the counterpart of ``dp_mesh``: the global ``--batch_size``
    splits into equal rows per rank, so it must be a multiple of the count.
    Unlike ``dp_mesh``, the count may exceed the cards
    (:func:`~murcl_tpu_torch.parallel.rank_devices`)."""
    n = int(getattr(args, "dp_devices", 0) or 0)
    if n <= 1:
        return 1
    if args.batch_size % n:
        raise ValueError(f"--batch_size {args.batch_size} must be divisible by --dp_devices "
                         f"{n} (each rank takes an equal share of the batch)")
    return n


def rank_generator(seed: int, dp: Ranks) -> torch.Generator:
    """The CPU generator of rank ``dp.rank``'s draws (actions, mixup, dropout
    seeds, policy noise). A single process seeds it with ``seed``; rank r of
    N > 1 with the first 64-bit word of ``numpy.random.SeedSequence([seed,
    r])``, so ranks draw apart as JAX's ``fold_in(rng, shard)`` streams do."""
    if dp.world == 1:
        return torch.Generator().manual_seed(seed)
    word = np.random.SeedSequence([seed, dp.rank]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(word))


class _NoWriter:
    def write_row(self, row) -> None:
        pass


def rank0_csv(dp: Ranks, filename, header):
    """A :class:`CSVWriter` on rank 0; on the other ranks one that writes nothing."""
    return CSVWriter(filename, header=header) if dp.main else _NoWriter()


def make_tb_writer(save_dir, enabled: bool):
    """A ``torch.utils.tensorboard`` writer into ``save_dir`` for
    ``--use_tensorboard``; where it cannot be imported, a notice that the
    logging is off, and None (``murcl_tpu/drivers/common.py:111-121``)."""
    if not enabled:
        return None
    try:
        from torch.utils.tensorboard import SummaryWriter

        return SummaryWriter(str(save_dir))
    except Exception as e:  # tensorboard not installed, or its import fails
        print(f"tensorboard unavailable ({type(e).__name__}: {e}); logging disabled")
        return None


class ProfilerHook:
    """``torch.profiler`` over the first ``num_steps`` steps of the run
    (``--profile N``; the JAX drivers' ``jax.profiler`` hook): host activity,
    and the card's kernels when ``device`` is CUDA. Call :meth:`step` before
    each step and :meth:`close` at the end; the trace goes to
    ``<dir>/steps_1-N.pt.trace.json`` (Chrome's trace format, which
    TensorBoard's profiler plugin and Perfetto read), with the program's
    spans (``murcl.*``) in it, and the steps' host waits by span and
    ``file:line`` (:func:`~murcl_tpu_torch.utils.trace.host_waits`, counted
    on the card only) to ``<dir>/host_waits.json``."""

    def __init__(self, save_dir, num_steps: int = 0, device=None):
        self.dir = Path(save_dir)
        self.num_steps = self.remaining = int(num_steps or 0)
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._prof = None
        self.trace_path = None

    def step(self) -> None:
        if self.remaining > 0 and self._prof is None:
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            self._prof = profile(activities=activities)
            reset_host_waits()
            self._prof.start()
        elif self.remaining == 0 and self._prof is not None:
            self._stop()
        if self.remaining > 0:
            self.remaining -= 1

    def _stop(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.stop()
        self.dir.mkdir(parents=True, exist_ok=True)
        steps = self.num_steps - self.remaining
        self.trace_path = self.dir / f"steps_1-{steps}.pt.trace.json"
        self._prof.export_chrome_trace(str(self.trace_path))
        self._prof = None
        waits = sorted(host_waits().items(), key=lambda kv: -kv[1])
        with open(self.dir / "host_waits.json", "w", encoding="utf-8") as fp:
            json.dump({"steps": steps, "waits": [{"span": span, "site": site, "count": n}
                                                 for (span, site), n in waits]}, fp, indent=1)

    def close(self) -> None:
        if self._prof is not None:
            self._stop()


def refuse_cascaded_head(args) -> None:
    """The cascaded-FC head (``fc_rnn`` false, :class:`~murcl_tpu_torch.models.FullLayer`)
    gives no logit at the restart step; both packages' engines need one at
    every step (``murcl_tpu/engine/contrastive.py:266-271``,
    ``murcl_tpu/engine/supervised.py:324-333``)."""
    if not args.fc_rnn:
        raise ValueError("the cascaded-FC head (fc_rnn false) gives no logit at the restart "
                         "step, and the engines (the JAX package's too) need a logit at "
                         "every step")


def load_policy(ppo, state_dict) -> None:
    """Load ``state_dict`` into the PPO's policy by :func:`transfer_state`,
    then copy it into ``policy_old``."""
    transfer_state(ppo.policy, state_dict)
    ppo.policy_old.load_state_dict(ppo.policy.state_dict())


def epoch_batches(num_slides: int, num_data: int, batch_size: int, rng: np.random.Generator,
                  drop_partial: bool) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Yield ``(slide_ids (B,), valid (B,))`` per batch of one epoch: one
    shuffled order consumed ``num_data`` times with wraparound. MuRCL fires
    only on full batches (``drop_partial=True``); RLMIL also fires the last
    partial batch, padded to ``batch_size`` with its last id and a ``valid``
    mask."""
    order = rng.permutation(num_slides)
    seq = order[np.arange(num_data) % num_slides]
    n_full = num_data // batch_size
    for i in range(n_full):
        yield seq[i * batch_size:(i + 1) * batch_size].astype(np.int64), \
            np.ones(batch_size, dtype=bool)
    rem = num_data - n_full * batch_size
    if rem and not drop_partial:
        tail = seq[n_full * batch_size:]
        pad = np.full(batch_size - rem, tail[-1])
        yield np.concatenate([tail, pad]).astype(np.int64), np.arange(batch_size) < rem


class EpochOutputs:
    """Final-step logits and labels of an epoch's batches, for its metrics."""

    def __init__(self):
        self.logits: List[np.ndarray] = []
        self.labels: List[np.ndarray] = []

    def update(self, logits, labels, valid: Optional[np.ndarray] = None) -> None:
        logits, labels = np.asarray(logits), np.asarray(labels)
        if valid is not None:
            logits, labels = logits[valid], labels[valid]
        self.logits.append(logits)
        self.labels.append(labels)

    def metrics(self):
        logits, labels = np.concatenate(self.logits), np.concatenate(self.labels)
        return get_metrics(logits, labels), logits, labels
