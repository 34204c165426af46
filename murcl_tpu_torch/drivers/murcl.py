"""MuRCL pretraining driver, stages 1 -> 2 -> 3 (counterpart of ``murcl_tpu/drivers/murcl.py:51-261``).

Stage 1 warms the aggregator (``--arch CLAM_SB`` or ``ABMIL``) and the GRU
projection head on random sub-bags of the train split; stage 2 trains the
PPO policy against the frozen aggregator for ``--ppo_epochs`` epochs, with
no aggregator optimizer and no LR schedule; stage 3 fine-tunes aggregator
and head under the fixed policy. Stage N >= 2 loads aggregator and head from
``<save_dir>/../stage_{N-1}/model_best.pth.tar`` unless ``--checkpoint``
names another file, and stage 3 also its policy (into ``policy`` and
``policy_old``). Best = minimum train loss; a checkpoint is written every
epoch (with the policy and the PPO optimizer at stages 2 and 3) with a
``model_best`` copy. The per-epoch loss is the mean over steps of each
step's last NT-Xent loss, as in the reference.

``--streaming`` keeps the split on the host and stages each batch's slides
onto the device on a prefetch thread (:mod:`murcl_tpu_torch.data.streaming`);
the steps are bitwise those over the resident bank.

``--device cpu`` runs the plain PyTorch path; any other device is a CUDA
device, which runs the hand-written kernels. Without a CUDA device only
``--device cpu`` runs. ``--dp_devices > 1`` raises ``NotImplementedError``
naming its ROADMAP item; the cascaded-FC head (``fc_rnn`` false) raises
``ValueError``, as no engine runs it.
"""

from __future__ import annotations

import contextlib
import json
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from murcl_tpu_torch.data.contract import load_split
from murcl_tpu_torch.data.sources import build_sources
from murcl_tpu_torch.drivers.common import (ProfilerHook, epoch_batches, load_policy,
                                           make_tb_writer, murcl_save_dir,
                                           refuse_cascaded_head)
from murcl_tpu_torch.engine.checkpoint import (JAX_FORMAT, load_checkpoint, save_checkpoint,
                                               transfer_state)
from murcl_tpu_torch.engine.config import PretrainConfig
from murcl_tpu_torch.engine.contrastive import ContrastiveEngine
from murcl_tpu_torch.engine.optim import (lr_schedule_factory, make_optimizer,
                                          set_learning_rates)
from murcl_tpu_torch.models import CL, PPO, FullLayer, build_aggregator
from murcl_tpu_torch.utils.general import (AverageMeter, BestVariable, CSVWriter, EarlyStop,
                                           increment_path, init_seeds)


def resolve_device(spec) -> torch.device:
    """``cpu`` -> the CPU path; ``N`` or ``cuda:N`` -> CUDA device N."""
    spec = str(spec)
    if spec == "cpu":
        return torch.device("cpu")
    index = spec[len("cuda:"):] if spec.startswith("cuda:") else spec
    if not index.isdigit():
        raise ValueError(f"--device must be 'cpu', N or 'cuda:N', got {spec!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {spec} needs a CUDA device and none is available "
                           "(--device cpu runs the plain CPU path)")
    return torch.device(f"cuda:{index}")


def _reject_unported(args) -> None:
    if int(args.dp_devices or 0) > 1:
        raise NotImplementedError("not ported yet: --dp_devices > 1: ROADMAP queue 1, item 14")


def _arch_setting(args) -> dict:
    """``murcl_tpu/drivers/murcl.py:51-65`` without the TPU gate-math knob."""
    if args.arch == "ABMIL":
        # MuRCL sizes ABMIL with L=model_dim and a projection-dim head
        return {"L": args.model_dim, "D": args.D, "dropout": args.dropout,
                "dim_out": args.projection_dim}
    if args.arch == "CLAM_SB":
        # gate/dropout(0.25)/subtyping are hardcoded in the reference
        return {"gate": True, "size_arg": args.size_arg, "dropout": 0.25,
                "k_sample": args.k_sample, "subtyping": True}
    raise ValueError(args.arch)


def setup(args) -> SimpleNamespace:
    """Source, modules, optimizer, policy, engine and the stage chaining of
    one stage: ``SimpleNamespace(device, source, model, fc, ppo, optimizer,
    engine, start_epoch)``. Creates ``args.save_dir`` and fills the derived
    args."""
    _reject_unported(args)
    refuse_cascaded_head(args)
    device = resolve_device(args.device)
    init_seeds(args.seed)

    if args.save_dir is None:
        args.save_dir = murcl_save_dir(args)
    else:
        args.save_dir = str(Path(args.base_save_dir) / args.save_dir)
    args.save_dir = increment_path(Path(args.save_dir), exist_ok=args.exist_ok, sep="_")
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    print(f"save_dir: {save_dir}")

    indices = load_split(args.data_split_json)["train"]
    cdtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    source = build_sources(args.data_csv, {"train": indices}, streaming=args.streaming,
                           device=device, dtype=cdtype)["train"]
    args.num_clusters = source.num_clusters
    args.num_data = source.num_slides * args.data_repeat
    args.eval_step = int(args.num_data / args.batch_size)
    print(f"train_length: {source.num_slides}, epoch_step: {args.num_data}, "
          f"eval_step: {args.eval_step}")

    encoder, feature_num = build_aggregator(args.arch, dim_in=source.patch_dim,
                                            num_classes=args.projection_dim,
                                            arch_setting=_arch_setting(args))
    model = CL(encoder, projection_dim=args.projection_dim).to(device)
    fc = FullLayer(feature_num=feature_num, hidden_state_dim=args.fc_hidden_dim,
                   fc_rnn=args.fc_rnn, class_num=args.projection_dim).to(device)
    ppo = None
    if args.train_stage != 1:
        ppo = PPO(state_dim=feature_num, hidden_state_dim=args.policy_hidden_dim,
                  policy_conv=args.policy_conv, action_std=args.action_std, lr=args.ppo_lr,
                  gamma=args.ppo_gamma, K_epochs=args.K_epochs,
                  action_size=args.num_clusters).to(device)
    optimizer = None
    if args.train_stage == 2:
        args.epochs = args.ppo_epochs
    else:
        optimizer = make_optimizer(model, fc, optimizer=args.optimizer,
                                   backbone_lr=args.backbone_lr, fc_lr=args.fc_lr,
                                   beta1=args.beta1, beta2=args.beta2, momentum=args.momentum,
                                   nesterov=args.nesterov, wdecay=args.wdecay)

    # stage chaining (murcl_tpu/drivers/murcl.py:146-159)
    if args.train_stage >= 2:
        if args.checkpoint is None:
            args.checkpoint = str(save_dir.parent / f"stage_{args.train_stage - 1}"
                                  / "model_best.pth.tar")
        if not Path(args.checkpoint).exists():
            raise FileNotFoundError(f"{args.checkpoint} does not exist!")
        ckpt = load_checkpoint(args.checkpoint, map_location=device)
        transfer_state(model.encoder, ckpt["model_state_dict"])
        transfer_state(fc, ckpt["fc"])
        if args.train_stage == 3 and ckpt.get("policy") is not None:
            load_policy(ppo, ckpt["policy"])

    start_epoch = 0
    resume_path = save_dir / "checkpoint.pth.tar"
    if args.resume and resume_path.exists():
        ckpt = load_checkpoint(resume_path, map_location=device)
        if ckpt.get("format") == JAX_FORMAT:
            # a JAX run's file: the bare aggregator tree, and no optimizer
            # state that torch.optim can take
            transfer_state(model.encoder, ckpt["model_state_dict"])
            print(f"resume: {resume_path} is a JAX checkpoint; the optimizer's and the "
                  "PPO optimizer's states start fresh")
        else:
            model.load_state_dict(ckpt["model_state_dict"])
        fc.load_state_dict(ckpt["fc"])
        if optimizer is not None and ckpt.get("optimizer") is not None:
            optimizer.load_state_dict(ckpt["optimizer"])
        if ppo is not None and ckpt.get("policy") is not None:
            ppo.load_policy(ckpt["policy"])
            if ckpt.get("ppo_optimizer") is not None:
                ppo.optimizer.load_state_dict(ckpt["ppo_optimizer"])
        start_epoch = int(ckpt["epoch"])
        print(f"resumed from {resume_path} at epoch {start_epoch}")

    cfg = PretrainConfig(arch=args.arch, T=args.T, feat_size=args.feat_size,
                         num_clusters=args.num_clusters, train_stage=args.train_stage,
                         num_classes=args.projection_dim, alpha=args.alpha,
                         temperature=args.temperature, compute_dtype=args.compute_dtype)
    engine = ContrastiveEngine(cfg, model, fc, optimizer, ppo=ppo)
    return SimpleNamespace(device=device, source=source, model=model, fc=fc, ppo=ppo,
                           optimizer=optimizer, engine=engine, start_epoch=start_epoch)


def run(args) -> dict:
    s = setup(args)
    save_dir = Path(args.save_dir)
    with open(save_dir / "args.json", "w", encoding="utf-8") as fp:
        json.dump(vars(args), fp, indent=1, default=str)

    best_train_loss = BestVariable(order="min")
    losses_csv = CSVWriter(save_dir / "losses.csv",
                           header=["epoch", "train", "best_epoch", "best_train"])
    results_csv = CSVWriter(save_dir / "results.csv",
                            header=["epoch", "final_epoch", "final_loss"])
    early_stop = EarlyStop(args.patience) if args.patience is not None else None
    np_rng = np.random.default_rng(args.seed)
    generator = torch.Generator().manual_seed(args.seed)
    backbone_lr_fn = lr_schedule_factory(args.scheduler, args.backbone_lr, args.epochs,
                                         int(args.warmup))
    fc_lr_fn = lr_schedule_factory(args.scheduler, args.fc_lr, args.epochs, int(args.warmup))
    with contextlib.ExitStack() as stack:
        tb_writer = make_tb_writer(save_dir, args.use_tensorboard)
        if tb_writer is not None:
            stack.callback(tb_writer.close)
        profiler = ProfilerHook(save_dir / "profile", args.profile, s.device)
        stack.callback(profiler.close)
        steps_per_sec = None
        for epoch in range(s.start_epoch, args.epochs):
            t0 = time.time()
            if s.optimizer is not None:  # stage 2 has no aggregator optimizer
                set_learning_rates(s.optimizer, backbone_lr_fn(epoch), fc_lr_fn(epoch))
            loss_meter = AverageMeter()
            # per-step losses stay on the device until the epoch ends (no sync per step)
            step_losses, step_counts = [], []
            batches = [ids for ids, _ in epoch_batches(s.source.num_slides, args.num_data,
                                                       args.batch_size, np_rng,
                                                       drop_partial=True)]
            for bank, slide_ids in s.source.iter_batches(batches):
                profiler.step()
                stats = s.engine.train_step(bank, slide_ids, generator)
                step_losses.append(stats.step_losses[-1])
                step_counts.append(len(slide_ids))
            for loss, cnt in zip(step_losses, step_counts):
                loss_meter.update(float(loss), cnt)
            train_loss = loss_meter.avg
            dt = time.time() - t0
            steps_per_sec = len(step_losses) / dt if dt > 0 else None
            if tb_writer is not None:
                tb_writer.add_scalar("train/1.train_loss", train_loss, epoch)

            is_best = best_train_loss.compare(train_loss, epoch + 1, inplace=True)
            save_checkpoint(save_dir, epoch + 1, s.model, s.fc, s.optimizer, s.ppo,
                            is_best=is_best)
            losses_csv.write_row([epoch + 1, train_loss, best_train_loss.epoch,
                                  best_train_loss.best])
            results_csv.write_row([epoch + 1, best_train_loss.epoch, best_train_loss.best])
            print(f"Epoch {epoch + 1}/{args.epochs} [{dt:.1f}s, {steps_per_sec:.3f} steps/s] "
                  f"Loss: {train_loss:.4f}, Best: {best_train_loss.best:.4f} "
                  f"@ {best_train_loss.epoch}")
            if early_stop is not None:
                early_stop.update(best_train_loss.best)
                if early_stop.is_stop():
                    break

    return {
        "save_dir": args.save_dir,
        "best_loss": best_train_loss.best,
        "best_epoch": best_train_loss.epoch,
        "steps_per_sec": steps_per_sec,
    }


def default_args(**overrides) -> SimpleNamespace:
    """Programmatic args with the CLI defaults (``train_MuRCL.py``)."""
    ns = SimpleNamespace(
        dataset="Camelyon16", data_csv="", data_split_json="", preload=False,
        data_repeat=10, feat_size=1024, train_stage=1, T=6, optimizer="Adam",
        scheduler=None, batch_size=128, epochs=100, ppo_epochs=30, backbone_lr=1e-4,
        fc_lr=1e-4, temperature=1.0, momentum=0.9, nesterov=True, beta1=0.9, beta2=0.999,
        warmup=0, wdecay=1e-5, patience=None, checkpoint=None, arch="CLAM_SB", alpha=0.9,
        projection_dim=128, model_dim=512, policy_hidden_dim=512, policy_conv=False,
        action_std=0.5, ppo_lr=1e-5, ppo_gamma=0.1, K_epochs=3, feature_num=512,
        fc_hidden_dim=1024, fc_rnn=True, D=128, dropout=0.0, size_arg="small", k_sample=8,
        use_tensorboard=False, profile=0, base_save_dir="./results", save_dir=None,
        save_dir_flag=None, exist_ok=False, resume=False, device="0", seed=985,
        streaming=False, compute_dtype="float32", dp_devices=0,
    )
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns
