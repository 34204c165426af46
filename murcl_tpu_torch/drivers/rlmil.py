"""Supervised RLMIL driver (counterpart of ``murcl_tpu/drivers/rlmil.py``).

``train_method`` scratch | finetune | linear x ``train_stage`` 1 | 2 | 3 for
``--arch`` ABMIL, CLAM_SB or DSMIL, with the reference's checkpoint chaining
and weight surgery:

- stage 1 (finetune/linear) loads the aggregator from a MuRCL checkpoint
  (``--checkpoint_pretrained``), skipping what does not fit (the projection
  head);
- stages 2 and 3 load aggregator and head from ``../stage_{N-1}/model_best.pth.tar``
  (or ``--checkpoint_stage``). Stage 2 takes its policy from the pretrained
  checkpoint if it has one, stage 3 from the stage-2 checkpoint;
- every checkpoint may also be one the JAX package wrote
  (:func:`~murcl_tpu_torch.engine.checkpoint.load_checkpoint`);
- stage 2 freezes the aggregator and trains the PPO policy for
  ``--ppo_epochs``; stages 1 and 3 train the aggregator and the head.

Every epoch evaluates the valid and test splits, each as one batch; the
model is selected on the valid split by ``--picked_method``, and the final
test runs on the best model. Outputs: ``losses.csv``, ``accs.csv``,
``aucs.csv``, ``results.csv``, ``pred.csv``, ``final_res.csv`` (written with
:mod:`csv`) and ``args.json``; checkpoints with ``--save_model``.

``--streaming`` keeps each split on the host and stages each batch's slides
onto the device (:mod:`murcl_tpu_torch.data.streaming`); an evaluation
stages its whole split as one batch, as the JAX driver does.

``--device cpu`` runs the plain PyTorch path; a CUDA device runs the
hand-written kernels. ``--dp_devices > 1`` raises ``NotImplementedError``
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
from murcl_tpu_torch.drivers.common import (EpochOutputs, ProfilerHook, epoch_batches,
                                           load_policy, make_tb_writer, refuse_cascaded_head,
                                           rlmil_save_dir)
from murcl_tpu_torch.drivers.murcl import resolve_device
from murcl_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint, transfer_state
from murcl_tpu_torch.engine.config import RolloutConfig
from murcl_tpu_torch.engine.optim import (freeze_for_linear_eval, lr_schedule_factory,
                                          make_optimizer, set_learning_rates)
from murcl_tpu_torch.engine.supervised import SupervisedEngine
from murcl_tpu_torch.models import PPO, FullLayer, build_aggregator
from murcl_tpu_torch.ops.metrics import get_metrics, get_score
from murcl_tpu_torch.utils.general import (BestVariable, CSVWriter, EarlyStop, increment_path,
                                           init_seeds)


def _reject_unported(args) -> None:
    if int(args.dp_devices or 0) > 1:
        raise NotImplementedError("not ported yet: --dp_devices > 1: ROADMAP queue 1, item 14")


def _load_stage_checkpoint(args, model, fc, device) -> dict:
    """Stage chaining (``train_RLMIL.py:147-232``): aggregator and head from
    the previous stage's best checkpoint."""
    if args.checkpoint_stage is None:
        args.checkpoint_stage = str(Path(args.save_dir).parent
                                    / f"stage_{args.train_stage - 1}" / "model_best.pth.tar")
    if not Path(args.checkpoint_stage).exists():
        raise FileNotFoundError(f"{args.checkpoint_stage} does not exist!")
    ckpt = load_checkpoint(args.checkpoint_stage, map_location=device)
    transfer_state(model, ckpt["model_state_dict"])
    transfer_state(fc, ckpt["fc"])
    return ckpt


def _pretrained(args, device) -> dict:
    if not (args.checkpoint_pretrained and Path(args.checkpoint_pretrained).exists()):
        raise FileNotFoundError(f"{args.checkpoint_pretrained} does not exist!")
    return load_checkpoint(args.checkpoint_pretrained, map_location=device)


def _arch_setting(args) -> dict:
    """``build_aggregator``'s settings (``murcl_tpu/drivers/rlmil.py:80-93``)."""
    if args.arch == "ABMIL":
        return {"L": args.L, "D": args.D, "dropout": args.dropout,
                "dim_out": args.num_classes}
    if args.arch == "CLAM_SB":
        # gate/dropout(0.25)/subtyping are hardcoded in the reference
        # (train_RLMIL.py:104-112)
        return {"gate": True, "size_arg": args.size_arg, "dropout": 0.25,
                "k_sample": args.k_sample, "subtyping": True}
    return {}


def setup(args) -> SimpleNamespace:
    """Sources, modules, optimizer, engine and the weight surgery of one
    stage: ``SimpleNamespace(device, sources, model, fc, ppo, optimizer,
    engine)``. Creates ``args.save_dir`` and fills the derived args."""
    _reject_unported(args)
    refuse_cascaded_head(args)
    device = resolve_device(args.device)
    init_seeds(args.seed)
    if args.save_dir is None:
        args.save_dir = rlmil_save_dir(args)
    else:
        args.save_dir = str(Path(args.base_save_dir) / args.save_dir)
    args.save_dir = increment_path(Path(args.save_dir), exist_ok=args.exist_ok, sep="_")
    Path(args.save_dir).mkdir(parents=True, exist_ok=True)
    print(f"save_dir: {args.save_dir}")

    split = load_split(args.data_split_json)
    cdtype = torch.bfloat16 if args.compute_dtype == "bfloat16" else torch.float32
    sources = build_sources(args.data_csv, {"train": split[args.train_data],
                                            "valid": split["valid"], "test": split["test"]},
                            streaming=args.streaming, device=device, dtype=cdtype)
    train = sources["train"]
    args.num_clusters = train.num_clusters
    args.num_data = train.num_slides
    args.eval_step = max(1, int(args.num_data / args.batch_size))
    print(f"train_length: {train.num_slides}, epoch_step: {args.num_data}, "
          f"eval_step: {args.eval_step}")

    model, args.feature_num = build_aggregator(args.arch, train.patch_dim, args.num_classes,
                                               _arch_setting(args))
    model = model.to(device)
    fc = FullLayer(feature_num=args.feature_num, hidden_state_dim=args.fc_hidden_dim,
                   fc_rnn=args.fc_rnn, class_num=args.num_classes).to(device)
    ppo = None
    if args.train_stage != 1:
        ppo = PPO(state_dim=args.feature_num, hidden_state_dim=args.policy_hidden_dim,
                  policy_conv=args.policy_conv, action_std=args.action_std, lr=args.ppo_lr,
                  gamma=args.ppo_gamma, K_epochs=args.K_epochs,
                  action_size=args.num_clusters).to(device)

    if args.train_method in ("finetune", "linear"):
        if args.train_stage == 1:
            transfer_state(model, _pretrained(args, device)["model_state_dict"])
        else:
            ckpt = _load_stage_checkpoint(args, model, fc, device)
            # stage 2 takes the policy of the pretrained MuRCL run (train_RLMIL.py:155-166)
            source = _pretrained(args, device) if args.train_stage == 2 else ckpt
            if source.get("policy") is not None:
                load_policy(ppo, source["policy"])
    elif args.train_method == "scratch":
        if args.train_stage >= 2:
            ckpt = _load_stage_checkpoint(args, model, fc, device)
            if args.train_stage == 3 and ckpt.get("policy") is not None:
                load_policy(ppo, ckpt["policy"])
    else:
        raise ValueError(args.train_method)

    resume_path = Path(args.save_dir) / "checkpoint.pth.tar"
    if args.resume and resume_path.exists():
        ckpt = load_checkpoint(resume_path, map_location=device)
        transfer_state(model, ckpt["model_state_dict"])
        transfer_state(fc, ckpt["fc"])
        if ppo is not None and ckpt.get("policy") is not None:
            load_policy(ppo, ckpt["policy"])
        print(f"resumed model/fc/policy from {resume_path}")

    optimizer = None
    if args.train_stage == 2:
        args.epochs = args.ppo_epochs
    else:
        if args.train_method == "linear":
            freeze_for_linear_eval(model, args.arch)
        optimizer = make_optimizer(model, fc, optimizer=args.optimizer,
                                   backbone_lr=args.backbone_lr, fc_lr=args.fc_lr,
                                   beta1=args.beta1, beta2=args.beta2, momentum=args.momentum,
                                   nesterov=args.nesterov, wdecay=args.wdecay)
    cfg = RolloutConfig(arch=args.arch, T=args.T, feat_size=args.feat_size,
                        num_clusters=args.num_clusters, train_stage=args.train_stage,
                        num_classes=args.num_classes, bag_weight=args.bag_weight,
                        compute_dtype=args.compute_dtype)
    engine = SupervisedEngine(cfg, model, fc, ppo=ppo, optimizer=optimizer)
    return SimpleNamespace(device=device, sources=sources, model=model, fc=fc, ppo=ppo,
                           optimizer=optimizer, engine=engine)


def _states(s: SimpleNamespace) -> dict:
    """Copies of the weights that model selection keeps."""
    copy = lambda m: {k: v.detach().clone() for k, v in m.state_dict().items()}  # noqa: E731
    return {"model": copy(s.model), "fc": copy(s.fc),
            "policy": copy(s.ppo.policy) if s.ppo is not None else None}


def _evaluate(s: SimpleNamespace, source, generator, collect_preds: bool = False):
    """A whole split as one batch (``train_RLMIL.py:417-424``; a streaming
    split is staged whole): ``(loss, (acc, auc, precision, recall, f1)[, pred
    rows])``."""
    bank, ids = source.batch(np.arange(source.num_slides))
    stats = s.engine.eval_step(bank, ids, generator)
    logits = stats.logits.float().cpu().numpy()
    labels = source.labels
    loss = float(stats.step_losses[-1])
    metrics = get_metrics(logits, labels)
    if not collect_preds:
        return loss, metrics
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs = probs / probs.sum(axis=1, keepdims=True)
    pred = probs.argmax(axis=1)
    rows = [[case_id, int(labels[i]), int(pred[i]), bool(labels[i] == pred[i]),
             *[float(v) for v in probs[i]]] for i, case_id in enumerate(source.case_ids)]
    return loss, metrics, rows


def run(args) -> dict:
    s = setup(args)
    save_dir = Path(args.save_dir)
    with open(save_dir / "args.json", "w", encoding="utf-8") as fp:
        json.dump(vars(args), fp, indent=1, default=str)
    generator = torch.Generator().manual_seed(args.seed)
    with contextlib.ExitStack() as stack:
        tb_writer = make_tb_writer(save_dir, args.use_tensorboard)
        if tb_writer is not None:
            stack.callback(tb_writer.close)
        profiler = ProfilerHook(save_dir / "profile", args.profile, s.device)
        stack.callback(profiler.close)
        result = _train_loop(args, s, generator, tb_writer, profiler)

    # final test on the best model
    best = result["best"]
    s.model.load_state_dict(best["model"])
    s.fc.load_state_dict(best["fc"])
    if s.ppo is not None:
        s.ppo.load_policy(best["policy"])
    loss, metrics, rows = _evaluate(s, s.sources["test"],
                                    torch.Generator().manual_seed(args.seed + 1),
                                    collect_preds=True)
    n_class = len(rows[0]) - 4
    pred_csv = CSVWriter(save_dir / "pred.csv",
                         header=["case_id", "label", "pred", "correct",
                                 *[f"prob{i}" for i in range(n_class)]])
    for row in rows:
        pred_csv.write_row(row)
    final_csv = CSVWriter(save_dir / "final_res.csv",
                          header=["", "loss", "acc", "auc", "precision", "recall", "f1_score"])
    final_csv.write_row([f"seed{args.seed}", loss, *metrics])
    print(f"final test: loss {loss:.4f} acc {metrics[0]:.4f} auc {metrics[1]:.4f}\n"
          "Predicted Ending.\n")
    return {"save_dir": args.save_dir, "final": (loss, *metrics),
            "train_losses": result["train_losses"], "steps_per_sec": result["steps_per_sec"]}


def _train_loop(args, s: SimpleNamespace, generator: torch.Generator, tb_writer=None,
                profiler=None) -> dict:
    save_dir = Path(args.save_dir)
    bests = {f"{split}_{m}": BestVariable(order="min" if m == "loss" else "max")
             for split in ("train", "valid", "test") for m in ("loss", "acc", "auc")}
    best_score = BestVariable(order="max")
    final = dict(epoch=0, loss=0.0, acc=0.0, auc=0.0, precision=0.0, recall=0.0, f1=0.0)
    header = ["epoch", "train", "valid", "test", "best_train", "best_valid", "best_test"]
    writers = {m: CSVWriter(save_dir / f"{name}.csv", header=header)
               for m, name in (("loss", "losses"), ("acc", "accs"), ("auc", "aucs"))}
    results_csv = CSVWriter(save_dir / "results.csv",
                            header=["epoch", "final_epoch", "final_loss", "final_acc",
                                    "final_auc", "final_precision", "final_recall",
                                    "final_f1_score"])
    early_stop = EarlyStop(args.patience) if args.patience is not None else None
    best = _states(s)
    np_rng = np.random.default_rng(args.seed)
    backbone_lr_fn = lr_schedule_factory(args.scheduler, args.backbone_lr, args.epochs,
                                         int(args.warmup))
    fc_lr_fn = lr_schedule_factory(args.scheduler, args.fc_lr, args.epochs, int(args.warmup))
    train = s.sources["train"]
    train_losses, steps_per_sec = [], None

    for epoch in range(args.epochs):
        t0 = time.time()
        if s.optimizer is not None and args.scheduler is not None:
            set_learning_rates(s.optimizer, backbone_lr_fn(epoch), fc_lr_fn(epoch))
        # per-step outputs stay on the device until the epoch ends (no sync per step)
        pending = []
        batches = list(epoch_batches(train.num_slides, args.num_data, args.batch_size, np_rng,
                                     drop_partial=False))
        staged = train.iter_batches([ids for ids, _ in batches])
        for (bank, slide_ids), (ids, valid) in zip(staged, batches):
            if profiler is not None:
                profiler.step()
            stats = s.engine.train_step(bank, slide_ids, generator,
                                        valid=torch.as_tensor(valid, device=s.device))
            pending.append((stats.logits, ids, valid, stats.step_losses[-1]))
        outputs = EpochOutputs()
        for logits, ids, valid, _ in pending:
            outputs.update(logits.float().cpu().numpy(), train.labels[ids], valid)
        train_loss = float(np.mean([float(p[3]) for p in pending]))
        dt = time.time() - t0
        steps_per_sec = len(pending) / dt if dt > 0 else None
        train_losses.append(train_loss)
        (train_acc, train_auc, _, _, _), _, _ = outputs.metrics()

        valid_loss, valid_metrics = _evaluate(s, s.sources["valid"], generator)
        test_loss, test_metrics = _evaluate(s, s.sources["test"], generator)
        valid_acc, valid_auc, valid_p, valid_r, valid_f1 = valid_metrics
        test_acc, test_auc, test_p, test_r, test_f1 = test_metrics
        if tb_writer is not None:
            tb_writer.add_scalar("train/1.train_loss", train_loss, epoch)
            tb_writer.add_scalar("test/2.test_loss", valid_loss, epoch)

        # model selection (train_RLMIL.py:902-917)
        if args.picked_method == "acc":
            is_best = bests["valid_acc"].compare(valid_acc)
        elif args.picked_method == "loss":
            is_best = bests["valid_loss"].compare(valid_loss)
        elif args.picked_method == "auc":
            is_best = bests["valid_auc"].compare(valid_auc)
        elif args.picked_method == "score":
            score = get_score(valid_acc, valid_auc, valid_p, valid_r, valid_f1)
            is_best = best_score.compare(score, epoch + 1, inplace=True)
        else:
            raise ValueError("picked_method error.")
        if is_best:
            final.update(epoch=epoch + 1, loss=test_loss, acc=test_acc, auc=test_auc,
                         precision=test_p, recall=test_r, f1=test_f1)
            best = _states(s)
            if args.save_model:
                save_checkpoint(save_dir, epoch + 1, s.model, s.fc, s.optimizer, s.ppo,
                                is_best=True)

        per_split = {"train": (train_loss, train_acc, train_auc),
                     "valid": (valid_loss, valid_acc, valid_auc),
                     "test": (test_loss, test_acc, test_auc)}
        for split, values in per_split.items():
            for m, v in zip(("loss", "acc", "auc"), values):
                bests[f"{split}_{m}"].compare(v, epoch + 1, inplace=True)
        for i, m in enumerate(("loss", "acc", "auc")):
            writers[m].write_row(
                [epoch + 1, *(per_split[split][i] for split in ("train", "valid", "test")),
                 *((bests[f"{split}_{m}"].best, bests[f"{split}_{m}"].epoch)
                   for split in ("train", "valid", "test"))])
        results_csv.write_row([epoch + 1, final["epoch"], test_loss, test_acc, test_auc,
                               test_p, test_r, test_f1])
        print(f"Epoch {epoch + 1}/{args.epochs} [{dt:.1f}s] "
              f"Train acc {train_acc:.4f} auc {train_auc:.4f} loss {train_loss:.4f} | "
              f"Valid acc {valid_acc:.4f} auc {valid_auc:.4f} loss {valid_loss:.4f} | "
              f"Test acc {test_acc:.4f} auc {test_auc:.4f} loss {test_loss:.4f} | "
              f"Final epoch {final['epoch']} acc {final['acc']:.4f} auc {final['auc']:.4f}")
        if early_stop is not None:
            early_stop.update((bests["valid_loss"].best, bests["valid_acc"].best,
                               bests["valid_auc"].best))
            if early_stop.is_stop():
                break
    return {"best": best, "final": final, "train_losses": train_losses,
            "steps_per_sec": steps_per_sec}


def default_args(**overrides) -> SimpleNamespace:
    """Programmatic args with the CLI defaults (``train_RLMIL.py``)."""
    ns = SimpleNamespace(
        dataset="Camelyon16", data_csv="", data_split_json="", train_data="train",
        preload=False, feat_size=1024, train_method="scratch", train_stage=1, T=6,
        checkpoint_stage=None, checkpoint_pretrained=None, optimizer="Adam", scheduler=None,
        batch_size=1, epochs=40, ppo_epochs=10, backbone_lr=1e-4, fc_lr=1e-4, momentum=0.9,
        nesterov=True, beta1=0.9, beta2=0.999, warmup=0, wdecay=1e-5, picked_method="score",
        patience=None, arch="CLAM_SB", num_classes=2, model_dim=512, policy_hidden_dim=512,
        policy_conv=False, action_std=0.5, ppo_lr=1e-5, ppo_gamma=0.1, K_epochs=3,
        feature_num=512, fc_hidden_dim=1024, fc_rnn=True, load_fc=False, L=512, D=128,
        dropout=0.0, train_model_prime=True, size_arg="small", k_sample=8, bag_weight=0.7,
        loss="CrossEntropyLoss", use_tensorboard=False, profile=0, base_save_dir="./results",
        save_dir=None, save_dir_flag=None, exist_ok=False, resume=False, save_model=False,
        device="0", seed=985, streaming=False, compute_dtype="float32", dp_devices=0,
    )
    for k, v in overrides.items():
        setattr(ns, k, v)
    return ns
