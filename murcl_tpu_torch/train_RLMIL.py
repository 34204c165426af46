#!/usr/bin/env python
"""Supervised RLMIL CLI of the PyTorch/CUDA port.

Run as ``python -m murcl_tpu_torch.train_RLMIL``. The flags are those of
the reference ``train_RLMIL.py``, so ``runs/finetune.sh``, ``runs/linear.sh``
and ``runs/scratch.sh`` parse; the JAX package's TPU-only flags
(``--eval_batch_pad``, ``--rng_impl``, ``--remat``, ``--stage1_layout``,
``--select_impl``, ``--attn_gate_math``) do not exist here. ``--device`` is
``cpu`` (plain PyTorch path) or a CUDA device index (kernels).
"""

import argparse

from murcl_tpu_torch.drivers import rlmil

MODELS = ["ABMIL", "CLAM_SB", "DSMIL"]
LOSSES = ["CrossEntropyLoss"]


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    # Data
    parser.add_argument('--dataset', type=str, default='Camelyon16')
    parser.add_argument('--data_csv', type=str, default='')
    parser.add_argument('--data_split_json', type=str, default='/path/to/data_split.json')
    parser.add_argument('--train_data', type=str, default='train',
                        choices=['train', 'train_sub_per10'])
    parser.add_argument('--preload', action='store_true', default=False,
                        help="accepted for recipe compatibility; the banks are always resident")
    parser.add_argument('--feat_size', default=1024, type=int)
    # Train
    parser.add_argument('--train_method', type=str, default='scratch',
                        choices=['scratch', 'finetune', 'linear'])
    parser.add_argument('--train_stage', default=1, type=int)
    parser.add_argument('--T', default=6, type=int)
    parser.add_argument('--checkpoint_stage', default=None, type=str)
    parser.add_argument('--checkpoint_pretrained', type=str, default=None)
    parser.add_argument('--optimizer', type=str, default='Adam', choices=['Adam', 'SGD'])
    parser.add_argument('--scheduler', type=str, default=None,
                        choices=[None, 'StepLR', 'CosineAnnealingLR'])
    parser.add_argument('--batch_size', type=int, default=1)
    parser.add_argument('--epochs', type=int, default=40)
    parser.add_argument('--ppo_epochs', type=int, default=10)
    parser.add_argument('--backbone_lr', default=1e-4, type=float)
    parser.add_argument('--fc_lr', default=1e-4, type=float)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--nesterov', action='store_true', default=True)
    parser.add_argument('--beta1', type=float, default=0.9)
    parser.add_argument('--beta2', type=float, default=0.999)
    parser.add_argument('--warmup', default=0, type=float)
    parser.add_argument('--wdecay', default=1e-5, type=float)
    parser.add_argument('--picked_method', type=str, default='score')
    parser.add_argument('--patience', type=int, default=None)
    # Architecture
    parser.add_argument('--arch', default='CLAM_SB', type=str, choices=MODELS)
    parser.add_argument('--num_classes', type=int, default=2)
    parser.add_argument('--model_dim', type=int, default=512)
    # Architecture - PPO
    parser.add_argument('--policy_hidden_dim', type=int, default=512)
    parser.add_argument('--policy_conv', action='store_true', default=False,
                        help="the policy's conv state encoder: a bias-free 1x1 conv to "
                             "32 channels before its linear")
    parser.add_argument('--action_std', type=float, default=0.5)
    parser.add_argument('--ppo_lr', type=float, default=0.00001)
    parser.add_argument('--ppo_gamma', type=float, default=0.1)
    parser.add_argument('--K_epochs', type=int, default=3)
    # Architecture - Full_layer
    parser.add_argument('--feature_num', type=int, default=512)
    parser.add_argument('--fc_hidden_dim', type=int, default=1024)
    parser.add_argument('--fc_rnn', action='store_true', default=True)
    parser.add_argument('--load_fc', action='store_true', default=False)
    # Architecture - ABMIL
    parser.add_argument('--L', type=int, default=512)
    parser.add_argument('--D', type=int, default=128)
    parser.add_argument('--dropout', type=float, default=0.0)
    parser.add_argument('--train_model_prime', action='store_true', default=True,
                        help="train the t=0 (prime) forward of ABMIL")
    # CLAM
    parser.add_argument('--size_arg', type=str, default='small', choices=['small', 'big'])
    parser.add_argument('--k_sample', type=int, default=8)
    parser.add_argument('--bag_weight', type=float, default=0.7)
    # Loss
    parser.add_argument('--loss', default='CrossEntropyLoss', type=str, choices=LOSSES)
    parser.add_argument('--use_tensorboard', action='store_true', default=False,
                        help="log losses with torch.utils.tensorboard where it imports")
    parser.add_argument('--profile', type=int, default=0,
                        help="trace the first N steps with torch.profiler into "
                             "<save_dir>/profile")
    # Save
    parser.add_argument('--base_save_dir', type=str, default='./results')
    parser.add_argument('--save_dir', type=str, default=None)
    parser.add_argument('--save_dir_flag', type=str, default=None)
    parser.add_argument('--exist_ok', action='store_true', default=False)
    parser.add_argument('--resume', action='store_true', default=False,
                        help="resume from <save_dir>/checkpoint.pth.tar (needs --exist_ok)")
    parser.add_argument('--save_model', action='store_true', default=False)
    # Global
    parser.add_argument('--device', default='0',
                        help="'cpu' (plain PyTorch path) or a CUDA device index")
    parser.add_argument('--seed', type=int, default=985)
    parser.add_argument('--streaming', action='store_true', default=False,
                        help="keep the features on the host and stage each batch's "
                             "slides onto the device on a prefetch thread")
    parser.add_argument('--compute_dtype', type=str, default='float32',
                        choices=['float32', 'bfloat16'],
                        help="aggregator compute dtype (losses stay float32)")
    parser.add_argument('--dp_devices', type=int, default=0,
                        help="N > 1 trains data-parallel: N rank processes over "
                             "torch.distributed, each on batch_size / N slides of every "
                             "batch, the first N cards one each (ranks share cards when "
                             "there are fewer; gloo with --device cpu); batch_size must be "
                             "a multiple of N")
    return parser.parse_args(argv)


def main(argv=None):
    return rlmil.run(parse_args(argv))


if __name__ == '__main__':
    main()
