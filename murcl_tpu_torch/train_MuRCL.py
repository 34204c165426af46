#!/usr/bin/env python
"""MuRCL pretraining CLI of the PyTorch/CUDA port.

Run as ``python -m murcl_tpu_torch.train_MuRCL``. The flags are those of
the reference ``train_MuRCL.py``, so ``runs/pretrain.sh`` parses; the JAX
package's TPU-only flags (``--remat``, ``--rng_impl``, ``--select_impl``,
``--stage1_layout``, ``--attn_gate_math``) do not exist here. ``--device``
is ``cpu`` (plain PyTorch path) or a CUDA device index (kernels).
"""

import argparse

from murcl_tpu_torch.drivers import murcl


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    # Data
    parser.add_argument('--dataset', type=str, default='Camelyon16')
    parser.add_argument('--data_csv', type=str, default='')
    parser.add_argument('--data_split_json', type=str, default='/path/to/data_split.json')
    parser.add_argument('--preload', action='store_true', default=False,
                        help="accepted for recipe compatibility; the bank is always resident")
    parser.add_argument('--data_repeat', type=int, default=10)
    parser.add_argument('--feat_size', default=1024, type=int)
    # Train
    parser.add_argument('--train_stage', default=1, type=int)
    parser.add_argument('--T', default=6, type=int)
    parser.add_argument('--optimizer', type=str, default='Adam', choices=['Adam', 'SGD'])
    parser.add_argument('--scheduler', type=str, default=None,
                        choices=[None, 'StepLR', 'CosineAnnealingLR'])
    parser.add_argument('--batch_size', type=int, default=128)
    parser.add_argument('--epochs', type=int, default=100)
    parser.add_argument('--ppo_epochs', type=int, default=30)
    parser.add_argument('--backbone_lr', default=1e-4, type=float)
    parser.add_argument('--fc_lr', default=1e-4, type=float)
    parser.add_argument('--temperature', type=float, default=1.0)
    parser.add_argument('--momentum', type=float, default=0.9)
    parser.add_argument('--nesterov', action='store_true', default=True)
    parser.add_argument('--beta1', type=float, default=0.9)
    parser.add_argument('--beta2', type=float, default=0.999)
    parser.add_argument('--warmup', default=0, type=float)
    parser.add_argument('--wdecay', default=1e-5, type=float)
    parser.add_argument('--patience', type=int, default=None)
    # Architecture
    parser.add_argument('--checkpoint', default=None, type=str)
    parser.add_argument('--arch', default='CLAM_SB', type=str, choices=['ABMIL', 'CLAM_SB'])
    parser.add_argument('--alpha', type=float, default=0.9)
    parser.add_argument('--projection_dim', type=int, default=128)
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
    # Architecture - ABMIL
    parser.add_argument('--D', type=int, default=128)
    parser.add_argument('--dropout', type=float, default=0.0)
    # CLAM
    parser.add_argument('--size_arg', type=str, default='small', choices=['small', 'big'])
    parser.add_argument('--k_sample', type=int, default=8)
    # Logging
    parser.add_argument('--use_tensorboard', action='store_true', default=False,
                        help="log the loss with torch.utils.tensorboard where it imports")
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
                        help="> 1 is not ported yet (ROADMAP queue 1, item 14)")
    return parser.parse_args(argv)


def main(argv=None):
    return murcl.run(parse_args(argv))


if __name__ == '__main__':
    main()
