#!/usr/bin/env python
"""Patch feature extraction CLI of the PyTorch/CUDA port
(``wsi_processing/extract_features.py``).

Run as ``python -m murcl_tpu_torch.extract_features``; the same flags.
``--device`` is a CUDA device index (the default ``0``) or ``cpu``. Without
``--weights`` the encoder takes torchvision's ImageNet weights where
torchvision imports, else random weights with a warning: on a machine
without torchvision, write the pickle with torch alone from a downloaded
torchvision ``.pth`` (``python -m
murcl_tpu_torch.scripts.export_torchvision_weights --state_dict <pth>
--out <pkl>``) and pass it here.
"""

import argparse
from pathlib import Path

from murcl_tpu_torch.preprocess.extract import extract_features


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--patch_dir', type=str, default='',
                        help="directory containing the `coord` folder")
    parser.add_argument('--save_dir', type=str, default=None)
    parser.add_argument('--image_encoder', type=str, default='resnet18',
                        choices=['resnet18', 'resnet50', 'vgg16'])
    parser.add_argument('--device', default='0', help="cpu, N or cuda:N")
    parser.add_argument('--exist_ok', action='store_true', default=False)
    parser.add_argument('--batch_size', type=int, default=256)
    parser.add_argument('--num_workers', type=int, default=8)
    parser.add_argument('--weights', type=str, default=None,
                        help="pickled flax params (python -m "
                             "murcl_tpu_torch.scripts.export_torchvision_weights)")
    parser.add_argument('--imagenet_norm', action='store_true', default=False,
                        help="apply ImageNet normalization (the reference does NOT)")
    parser.add_argument('--resize_on_device', action='store_true', default=False,
                        help="ship level-0 uint8 patches and downscale them on the device")
    parser.add_argument('--decode_pool', type=str, default='thread',
                        choices=['thread', 'process'],
                        help="patch decode workers: threads, or spawned processes "
                             "writing into shared memory")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.save_dir is not None:
        save_dir = Path(args.save_dir) / args.image_encoder
    else:
        save_dir = Path(args.patch_dir) / 'features' / args.image_encoder
    return extract_features(
        args.patch_dir, save_dir, image_encoder=args.image_encoder,
        batch_size=args.batch_size, num_workers=args.num_workers, weights=args.weights,
        exist_ok=args.exist_ok, imagenet_norm=args.imagenet_norm,
        resize_on_device=args.resize_on_device, decode_pool=args.decode_pool,
        device=args.device)


if __name__ == '__main__':
    main()
