#!/usr/bin/env python
"""WSI tiling CLI of the PyTorch/CUDA port (``wsi_processing/create_patches.py``).

Run as ``python -m murcl_tpu_torch.create_patches``; the same flags, and
``--device`` (``0`` by default, the card; ``cpu``), which decodes the
slides' JPEG tiles (nvJPEG on the card, PIL on the CPU). The rest is host
work, as in the JAX package: numpy and scipy, no OpenCV or PIL. Slides are
read by ``open_slide``: ``.tif``/``.svs`` pyramids by the port's TIFF
reader. Writes ``<save_dir>/coord/<slide>.json`` and, on request, the
overview, mask and patch PNGs.
"""

import argparse

from murcl_tpu_torch.preprocess.tiling import run_tiling


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--slide_dir', type=str, default='')
    parser.add_argument('--save_dir', type=str, default='')
    parser.add_argument('--exist_ok', action='store_true', default=False)
    parser.add_argument('--patch_size', type=int, default=256)
    parser.add_argument('--magnification', type=int, default=20, choices=[40, 20, 10, 5])
    parser.add_argument('--scale_factor', type=int, default=32,
                        help="downsample factor of the tissue-judging mask")
    parser.add_argument('--tissue_thresh', type=float, default=0.35,
                        help="minimum tissue fraction to keep a patch")
    parser.add_argument('--overview', action='store_true', default=False)
    parser.add_argument('--save_mask', action='store_true', default=False)
    parser.add_argument('--save_patch', action='store_true', default=False)
    parser.add_argument('--wsi_format', type=str, default='.svs', choices=['.svs', '.tif'])
    parser.add_argument('--specify_filename', action='store_true', default=False,
                        help="use stem[filename_l:filename_r] as the save index")
    parser.add_argument('--filename_l', type=int, default=0)
    parser.add_argument('--filename_r', type=int, default=12)
    parser.add_argument('--method', type=str, default='rgb', choices=['otsu', 'adaptive', 'rgb'])
    parser.add_argument('--overview_level', type=int, default=-1)
    parser.add_argument('--device', default='0',
                        help="decodes JPEG tiles: cpu (PIL), N or cuda:N (nvJPEG)")
    return parser.parse_args(argv)


def main(argv=None):
    run_tiling(parse_args(argv))


if __name__ == '__main__':
    main()
