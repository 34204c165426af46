#!/usr/bin/env python
"""Full-slide attention heatmap CLI of the PyTorch/CUDA port.

Run as ``python -m murcl_tpu_torch.create_heatmaps``. The flags are those of
``scripts/create_heatmaps.py``. ``--device`` is a CUDA device index (the
default ``0``: kernels K2 and K8) or ``cpu`` (the plain PyTorch path).
``--draw_contours`` outlines the Camelyon16 annotation polygons of
``--annotation_dir/<case_id>.xml``.
"""

import argparse

from murcl_tpu_torch.preprocess.heatmaps import run_heatmaps


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_csv', type=str, default='')
    parser.add_argument('--coord_dir', type=str, default='',
                        help="directory of per-slide coord json files")
    parser.add_argument('--save_dir', type=str, default='')
    parser.add_argument('--checkpoint', type=str, default=None,
                        help="MuRCL/RLMIL checkpoint to pull the CLAM weights from")
    parser.add_argument('--annotation_dir', type=str, default=None,
                        help="Camelyon16 annotation XML directory (for --draw_contours)")
    parser.add_argument('--draw_contours', action='store_true', default=False,
                        help="outline the annotation XML's ROI polygons")
    parser.add_argument('--arch', type=str, default='CLAM_SB', choices=['CLAM_SB'])
    parser.add_argument('--num_classes', type=int, default=2)
    parser.add_argument('--size_arg', type=str, default='small', choices=['small', 'big'])
    parser.add_argument('--k_sample', type=int, default=8)
    parser.add_argument('--preload', action='store_true', default=False)
    parser.add_argument('--slide_level', type=int, default=-1)
    parser.add_argument('--exist_ok', action='store_true', default=False)
    parser.add_argument('--bucket', type=int, default=512,
                        help="pad full bags to multiples of this")
    parser.add_argument('--device', default='0', help="cpu, N or cuda:N")
    return parser.parse_args(argv)


def main(argv=None):
    run_heatmaps(parse_args(argv))


if __name__ == '__main__':
    main()
