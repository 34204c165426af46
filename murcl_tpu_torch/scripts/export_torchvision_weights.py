#!/usr/bin/env python
"""Export ImageNet encoder weights into the extractor's ``--weights`` pickle,
with torch alone (counterpart of ``scripts/export_torchvision_weights.py``).

The reference downloads torchvision's pretrained backbones at extraction
time; a machine without network or without torchvision cannot. Write the
pickle where the weights are, and pass it to ``extract_features``:

    # where torchvision imports (and its weights download or are cached):
    python -m murcl_tpu_torch.scripts.export_torchvision_weights \
        --encoder resnet18 --out resnet18_imagenet.pkl

    # with torch alone and a downloaded torchvision state_dict
    # (e.g. resnet18-f37072fd.pth from download.pytorch.org):
    python -m murcl_tpu_torch.scripts.export_torchvision_weights \
        --encoder resnet18 --state_dict resnet18-f37072fd.pth \
        --out resnet18_imagenet.pkl

    python -m murcl_tpu_torch.extract_features ... \
        --image_encoder resnet18 --weights resnet18_imagenet.pkl

The pickle is the JAX package's, byte for byte: ``{"params": tree}`` of
numpy arrays in the flax layout
(:func:`~murcl_tpu_torch.preprocess.resnet.jax_params_from_state_dict`), so
either package's extractor reads it.
"""

from __future__ import annotations

import argparse
import pickle
import sys

import torch

from murcl_tpu_torch.preprocess.resnet import jax_params_from_state_dict, load_torchvision_weights


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--encoder", default="resnet18", choices=["resnet18", "resnet50", "vgg16"])
    ap.add_argument("--state_dict", default=None,
                    help="path to a torchvision state_dict checkpoint (.pth); needs only torch")
    ap.add_argument("--out", required=True, help="output pickle path")
    args = ap.parse_args(argv)

    if args.state_dict:
        sd = torch.load(args.state_dict, map_location="cpu", weights_only=True)
    else:
        try:
            sd = load_torchvision_weights(args.encoder)
        except ImportError as e:
            print(f"export_torchvision_weights: torchvision does not import here ({e}); pass "
                  f"--state_dict <a downloaded {args.encoder} .pth> instead", file=sys.stderr)
            return 2
    with open(args.out, "wb") as fp:
        pickle.dump(jax_params_from_state_dict(sd, args.encoder), fp)
    print(f"wrote {args.encoder} params -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
