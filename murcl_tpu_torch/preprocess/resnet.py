"""Image encoders for patch features: ResNet18/50 up to global average
pooling (512 / 2048) and VGG16 to its second fully connected layer (4096),
counterparts of the flax encoders of ``murcl_tpu/preprocess/resnet.py``.

The modules carry torchvision's ``state_dict`` keys (``conv1``, ``bn1``,
``layer{i}.{j}.conv{k}``, ``downsample.{0,1}``; ``features.{n}``,
``classifier.{0,3}``) but not torchvision itself, which the GPU machine
lacks. BatchNorm is frozen (inference only, as the reference never trains
the encoder), computed as the JAX package computes it: ``x * inv + (bias -
mean * inv)`` with ``inv = weight / sqrt(var + 1e-5)``. Max pooling pads
with -inf, as flax does. VGG16 keeps the JAX package's ReLU after its second
fully connected layer (``resnet.py:154``), which the reference's
``classifier[:-3]`` leaves out.

Weights: :func:`state_dict_from_jax` maps a flax tree (the JAX package's
``--weights`` pickle, read by :func:`load_params_npz`) onto these keys,
the inverse of ``resnet_params_from_torch`` / ``vgg16_params_from_torch``,
and :func:`jax_params_from_state_dict` writes that tree from these keys
(``murcl_tpu_torch/scripts/export_torchvision_weights.py``);
:func:`load_torchvision_weights` takes ImageNet weights from torchvision
where it imports.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# (stage_sizes, bottleneck) per torchvision resnet
RESNET_ARCH = {"resnet18": ((2, 2, 2, 2), False), "resnet50": ((3, 4, 6, 3), True)}
FEATURE_DIM = {"resnet18": 512, "resnet50": 2048, "vgg16": 4096}
VGG16_CFG = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512, "M")


class FrozenBatchNorm(nn.Module):
    """Inference-mode BatchNorm over NCHW with torchvision's buffer names."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = self.weight * torch.rsqrt(self.running_var + self.eps)
        shift = self.bias - self.running_mean * inv
        return x * inv[:, None, None].to(x.dtype) + shift[:, None, None].to(x.dtype)


def _conv(cin: int, cout: int, k: int, stride: int = 1) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride, padding=k // 2, bias=False)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        self.conv1, self.bn1 = _conv(cin, width, 3, stride), FrozenBatchNorm(width)
        self.conv2, self.bn2 = _conv(width, width, 3), FrozenBatchNorm(width)
        self.downsample = (nn.Sequential(_conv(cin, width, 1, stride), FrozenBatchNorm(width))
                           if stride != 1 or cin != width else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int):
        super().__init__()
        out = width * 4
        self.conv1, self.bn1 = _conv(cin, width, 1), FrozenBatchNorm(width)
        self.conv2, self.bn2 = _conv(width, width, 3, stride), FrozenBatchNorm(width)
        self.conv3, self.bn3 = _conv(width, out, 1), FrozenBatchNorm(out)
        self.downsample = (nn.Sequential(_conv(cin, out, 1, stride), FrozenBatchNorm(out))
                           if stride != 1 or cin != out else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + (x if self.downsample is None else self.downsample(x)))


class ResNetEncoder(nn.Module):
    """ResNet up to global average pooling: NCHW in, ``(B, feat_dim)`` out."""

    def __init__(self, stage_sizes: Sequence[int], bottleneck: bool):
        super().__init__()
        block = Bottleneck if bottleneck else BasicBlock
        self.conv1, self.bn1 = _conv(3, 64, 7, 2), FrozenBatchNorm(64)
        cin = 64
        for i, (n, width) in enumerate(zip(stage_sizes, (64, 128, 256, 512))):
            blocks = []
            for j in range(n):
                blocks.append(block(cin, width, 2 if (i > 0 and j == 0) else 1))
                cin = width * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
        self.num_stages = len(stage_sizes)

    def forward(self, x):
        x = F.max_pool2d(F.relu(self.bn1(self.conv1(x))), 3, 2, 1)
        for i in range(self.num_stages):
            x = getattr(self, f"layer{i + 1}")(x)
        return x.mean(dim=(2, 3))


class VGG16Encoder(nn.Module):
    """VGG16 features, ``AdaptiveAvgPool2d((7, 7))`` (torchvision's, for any
    input size) and ``classifier[:4]`` with a ReLU after each product."""

    def __init__(self):
        super().__init__()
        layers, cin = [], 3
        for v in VGG16_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU(inplace=True)]
                cin = v
        self.features = nn.Sequential(*layers)
        self.avgpool = nn.AdaptiveAvgPool2d((7, 7))
        self.classifier = nn.Sequential(nn.Linear(512 * 7 * 7, 4096), nn.ReLU(inplace=True),
                                        nn.Dropout(), nn.Linear(4096, 4096))

    def forward(self, x):
        x = torch.flatten(self.avgpool(self.features(x)), 1)
        return F.relu(self.classifier(x))


def create_encoder(name: str = "resnet18") -> Tuple[nn.Module, int]:
    """``(module, feature_dim)``, randomly initialised, in eval mode."""
    if name in RESNET_ARCH:
        model = ResNetEncoder(*RESNET_ARCH[name])
    elif name == "vgg16":
        model = VGG16Encoder()
    else:
        raise ValueError(f"image encoder {name!r} not supported")
    return model.eval(), FEATURE_DIM[name]


def _vgg16_conv_indices():
    idx, out = 0, []
    for v in VGG16_CFG:
        if v != "M":
            out.append(idx)
        idx += 1 if v == "M" else 2
    return out


def state_dict_from_jax(params, name: str) -> Dict[str, torch.Tensor]:
    """A flax encoder tree (``{"params": ...}`` or its inside) as this module's
    ``state_dict``: conv kernels HWIO -> OIHW, dense kernels transposed,
    FrozenBatchNorm's ``scale/bias/mean/var`` -> ``weight/bias/running_mean/
    running_var``."""
    p = params.get("params", params)
    sd: Dict[str, np.ndarray] = {}

    def conv(key, tree):
        sd[key + ".weight"] = np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1))
        if "bias" in tree:
            sd[key + ".bias"] = np.asarray(tree["bias"])

    def bn(key, tree):
        for src, dst in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                         ("var", "running_var")):
            sd[f"{key}.{dst}"] = np.asarray(tree[src])

    if name in RESNET_ARCH:
        stage_sizes, bottleneck = RESNET_ARCH[name]
        conv("conv1", p["conv1"])
        bn("bn1", p["bn1"])
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                blk, key = p[f"layer{i + 1}_{j}"], f"layer{i + 1}.{j}"
                for c in range(1, (3 if bottleneck else 2) + 1):
                    conv(f"{key}.conv{c}", blk[f"conv{c}"])
                    bn(f"{key}.bn{c}", blk[f"bn{c}"])
                if "down_conv" in blk:
                    conv(f"{key}.downsample.0", blk["down_conv"])
                    bn(f"{key}.downsample.1", blk["down_bn"])
    elif name == "vgg16":
        for k, idx in enumerate(_vgg16_conv_indices()):
            conv(f"features.{idx}", p[f"conv{k}"])
        for flax_name, key in (("fc1", "classifier.0"), ("fc2", "classifier.3")):
            sd[key + ".weight"] = np.asarray(p[flax_name]["kernel"]).T
            sd[key + ".bias"] = np.asarray(p[flax_name]["bias"])
    else:
        raise ValueError(f"image encoder {name!r} not supported")
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32)) for k, v in sd.items()}


def jax_params_from_state_dict(state_dict, name: str) -> dict:
    """A torchvision-layout ``state_dict`` as the JAX package's flax encoder
    tree, ``{"params": ...}`` of numpy arrays: the ``--weights`` pickle's
    content and the inverse of :func:`state_dict_from_jax`. Leaf for leaf,
    array for array (views included, so the pickle is byte for byte the
    same), ``resnet_params_from_torch`` / ``vgg16_params_from_torch`` of
    ``murcl_tpu/preprocess/resnet.py:171-229``: conv kernels OIHW -> HWIO,
    BatchNorm buffers as ``scale/bias/mean/var``, dense kernels transposed,
    VGG's convs numbered in the order of their ``features.{n}`` indices, each
    leaf in the state_dict's dtype. Other keys (``num_batches_tracked``,
    ``fc.*``, ``classifier.6.*``) are ignored."""
    sd = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
          for k, v in state_dict.items()}
    hwio = lambda w: np.transpose(w, (2, 3, 1, 0))  # noqa: E731

    def bn(prefix):
        return {dst: sd[f"{prefix}.{src}"] for src, dst in (
            ("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
            ("running_var", "var"))}

    p: dict = {}
    if name in RESNET_ARCH:
        stage_sizes, bottleneck = RESNET_ARCH[name]
        p["conv1"], p["bn1"] = {"kernel": hwio(sd["conv1.weight"])}, bn("bn1")
        for i, n in enumerate(stage_sizes):
            for j in range(n):
                key, blk = f"layer{i + 1}.{j}", {}
                for c in range(1, (3 if bottleneck else 2) + 1):
                    blk[f"conv{c}"] = {"kernel": hwio(sd[f"{key}.conv{c}.weight"])}
                    blk[f"bn{c}"] = bn(f"{key}.bn{c}")
                if f"{key}.downsample.0.weight" in sd:
                    blk["down_conv"] = {"kernel": hwio(sd[f"{key}.downsample.0.weight"])}
                    blk["down_bn"] = bn(f"{key}.downsample.1")
                p[f"layer{i + 1}_{j}"] = blk
    elif name == "vgg16":
        convs = sorted((k for k in sd if k.startswith("features.") and k.endswith(".weight")),
                       key=lambda k: int(k.split(".")[1]))
        for c, k in enumerate(convs):
            idx = k.split(".")[1]
            p[f"conv{c}"] = {"kernel": hwio(sd[k]), "bias": sd[f"features.{idx}.bias"]}
        for flax_name, key in (("fc1", "classifier.0"), ("fc2", "classifier.3")):
            p[flax_name] = {"kernel": sd[f"{key}.weight"].T, "bias": sd[f"{key}.bias"]}
    else:
        raise ValueError(f"image encoder {name!r} not supported")
    return {"params": p}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def load_params_npz(path) -> dict:
    """The ``--weights`` pickle (``python -m
    murcl_tpu_torch.scripts.export_torchvision_weights``, or the JAX
    package's ``save_params_npz``): a tree of numpy arrays, read by
    the checkpoint reader's restricted unpickler, so no code runs and no jax
    is needed; a tree with anything but arrays at its leaves is refused."""
    from murcl_tpu_torch.engine.checkpoint import _JaxUnpickler

    with open(path, "rb") as fp:
        params = _JaxUnpickler(fp).load()
    if not isinstance(params, dict) or not all(isinstance(v, np.ndarray)
                                               for v in _leaves(params)):
        raise ValueError(f"{path}: not a tree of numpy arrays")
    return params


def load_torchvision_weights(name: str) -> Dict[str, torch.Tensor]:
    """ImageNet weights through torchvision (raises where it does not import)."""
    import torchvision.models as tvm

    weights = {"resnet18": "ResNet18_Weights", "resnet50": "ResNet50_Weights",
               "vgg16": "VGG16_Weights"}[name]
    model = getattr(tvm, name)(weights=getattr(tvm, weights).IMAGENET1K_V1)
    return {k: v for k, v in model.state_dict().items()
            if not k.endswith("num_batches_tracked") and not k.startswith(("fc.",
                                                                           "classifier.6"))}
