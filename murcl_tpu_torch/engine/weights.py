"""Move weights between the JAX package's parameter trees and the port.

The JAX trees (``murcl_tpu`` ``CLAM_SB`` and ``FullLayer``) are nested
dicts of arrays, optionally under ``'params'``, with flax kernels stored
``(in, out)``; the port's modules keep the reference torch layout (weights
``(out, in)``), the same mapping as ``murcl_tpu/engine/torch_import.py``
``export_model_state`` / ``import_model_state``. Arrays pass through numpy,
so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# (torch prefix, JAX module path, JAX weight leaf, JAX bias leaf)
_CLAM_LINEARS = [
    ("attention_net.0", ("fc",), "kernel", "bias"),
    ("attention_net.3.attention_a.0", ("attn",), "wa", "ba"),
    ("attention_net.3.attention_b.0", ("attn",), "wb", "bb"),
    ("attention_net.3.attention_c", ("attn",), "wc", "bc"),
    ("classifiers", ("classifiers",), "kernel", "bias"),
]
_GRU = [("weight_ih_l0", "w_ih", True), ("weight_hh_l0", "w_hh", True),
        ("bias_ih_l0", "b_ih", False), ("bias_hh_l0", "b_hh", False)]


def _unwrap(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def _node(tree: dict, path) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def params_from_jax(model_tree: dict, fc_tree: dict, arch: str = "CLAM_SB"
                    ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """JAX ``(model, fc)`` parameter trees -> the port's ``state_dict``s
    (``CLAM_SB`` keys without the ``encoder.`` prefix, ``FullLayer`` keys)."""
    if arch != "CLAM_SB":
        raise NotImplementedError(f"{arch} weights come with its slice (ROADMAP queue 1)")
    mt, ft = _unwrap(model_tree), _unwrap(fc_tree)
    model = {}
    for prefix, path, w, b in _CLAM_LINEARS:
        node = _node(mt, path)
        model[f"{prefix}.weight"] = _t(np.asarray(node[w]).T)
        model[f"{prefix}.bias"] = _t(np.asarray(node[b]).reshape(-1))
    kernels, biases = np.asarray(mt["instance_kernel"]), np.asarray(mt["instance_bias"])
    for i in range(kernels.shape[0]):
        model[f"instance_classifiers.{i}.weight"] = _t(kernels[i].T)
        model[f"instance_classifiers.{i}.bias"] = _t(biases[i])
    fc = {f"rnn.{k}": _t(np.asarray(ft["rnn"][j]).T if tr else ft["rnn"][j])
          for k, j, tr in _GRU}
    fc["fc.weight"] = _t(np.asarray(ft["fc"]["kernel"]).T)
    fc["fc.bias"] = _t(ft["fc"]["bias"])
    return model, fc


def jax_from_params(model_sd: Dict[str, torch.Tensor], fc_sd: Dict[str, torch.Tensor],
                    arch: str = "CLAM_SB") -> Tuple[dict, dict]:
    """Inverse of :func:`params_from_jax`: ``({'params': model}, {'params': fc})``
    of numpy arrays. An ``encoder.`` prefix on every model key is dropped."""
    if arch != "CLAM_SB":
        raise NotImplementedError(f"{arch} weights come with its slice (ROADMAP queue 1)")
    sd = {k: v.detach().cpu().numpy() for k, v in model_sd.items()}
    if all(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items()}
    model: dict = {}
    for prefix, path, w, b in _CLAM_LINEARS:
        node = model
        for p in path:
            node = node.setdefault(p, {})
        node[w] = sd[f"{prefix}.weight"].T.copy()
        node[b] = sd[f"{prefix}.bias"].copy()
    n = sum(1 for k in sd if k.startswith("instance_classifiers.") and k.endswith(".weight"))
    model["instance_kernel"] = np.stack(
        [sd[f"instance_classifiers.{i}.weight"].T for i in range(n)])
    model["instance_bias"] = np.stack([sd[f"instance_classifiers.{i}.bias"] for i in range(n)])
    f = {k: v.detach().cpu().numpy() for k, v in fc_sd.items()}
    fc = {"rnn": {j: f[f"rnn.{k}"].T.copy() if tr else f[f"rnn.{k}"].copy()
                  for k, j, tr in _GRU},
          "fc": {"kernel": f["fc.weight"].T.copy(), "bias": f["fc.bias"].copy()}}
    return {"params": model}, {"params": fc}
