"""Move weights between the JAX package's parameter trees and the port.

The JAX trees (``murcl_tpu`` ``ABMIL``, ``CLAM_SB`` gated or not,
``FullLayer`` and ``ActorCritic``) are nested dicts of arrays, optionally
under ``'params'``, with flax kernels stored ``(in, out)``; the port's
modules keep the reference torch layout (weights ``(out, in)``), the same
mapping as ``murcl_tpu/engine/torch_import.py`` (``ABMIL_MAP``,
``clam_map``, ``ACTOR_CRITIC_MAP``). Ungated CLAM keeps the reference
``Attn_Net`` keys (``attention_net.3.module.0`` and ``.3``), which
``clam_map`` does not cover; they map to the JAX leaves ``attn/wa, ba, wc,
bc``. Arrays pass through numpy, so this module needs no JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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
_CLAM_UNGATED_LINEARS = [
    ("attention_net.0", ("fc",), "kernel", "bias"),
    ("attention_net.3.module.0", ("attn",), "wa", "ba"),
    ("attention_net.3.module.3", ("attn",), "wc", "bc"),
    ("classifiers", ("classifiers",), "kernel", "bias"),
]
_ABMIL_LINEARS = [
    ("encoder.0", ("encoder", "dense_0"), "kernel", "bias"),
    ("encoder.3", ("encoder", "dense_1"), "kernel", "bias"),
    ("encoder.6", ("encoder", "dense_2"), "kernel", "bias"),
    ("attention.0", ("attn",), "wa", "ba"),
    ("attention.2", ("attn",), "wc", "bc"),
    ("decoder.0", ("decoder",), "kernel", "bias"),
    ("fc", ("fc",), "kernel", "bias"),
]
_GRU = [("weight_ih_l0", "w_ih", True), ("weight_hh_l0", "w_hh", True),
        ("bias_ih_l0", "b_ih", False), ("bias_hh_l0", "b_hh", False)]
# ActorCritic: (torch prefix, JAX module) of its linears; its GRU is "gru"
_POLICY_LINEARS = [("state_encoder.0", "enc_hidden"), ("state_encoder.2", "enc_out"),
                   ("actor.0", "actor"), ("critic.0", "critic")]


def _unwrap(tree: dict) -> dict:
    return tree["params"] if "params" in tree else tree


def _node(tree: dict, path) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32))


def _gru_from_jax(node: dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": _t(np.asarray(node[j]).T if tr else node[j]) for k, j, tr in _GRU}


def _gru_to_jax(sd: dict, prefix: str) -> dict:
    return {j: sd[f"{prefix}.{k}"].T.copy() if tr else sd[f"{prefix}.{k}"].copy()
            for k, j, tr in _GRU}


def _numpy(sd: Dict[str, torch.Tensor]) -> dict:
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def _linears(arch: str, gated: bool) -> list:
    if arch == "ABMIL":
        return _ABMIL_LINEARS
    if arch == "CLAM_SB":
        return _CLAM_LINEARS if gated else _CLAM_UNGATED_LINEARS
    raise NotImplementedError(f"{arch} weights: ROADMAP queue 1, item 12")


def jax_leaf_path(key: str, arch: str = "CLAM_SB", gated: bool = True) -> tuple:
    """The JAX leaf path (under ``'params'``) of the aggregator's ``state_dict``
    key ``key``; CLAM's ``instance_classifiers.*`` are the stacked leaves
    ``instance_kernel`` / ``instance_bias``."""
    for prefix, path, w, b in _linears(arch, gated):
        if key in (f"{prefix}.weight", f"{prefix}.bias"):
            return path + ((w,) if key.endswith(".weight") else (b,))
    if arch == "CLAM_SB" and key.startswith("instance_classifiers."):
        return ("instance_kernel",) if key.endswith(".weight") else ("instance_bias",)
    raise KeyError(f"{key} has no JAX leaf in {arch}")


def params_from_jax(model_tree: dict, fc_tree: Optional[dict] = None, arch: str = "CLAM_SB"
                    ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict[str, torch.Tensor]]]:
    """JAX ``(model, fc)`` parameter trees -> the port's ``state_dict``s
    (aggregator keys without the ``encoder.`` prefix, ``FullLayer`` keys;
    ``None`` for a missing ``fc_tree``). ``arch`` is ``CLAM_SB`` (gated or
    not, read from the tree) or ``ABMIL``."""
    mt = _unwrap(model_tree)
    model = {}
    for prefix, path, w, b in _linears(arch, "wb" in mt.get("attn", {})):
        node = _node(mt, path)
        model[f"{prefix}.weight"] = _t(np.asarray(node[w]).T)
        model[f"{prefix}.bias"] = _t(np.asarray(node[b]).reshape(-1))
    if arch == "CLAM_SB":
        kernels, biases = np.asarray(mt["instance_kernel"]), np.asarray(mt["instance_bias"])
        for i in range(kernels.shape[0]):
            model[f"instance_classifiers.{i}.weight"] = _t(kernels[i].T)
            model[f"instance_classifiers.{i}.bias"] = _t(biases[i])
    if fc_tree is None:
        return model, None
    ft = _unwrap(fc_tree)
    fc = _gru_from_jax(ft["rnn"], "rnn")
    fc["fc.weight"] = _t(np.asarray(ft["fc"]["kernel"]).T)
    fc["fc.bias"] = _t(ft["fc"]["bias"])
    return model, fc


def jax_from_params(model_sd: Dict[str, torch.Tensor],
                    fc_sd: Optional[Dict[str, torch.Tensor]] = None,
                    arch: str = "CLAM_SB") -> Tuple[dict, Optional[dict]]:
    """Inverse of :func:`params_from_jax`: ``({'params': model}, {'params': fc})``
    of numpy arrays (``None`` for a missing ``fc_sd``). An ``encoder.`` prefix
    on every model key is dropped; the bias of ``attention.2``/``attention_c``
    keeps torch's ``(1,)`` shape, the JAX leaf's."""
    sd = _numpy(model_sd)
    if all(k.startswith("encoder.") for k in sd):
        sd = {k[len("encoder."):]: v for k, v in sd.items()}
    model: dict = {}
    for prefix, path, w, b in _linears(arch, "attention_net.3.attention_b.0.weight" in sd):
        node = model
        for p in path:
            node = node.setdefault(p, {})
        node[w] = sd[f"{prefix}.weight"].T.copy()
        node[b] = sd[f"{prefix}.bias"].copy()
    if arch == "CLAM_SB":
        n = sum(1 for k in sd if k.startswith("instance_classifiers.") and k.endswith(".weight"))
        model["instance_kernel"] = np.stack(
            [sd[f"instance_classifiers.{i}.weight"].T for i in range(n)])
        model["instance_bias"] = np.stack(
            [sd[f"instance_classifiers.{i}.bias"] for i in range(n)])
    if fc_sd is None:
        return {"params": model}, None
    f = _numpy(fc_sd)
    fc = {"rnn": _gru_to_jax(f, "rnn"),
          "fc": {"kernel": f["fc.weight"].T.copy(), "bias": f["fc.bias"].copy()}}
    return {"params": model}, {"params": fc}


def policy_from_jax(tree: dict) -> Dict[str, torch.Tensor]:
    """JAX ``ActorCritic`` tree (``policy_conv=False``) -> the port's
    ``ActorCritic`` ``state_dict``."""
    t = _unwrap(tree)
    sd = _gru_from_jax(t["gru"], "gru")
    for prefix, name in _POLICY_LINEARS:
        sd[f"{prefix}.weight"] = _t(np.asarray(t[name]["kernel"]).T)
        sd[f"{prefix}.bias"] = _t(t[name]["bias"])
    return sd


def jax_from_policy(sd: Dict[str, torch.Tensor]) -> dict:
    """Inverse of :func:`policy_from_jax`: ``{'params': tree}`` of numpy arrays."""
    f = _numpy(sd)
    tree = {"gru": _gru_to_jax(f, "gru")}
    for prefix, name in _POLICY_LINEARS:
        tree[name] = {"kernel": f[f"{prefix}.weight"].T.copy(),
                      "bias": f[f"{prefix}.bias"].copy()}
    return {"params": tree}
