"""The port's encoder-weights exporter
(``murcl_tpu_torch/scripts/export_torchvision_weights.py``) against the JAX
package's mapping, on the CPU.

For resnet18, resnet50 and vgg16, a random state_dict in torchvision's
layout (the port's ``create_encoder`` keys, plus the ``num_batches_tracked``,
``fc.*`` and ``classifier.6.*`` keys torchvision's models also carry):

- ``jax_params_from_state_dict`` gives the JAX package's
  ``resnet_params_from_torch`` / ``vgg16_params_from_torch`` tree key for
  key, bitwise and in dtype, and pickles to the same bytes;
- the CLI, in a subprocess where ``jax``, ``jaxlib``, ``flax``, ``optax``,
  ``murcl_tpu`` and ``torchvision`` cannot be imported, writes that pickle
  byte for byte from ``--state_dict``, and it reads back through
  ``load_params_npz`` and ``state_dict_from_jax`` to the state_dict
  bitwise. Without ``--state_dict`` and without torchvision it exits
  non-zero and names ``--state_dict``.
"""

import hashlib
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from murcl_tpu.preprocess import resnet as jr
from murcl_tpu_torch.preprocess import resnet as tr

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "murcl_tpu", "torchvision")
CLI = r'''
import runpy, sys
for name in {blocked!r}:
    sys.modules[name] = None
sys.argv = ["export_torchvision_weights", *sys.argv[1:]]
try:
    runpy.run_module("murcl_tpu_torch.scripts.export_torchvision_weights", run_name="__main__")
finally:
    bad = sorted(m for m, v in sys.modules.items()
                 if v is not None and m.split(".")[0] in {blocked!r})
    print("imported:", bad)
'''
# the extra keys of torchvision's models, which neither mapping reads
EXTRA = {"resnet18": (512, True), "resnet50": (2048, True), "vgg16": (4096, False)}


def torchvision_state_dict(name):
    enc, _ = tr.create_encoder(name)
    gen = torch.Generator().manual_seed(len(name))
    sd = {k: torch.randn(v.shape, generator=gen) for k, v in enc.state_dict().items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = sd[k].abs() + 0.5
    dim, resnet = EXTRA[name]
    if resnet:
        for k in [k for k in sd if k.endswith("running_var")]:
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
        sd["fc.weight"], sd["fc.bias"] = torch.randn(1000, dim), torch.randn(1000)
    else:
        sd["classifier.6.weight"], sd["classifier.6.bias"] = torch.randn(1000, dim), \
            torch.randn(1000)
    return sd


def jax_tree(sd, name):
    if name == "vgg16":
        return jr.vgg16_params_from_torch(sd)
    return jr.resnet_params_from_torch(sd, *tr.RESNET_ARCH[name])


def flat(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items() for kv in flat(v, f"{prefix}/{k}")]
    return [(prefix, tree)]


def pickle_digest(obj) -> str:
    h = hashlib.sha256()

    class Sink:
        write = h.update

    pickle.dump(obj, Sink())
    return h.hexdigest()


@pytest.mark.parametrize("name", ["resnet18", "resnet50", "vgg16"])
def test_export_matches_jax_mapping_without_jax(name, tmp_path):
    sd = torchvision_state_dict(name)
    want = jax_tree(sd, name)
    got = tr.jax_params_from_state_dict(sd, name)
    fw, fg = flat(want), flat(got)
    assert [k for k, _ in fg] == [k for k, _ in fw]
    for (k, a), (_, b) in zip(fg, fw):
        assert isinstance(a, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    digest = pickle_digest(want)
    assert pickle_digest(got) == digest
    del want, got, fw, fg

    ckpt, out = tmp_path / f"{name}.pth", tmp_path / f"{name}.pkl"
    torch.save(sd, ckpt)
    r = subprocess.run([sys.executable, "-c", CLI.format(blocked=BLOCKED), "--encoder", name,
                        "--state_dict", str(ckpt), "--out", str(out)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "imported: []" in r.stdout
    ckpt.unlink()
    h = hashlib.sha256()
    with open(out, "rb") as fp:
        for chunk in iter(lambda: fp.read(1 << 24), b""):
            h.update(chunk)
    assert h.hexdigest() == digest

    back = tr.state_dict_from_jax(tr.load_params_npz(out), name)
    kept = {k: v for k, v in sd.items() if not k.endswith("num_batches_tracked")
            and not k.startswith(("fc.", "classifier.6."))}
    assert back.keys() == kept.keys()
    for k, v in kept.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k


def test_export_without_torchvision_names_state_dict(tmp_path):
    out = tmp_path / "w.pkl"
    r = subprocess.run([sys.executable, "-c", CLI.format(blocked=BLOCKED), "--out", str(out)],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "--state_dict" in r.stderr and "torchvision" in r.stderr
    assert not out.exists()
