"""CLAM_SB checkpoints saved with dropout off, loaded by the port.

The reference's CLAM_SB builds the Dropout in front of its gated attention
net only when dropout is on, so a checkpoint saved with dropout off holds the
gate keys under ``attention_net.2.*``; the port always builds the
``attention_net.3`` layout. ``transfer_state`` must load such a file's gates
exactly as the JAX package imports them
(``murcl_tpu.engine.torch_import.import_model_state``, which reads either
layout), and leave a file that holds ``attention_net.3.*`` as it is.
"""

import pytest
import torch

import murcl_tpu_torch.models.clam as torch_clam
from murcl_tpu.engine.torch_import import import_model_state
from murcl_tpu_torch.engine.checkpoint import transfer_state
from murcl_tpu_torch.engine.weights import params_from_jax
from murcl_tpu_torch.models import CLAM_SB

DIM = 16


@pytest.fixture()
def tiny(monkeypatch):
    monkeypatch.setitem(torch_clam.SIZE_DICT, "tiny", (32, 16))


def _clam(seed):
    torch.manual_seed(seed)
    return CLAM_SB(in_dim=DIM, size_arg="tiny")


def _dropout_off(sd):
    """``sd`` in the reference's dropout-off layout."""
    return {k.replace("attention_net.3.", "attention_net.2.", 1): v for k, v in sd.items()}


@pytest.mark.parametrize("wrap", ["", "module.", "encoder."])
def test_dropout_off_layout_loads_the_gates_as_jax_imports_them(tiny, wrap):
    src = _dropout_off(_clam(0).state_dict())
    assert any(k.startswith("attention_net.2.attention_b.0.") for k in src)
    assert not any(k.startswith("attention_net.3.") for k in src)
    dst = _clam(1)
    skipped = transfer_state(dst, {wrap + k: v for k, v in src.items()}, verbose=False)
    assert skipped == []
    want, _ = params_from_jax(import_model_state(src, "CLAM_SB"))
    got = dst.state_dict()
    assert want.keys() == got.keys()
    for k, v in got.items():
        assert torch.equal(v, want[k]), k


def test_dropout_on_layout_is_left_as_it_is(tiny):
    """A file that holds ``attention_net.3.*`` loads those keys; a stray
    ``attention_net.2`` gate beside them is not renamed over them."""
    src = _clam(0).state_dict()
    stray = {"attention_net.2.attention_a.0.weight": torch.full_like(
        src["attention_net.3.attention_a.0.weight"], 7.0)}
    dst = _clam(1)
    skipped = transfer_state(dst, {**src, **stray}, verbose=False)
    assert skipped == []
    want, _ = params_from_jax(import_model_state(src, "CLAM_SB"))
    got = dst.state_dict()
    for k, v in got.items():
        assert torch.equal(v, want[k]) and torch.equal(v, src[k]), k
