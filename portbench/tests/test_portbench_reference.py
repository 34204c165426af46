"""The reference against the port's CPU path (the plain twins) at tiny
shapes, on the same draws and weights: selection and compaction, the mixup,
CLAM_SB and ABMIL forward and backward (CLAM's dropout from the hash), the
GRU head, NT-Xent, Adam, and the policy's act."""

from __future__ import annotations

import pytest
import torch

from murcl_tpu_torch.engine.optim import make_optimizer, step as optim_step
from murcl_tpu_torch.models import CL, FullLayer, build_aggregator
from murcl_tpu_torch.models.rlmil import ActorCritic, act
from murcl_tpu_torch.ops.mixup import apply_mix
from murcl_tpu_torch.ops.ntxent import nt_xent_plain
from murcl_tpu_torch.ops.select import select_feats
from portbench import inputs, program
from portbench.reference.model import (Reference, adam_step, aggregator_leaves, head_leaves,
                                       mix, policy_leaves, sub_bags)
from portbench.tests import tiny

TRAFFIC = tiny.traffic(1)
CLAM = tiny.TINY_CLAM
ABMIL = tiny.TINY_ABMIL


def weights(cfg, seed=5, stage=3):
    return inputs.make_weights(cfg, {**TRAFFIC, "stage": stage}, seed, torch.device("cpu"))


def bank(seed=9):
    return inputs.make_bank(TRAFFIC, 32, seed, torch.device("cpu"))


def close(a, b, rel=2e-5, floor=1e-30):
    scale = max(float(b.abs().max()), floor)
    assert float((a - b).abs().max()) <= rel * scale, float((a - b).abs().max()) / scale


def test_selection_and_compaction():
    bk = bank()
    fb = program.feature_bank(bk, TRAFFIC["num_clusters"])
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, 9, (12,), generator=g)
    for feat in (40, 64, 200):  # fewer, about as many and more rows than a slide holds
        actions = torch.rand((12, TRAFFIC["num_clusters"]), generator=g)
        port = select_feats(fb, ids, actions, feat)
        ref = sub_bags(bk.feats, bk.offsets, bk.num_patches, bk.patch_cluster, bk.patch_pos,
                       bk.cluster_sizes, ids, actions, feat)
        assert torch.equal(port, ref)


def test_mixup():
    g = torch.Generator().manual_seed(2)
    x = torch.randn((6, 5, 4), generator=g)
    perm, lam = torch.randperm(6, generator=g), 0.9 + 0.1 * torch.rand(6, generator=g)
    assert torch.equal(apply_mix(x, perm, lam), mix(x, perm, lam))


def _aggregator(cfg, w):
    enc, _ = build_aggregator(cfg["arch"], dim_in=cfg["dim_in"], num_classes=cfg["projection_dim"],
                              arch_setting=program.arch_setting(cfg))
    model = CL(enc, projection_dim=cfg["projection_dim"])
    model.load_state_dict(w["model"])
    return model


@pytest.mark.parametrize("cfg", [CLAM, ABMIL], ids=["clam_sb", "abmil"])
def test_aggregator_forward_backward(cfg):
    w = weights(cfg)
    model = _aggregator(cfg, w)
    model.train()
    g = torch.Generator().manual_seed(3)
    x = torch.randn((6, 40, cfg["dim_in"]), generator=g)
    perm, lam = torch.randperm(6, generator=g), 0.9 + 0.1 * torch.rand(6, generator=g)
    gen = torch.Generator().manual_seed(77)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=torch.Generator().manual_seed(77)))
    if cfg["arch"] == "CLAM_SB":
        m_port, _ = model.encoder(x, mix=(perm, lam), generator=gen)
    else:
        m_port, _ = model.encoder(apply_mix(x, perm, lam), generator=gen)
    cot = torch.randn(m_port.shape, generator=g)
    (m_port * cot).sum().backward()

    ref = Reference(cfg)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in w["model"].items()}
    m_ref = ref.aggregate(leaves, mix(x, perm, lam), seed, 0)
    (m_ref * cot).sum().backward()
    close(m_port.detach(), m_ref.detach())
    named = dict(model.named_parameters())
    # a score's bias under softmax has a gradient of 0 up to rounding: each
    # leaf is held against a thousandth of the largest gradient at least
    floor = 1e-3 * max(float(v.grad.abs().max()) for v in leaves.values() if v.grad is not None)
    for k, v in leaves.items():
        if v.grad is None:  # a head the loss never reaches
            assert named[k].grad is None or not named[k].grad.any()
        else:
            close(named[k].grad, v.grad, 1e-4, floor)


def test_dropout_is_applied():
    """At rate 0 the two sides would agree as well: the masks matter."""
    w = weights(CLAM)
    ref = Reference(CLAM)
    x = torch.randn((2, 16, CLAM["dim_in"]))
    assert not torch.allclose(ref.clam(w["model"], x, 11, 0),
                              ref.clam(w["model"], x, 11, 0, training=False))


def test_gru_head_and_ntxent():
    w = weights(CLAM)
    fc = FullLayer(feature_num=CLAM["L1"], hidden_state_dim=CLAM["fc_hidden_dim"],
                   class_num=CLAM["projection_dim"])
    fc.load_state_dict(w["fc"])
    ref = Reference(CLAM)
    g = torch.Generator().manual_seed(4)
    xa, xb = (torch.randn((6, CLAM["L1"]), generator=g) for _ in range(2))
    pa, h = fc(xa)
    pb, h2 = fc(xb, h)
    ra, rh = ref.head(w["fc"], xa)
    rb, rh2 = ref.head(w["fc"], xb, rh)
    for a, b in ((pa, ra), (pb, rb), (h2, rh2)):
        close(a.detach(), b.detach())
    close(nt_xent_plain(pa, pb, 0.7).detach(), ref.nt_xent(ra, rb, 0.7).detach())


def test_adam_with_decay():
    w = weights(CLAM, stage=1)
    model = _aggregator(CLAM, w)
    fc = FullLayer(feature_num=CLAM["L1"], hidden_state_dim=CLAM["fc_hidden_dim"],
                   class_num=CLAM["projection_dim"])
    fc.load_state_dict(w["fc"])
    opt = make_optimizer(model, fc, "Adam", backbone_lr=1e-3, fc_lr=5e-4, beta1=0.9,
                         beta2=0.999, wdecay=1e-5)
    params = {k: v.detach().clone() for grp in ("model", "fc") for k, v in w[grp].items()}
    lrs = {k: 1e-3 if k.startswith("encoder.") else 5e-4 for k in params}
    named = {**dict(model.named_parameters()), **dict(fc.named_parameters())}
    state: dict = {}
    g = torch.Generator().manual_seed(6)
    for t in range(1, 4):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()
                 if "classifiers" not in k}  # the dead heads get none
        for k, p in named.items():
            p.grad = grads[k].clone() if k in grads else None
        optim_step(opt)
        adam_step(params, grads, state, lrs, t, 0.9, 0.999, 1e-5)
    for k, p in named.items():
        close(p.detach(), params[k], 1e-6)


def test_policy_act():
    w = weights(CLAM)
    k = TRAFFIC["num_clusters"]
    pol = ActorCritic(CLAM["L1"], CLAM["policy_hidden_dim"], k, 0.5)
    pol.load_state_dict(w["policy"])
    ref = Reference(CLAM)
    g = torch.Generator().manual_seed(8)
    state = torch.randn((6, CLAM["L1"]), generator=g)
    hidden = torch.zeros((6, CLAM["policy_hidden_dim"]))
    noise = torch.randn((6, k), generator=g)
    action, new_h, _ = act(pol, state, hidden, noise=noise)
    mean, rh = ref.policy_mean(w["policy"], state, hidden)
    close(new_h, rh)
    close(action, (mean + noise * 0.5).clamp(0.0, 1.0))


def test_layouts_load_strictly():
    """The reference's leaves are the port's parameters, name for name."""
    for cfg in (CLAM, ABMIL):
        assert [n for n, _ in aggregator_leaves(cfg)] == list(
            _aggregator(cfg, weights(cfg)).state_dict())
        assert len(head_leaves(cfg)) == 6 and len(policy_leaves(cfg, 4)) == 12
