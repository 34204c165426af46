"""The ports of the JAX package's TPU probes, on the CPU (their plain twins).

``scripts/dbg_bwd_ablate.py``, ``dbg_vpu_lean.py`` and
``dbg_mxu_vpu_overlap.py`` time K2/K3 with parts removed or their
elementwise chains rearranged, and an overlap probe; the port's scripts of
the same names run hand-written variants of its kernels on the card, each
beside a twin (``ops/attention.py`` ``fused_trunk_plain_bwd(variant=...)``,
``fused_trunk_plain_fwd(lean=False)``; ``ops/overlap.py``). Here, at a small
size (B 3, N 40, Fin 32, L1 48, D 16):

- at dropout 0, each K3 variant's kept gradients equal the JAX package's
  (``fused_trunk_attention_pool(impl="xla")`` under ``jax.vjp`` with the
  same cotangents) within 1e-5 relative Frobenius in f32, and those it
  skips are exact zeros;
- at dropout 0.25 each variant's kept gradients equal the full twin's
  bitwise, in f32 and bf16 (nodrop: the full twin's at dropout 0), except
  lean2's dWf and dbf, whose dx is rounded once (1e-6 in f32, 2e-2 in bf16);
- the pre-lean forward equals the lean one bitwise, in f32 and bf16;
- the overlap twins' four modes agree with a jnp restatement of the JAX
  script's ``mxu_chain`` and ``heavy`` (closures inside its ``main()``, so
  restated here) within 1e-2 relative (bf16 chains: XLA's and torch's tanh,
  sigmoid and sums round apart), dep's m equals mxu's bitwise, indep's (m,
  v) equal (mxu's m, vpu's v);
- each script runs end to end with ``--device cpu``, and without a card
  its default device raises.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import murcl_tpu.ops.attention_pallas as gap
from murcl_tpu_torch.ops import attention as tat
from murcl_tpu_torch.ops import overlap as ov
from murcl_tpu_torch.scripts import dbg_bwd_ablate, dbg_mxu_vpu_overlap, dbg_vpu_lean

SHAPE = (3, 40, 32, 48, 16)  # B, N, Fin, L1, D
GRADS = ["dwf", "dbf", "dwa", "dba", "dwb", "dbb", "dwc", "dbc"]
ZERO = {"full": (), "nodrop": (), "prelean": (), "lean2": (),
        "nowgrad": ("dwf", "dbf", "dwa", "dba", "dwb", "dbb"), "nodx": ("dwf", "dbf"),
        "recompute": ("dwf", "dbf", "dwa", "dba", "dwb", "dbb")}


def _case(seed=0):
    b, n, fin, l1, d = SHAPE
    rng = np.random.default_rng(seed)
    t = lambda *shape, sc=1.0: (rng.normal(size=shape) * sc).astype(np.float32)  # noqa: E731
    w = [t(fin, l1, sc=fin ** -0.5), t(l1, sc=0.1), t(l1, d, sc=l1 ** -0.5), t(d, sc=0.1),
         t(l1, d, sc=l1 ** -0.5), t(d, sc=0.1), t(d, sc=d ** -0.5), np.float32(0.05)]
    h = t(b, n, fin)
    mask = np.arange(n)[None, :] < np.array([n, 23, 1])[:, None]
    cots = [t(b, l1), t(b, n, sc=0.1), t(b, n)]
    return h, w, mask, cots


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _twin_bwd(h, w, mask, cots, dtype, rate, variant):
    """The variant's twin on p of the forward it belongs to (nodrop's: at
    dropout 0)."""
    ht, wt, mt = torch.tensor(h).to(dtype), [torch.tensor(x) for x in w], torch.tensor(mask)
    _, p, _ = tat.fused_trunk_plain_fwd(ht, *wt, mt, 0.0 if variant == "nodrop" else rate, 5)
    return tat.fused_trunk_plain_bwd(ht, *wt[:7], mt, p, *[torch.tensor(c) for c in cots],
                                     rate, 5, variant=variant)


@pytest.mark.parametrize("variant", list(ZERO))
def test_bwd_variants_match_jax_at_dropout_0(variant):
    h, w, mask, cots = _case()

    def fwd(*ws):
        return gap.fused_trunk_attention_pool(jnp.asarray(h), *ws, mask=jnp.asarray(mask),
                                              impl="xla", input_grad=False)

    _, vjp = jax.vjp(fwd, *[jnp.asarray(x) for x in w])
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    got = _twin_bwd(h, w, mask, cots, torch.float32, 0.0, variant)
    for name, g, wv in zip(GRADS, got, want):
        g = g.numpy().reshape(np.shape(wv))
        if name in ZERO[variant]:
            assert not g.any(), name
            continue
        assert _rel(g, wv) <= 1e-5, (name, _rel(g, wv))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("variant", list(ZERO))
def test_bwd_variants_keep_the_full_twin_at_dropout(variant, dtype, tol):
    h, w, mask, cots = _case(1)
    got = _twin_bwd(h, w, mask, cots, dtype, 0.25, variant)
    want = _twin_bwd(h, w, mask, cots, dtype, 0.0 if variant == "nodrop" else 0.25, "full")
    for name, g, wv in zip(GRADS, got, want):
        if name in ZERO[variant]:
            assert not g.any(), name
        elif variant == "lean2" and name in ("dwf", "dbf"):  # dx rounded once
            assert _rel(g, wv) <= tol, name
        else:
            assert torch.equal(g, wv), name


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prelean_forward_is_lean_bitwise(dtype):
    h, w, mask, _ = _case(2)
    ht, wt, mt = torch.tensor(h).to(dtype), [torch.tensor(x) for x in w], torch.tensor(mask)
    for a, b in zip(tat.fused_trunk_ablate_fwd("lean", ht, *wt, mt, 0.25, 3),
                    tat.fused_trunk_ablate_fwd("prelean", ht, *wt, mt, 0.25, 3)):
        assert torch.equal(a, b)
    xc_lean = tat._trunk(ht, *wt[:6], 0.25, 3)[0]
    xc_pre = tat._trunk(ht, *wt[:6], 0.25, 3, lean=False)[0]
    assert torch.equal(xc_lean, xc_pre) and (xc_lean == 0).any() and (xc_lean > 0).any()


def _jnp_modes(x, y, w):
    """The JAX script's ``mxu_chain`` and ``heavy`` (closures of its
    ``main()``), restated in jnp, and its four modes' outputs as f32 column
    sums (the script sums in bf16)."""
    def mxu_chain(m):
        for _ in range(ov.PRODUCTS):
            m = jnp.dot(m, w, preferred_element_type=jnp.float32).astype(m.dtype)
        return m

    def heavy(v):
        for _ in range(ov.ROUNDS):
            v32 = v.astype(jnp.float32)
            v = (jnp.tanh(v32) * jax.nn.sigmoid(v32)).astype(jnp.bfloat16)
        return v

    s = lambda t: np.asarray(jnp.sum(t.astype(jnp.float32), axis=1))  # noqa: E731
    m = mxu_chain(x)
    return {"mxu": (s(m), s(y)), "vpu": (s(x), s(heavy(y))), "dep": (s(m), s(heavy(m))),
            "indep": (s(m), s(heavy(y)))}


def test_overlap_twins_match_jax_restatement():
    x, y, w = dbg_mxu_vpu_overlap.inputs(torch.device("cpu"), 3, 64)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)  # noqa: E731
    want = _jnp_modes(j(x), j(y), j(w))
    got = {mode: ov.wgmma_overlap(mode, x, y, w) for mode in ov.MODES}
    for mode in ov.MODES:
        for name, g, wv in zip("mv", got[mode], want[mode]):
            assert g.shape == (3, ov.WIDTH) and g.dtype == torch.float32
            assert _rel(g.numpy(), wv) <= 1e-2, (mode, name, _rel(g.numpy(), wv))
    assert torch.equal(got["dep"][0], got["mxu"][0])
    assert torch.equal(got["indep"][0], got["mxu"][0])
    assert torch.equal(got["indep"][1], got["vpu"][1])


def test_scripts_run_on_cpu(capsys):
    """Each script end to end on the CPU; ``outs`` receives each timed
    call's outputs, here the twins' on the scripts' own inputs."""
    from murcl_tpu_torch.scripts.probes import trunk_inputs

    shape = (2, 32, 32, 128, 128)
    kept = {"bwd": {}, "lean": {}, "overlap": {}}
    times = dbg_bwd_ablate.run("cpu", shape, reps=1, outs=kept["bwd"])
    assert set(times) == {"bfloat16", "float32"}
    assert all(set(t) == set(dbg_bwd_ablate.VARIANTS) for t in times.values())
    h, w, mask, p, cots = trunk_inputs(shape, torch.float32, torch.device("cpu"))
    for v in dbg_bwd_ablate.VARIANTS:
        want = tat.fused_trunk_plain_bwd(h, *w[:7], mask, p, *cots, 0.25, 7, variant=v)
        assert all(torch.equal(g, wv) for g, wv in zip(kept["bwd"]["float32"][v], want)), v
    lean = dbg_vpu_lean.run("cpu", shape, reps=1, outs=kept["lean"])
    assert lean["fwd_max_diff"] == [0.0, 0.0, 0.0]
    assert max(lean["bwd_rel"]["lean"].values()) == 0.0
    assert lean["bwd_rel"]["lean2"]["dwf"] > 0.0
    assert set(lean["ms"]) == set(kept["lean"]) == {"fwd full", "fwd lean", "bwd full",
                                                    "bwd lean", "bwd lean2"}
    assert all(torch.equal(a, b) for a, b in zip(kept["lean"]["bwd lean"],
                                                 kept["bwd"]["bfloat16"]["full"]))
    ovl = dbg_mxu_vpu_overlap.run("cpu", steps=2, rows=16, reps=1, outs=kept["overlap"])
    assert set(ovl) == {*ov.MODES, "overlap", "hidden"}
    assert set(kept["overlap"]) == set(ov.MODES)
    assert ovl["hidden"] == dbg_mxu_vpu_overlap.hidden(ovl)
    x, y, wo = dbg_mxu_vpu_overlap.inputs(torch.device("cpu"), 2, 16)
    for m in ov.MODES:
        assert all(torch.equal(g, wv) for g, wv in zip(kept["overlap"][m],
                                                       ov.overlap_plain(m, x, y, wo))), m
    out = capsys.readouterr().out
    assert "recompute :" in out and "fwd lean-vs-full max|diff|" in out and "verdict:" in out


def test_default_device_is_the_card():
    for mod in (dbg_bwd_ablate, dbg_vpu_lean, dbg_mxu_vpu_overlap):
        assert mod.parse_args([]).device == "cuda:0"
    if not torch.cuda.is_available():  # no fallback to the CPU
        for run in (dbg_bwd_ablate.run, dbg_vpu_lean.run, dbg_mxu_vpu_overlap.run):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                run()
