"""Port's bag mixup (K6's plain twin and the JAX ``mixup`` expression) vs the JAX package.

``mixup_rows`` on CPU tensors against ``murcl_tpu.ops.compact_pallas.mixup_rows``
run in Pallas interpret mode, and ``mixup_ref`` against ``murcl_tpu.ops.mixup.mixup``
at the same draws: bitwise in f32 and in bf16. XLA is told not to keep
excess precision between bf16 ops (it then rounds after each one, as torch's
per-op arithmetic does) and compiles at back-end optimisation level 0, where
its CPU code generator does not contract ``a*b + c*d`` into a fused
multiply-add (the TPU's f32 arithmetic and the CUDA kernel do not either).
``perm_abs`` crosses the (step, view) group offsets the batched stage-1
rollout adds. The two expressions are identical in f32; in bf16 their
``1 - lam`` factors differ by at most one ulp of ``lam``
(``murcl_tpu/ops/mixup.py:39-41``), which bounds how far the results part.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from murcl_tpu.ops import compact_pallas
from murcl_tpu.ops.mixup import mixup as jax_mixup
from murcl_tpu.ops.mixup import mixup_factors as jax_mixup_factors
from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.ops.mixup import apply_mix, mixup_factors, mixup_ref, mixup_rows

GROUPS, B, F, D = 3, 4, 16, 24
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]
NO_EXCESS = {"xla_allow_excess_precision": False, "xla_backend_optimization_level": 0}


def _bags(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(GROUPS * B, F, D)).astype(np.float32) * 3.0
    perms = np.stack([rng.permutation(B) for _ in range(GROUPS)])
    perm_abs = (perms + np.arange(GROUPS)[:, None] * B).reshape(-1)
    lam = (0.9 + 0.1 * rng.random(GROUPS * B)).astype(np.float32)
    return x, perm_abs, lam


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).numpy()


def _jbits(a, tdtype) -> np.ndarray:
    return _bits(torch.tensor(np.asarray(a, np.float32)).to(tdtype))


def _ulp_bf16(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at each |v| (2**(floor(log2 |v|) - 7)); 0 where v is 0."""
    _, e = torch.frexp(v.float())
    return torch.where(v != 0, torch.ldexp(torch.ones_like(v, dtype=torch.float32), e - 8),
                       torch.zeros_like(v, dtype=torch.float32))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_mixup_rows_plain_matches_pallas_interpret(tdtype, jdtype):
    x, perm_abs, lam = _bags(0)
    xj = jnp.asarray(x, jdtype)
    args = (xj, jnp.asarray(perm_abs, jnp.int32), jnp.asarray(lam))
    run = jax.jit(lambda *a: compact_pallas.mixup_rows(*a, interpret=True))
    want = run.lower(*args).compile(compiler_options=NO_EXCESS)(*args)
    got = mixup_rows(torch.tensor(x).to(tdtype), torch.tensor(perm_abs), torch.tensor(lam))
    assert got.dtype == tdtype
    np.testing.assert_array_equal(_bits(got), _jbits(want, tdtype))


@pytest.mark.parametrize("tdtype,jdtype", DTYPES)
def test_mixup_ref_matches_jax_mixup(tdtype, jdtype):
    x, _, _ = _bags(1)
    x = x[:B]
    key = jax.random.PRNGKey(3)
    xj = jnp.asarray(x, jdtype)
    run = jax.jit(lambda k, xx: jax_mixup(k, xx, 0.9))
    want, jlam, jperm = run.lower(key, xj).compile(compiler_options=NO_EXCESS)(key, xj)
    lam, perm = jax_mixup_factors(key, B, 0.9)
    np.testing.assert_array_equal(np.asarray(perm), np.asarray(jperm))
    got = mixup_ref(torch.tensor(x).to(tdtype), torch.tensor(np.asarray(perm)),
                    torch.tensor(np.asarray(lam)[:, 0]))
    np.testing.assert_array_equal(_bits(got), _jbits(want, tdtype))


@pytest.mark.parametrize("tdtype", [torch.float32, torch.bfloat16])
def test_the_two_expressions(tdtype):
    x, perm_abs, lam = _bags(2)
    xt, pt, lt = torch.tensor(x).to(tdtype), torch.tensor(perm_abs), torch.tensor(lam)
    kernel_expr, ref_expr = apply_mix(xt, pt, lt), mixup_ref(xt, pt, lt)
    if tdtype == torch.float32:
        assert torch.equal(kernel_expr, ref_expr)
        return
    lam_b = lt.to(tdtype)
    oml_kernel, oml_ref = (1.0 - lt).to(tdtype).float(), (1.0 - lam_b).float()
    # rnd(1 - lam) against 1 - rnd(lam): half an ulp of each
    d_oml = 0.5 * (_ulp_bf16(lam_b) + _ulp_bf16(oml_kernel))
    assert bool(((oml_kernel - oml_ref).abs() <= d_oml).all())
    assert bool((oml_kernel != oml_ref).any())
    # that on the partner's weight, then the roundings of its product and of
    # the sum
    xp = xt[pt].float()
    shape = (-1,) + (1,) * (xt.dim() - 1)
    partner = oml_kernel.reshape(shape) * xp
    bound = xp.abs() * d_oml.reshape(shape) + _ulp_bf16(partner) + _ulp_bf16(kernel_expr)
    diff = (kernel_expr.float() - ref_expr.float()).abs()
    assert bool((diff <= bound).all())
    assert bool((diff > 0).any())  # the two roundings do part somewhere


def test_mixup_rows_on_cpu_launches_nothing():
    x, perm_abs, lam = _bags(3)
    before = dict(_cuda.LAUNCHES)
    out = mixup_rows(torch.tensor(x), torch.tensor(perm_abs), torch.tensor(lam))
    assert _cuda.LAUNCHES == before
    assert torch.equal(out, apply_mix(torch.tensor(x), torch.tensor(perm_abs),
                                      torch.tensor(lam)))


def test_mixup_factors_range_and_permutation():
    lam, perm = mixup_factors(torch.Generator().manual_seed(0), 64, 0.9)
    assert lam.dtype == torch.float32 and bool(((lam >= 0.9) & (lam <= 1.0)).all())
    assert sorted(perm.tolist()) == list(range(64))
