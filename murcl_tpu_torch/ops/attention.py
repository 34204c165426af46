"""CLAM's fused mixup + trunk + gated attention pool: kernels K2/K3 and their
plain twins, as one :class:`torch.autograd.Function`.

Counterpart of ``murcl_tpu/ops/attention_pallas.py``
``fused_trunk_attention_pool`` on its Pallas route (forward
``_make_fused_trunk_fwd_kernel``, backward ``_make_fused_trunk_bwd_kernel``
with ``need_dh=False``). Per bag ``i``:

    h   = lam_i * h_i + (1 - lam_i) * h[perm_i]      (only with ``mix``)
    xc  = drop(relu(h @ Wf + bf))
    a   = drop(tanh(xc @ Wa + ba)),  g = drop(sigmoid(xc @ Wb + bb))
    s   = (a * g) @ wc + bc,  p = softmax(s masked),  M = p @ xc

returning ``(M (B, L1), p (B, N), s (B, N))`` in float32. ``xc``, ``a``,
``g`` and the backward's ``dx`` chain are rounded to the bag dtype where the
TPU kernels round them; :func:`fused_trunk_plain_fwd` and
:func:`fused_trunk_plain_bwd` round at the same places.

Dropout keeps an element when a 32-bit counter hash of
``(seed, bag, stream, row, col)`` is ``>= min(2**32 - 1, int(rate * 2**32))``
and scales kept ones by ``1 / (1 - rate)``; stream 0 is the trunk, 1 and 2
the gates. :func:`_keep_bits` computes the same bits as
``csrc/common.cuh`` with int64 tensor ops masked to 32 bits, so kernel and
plain version drop the same units and the backward regenerates the
forward's masks. (The TPU drew its masks from its own PRNG, so the port
agrees with the JAX package at dropout 0 only.)

The input bags are data: no gradient is produced for ``h`` (the Function
returns ``None`` for it and refuses an ``h`` that requires grad).
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.ops.mixup import apply_mix

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_TM, _TN, _KC = 32, 128, 32  # csrc/fused_trunk.cu tile constants


def _mul32(x, c: int):
    """``x * c mod 2**32`` for int64 ``x`` in [0, 2**32) without overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h):
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _keep_bits(seed: int, bags, rows: int, cols: int, stream: int):
    """Dropout bits ``(len(bags), rows, cols)`` as int64 in [0, 2**32): bag
    ``i``, element ``(r, c)`` gets ``fmix32(key_i ^ (r*cols + c) * 0x7feb352d)``
    with ``key_i = fmix32(seed ^ (4 i + stream + 1) * 0x9e3779b1)``."""
    key = _fmix32((seed & _M32) ^ _mul32(bags * 4 + stream + 1, 0x9E3779B1))
    idx = _mul32(torch.arange(rows * cols, device=bags.device, dtype=torch.int64),
                 0x7FEB352D)
    return _fmix32(key[:, None] ^ idx[None, :]).reshape(len(bags), rows, cols)


def dropout_threshold(rate: float) -> int:
    return min(2**32 - 1, int(rate * 2**32))


def _keep_scale(seed, rate, b, rows, cols, stream, device, dt):
    """{0, scale} multipliers in ``dt`` (scale taken in f32, then cast)."""
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device).to(dt)
    out = torch.empty((b, rows, cols), dtype=dt, device=device)
    # the int64 bits take 8 bytes per element: build them a few bags at a time
    step = max(1, (1 << 24) // (rows * cols))
    thresh = dropout_threshold(rate)
    for b0 in range(0, b, step):
        bags = torch.arange(b0, min(b, b0 + step), device=device, dtype=torch.int64)
        bits = _keep_bits(seed, bags, rows, cols, stream)
        out[b0:b0 + step] = torch.where(bits >= thresh, scale, torch.zeros_like(scale))
    return out


def _mm(x, w, dt):
    """``x @ w`` with both rounded to ``dt`` and the product taken in f32."""
    return x.to(dt).float() @ w.to(dt).float()


def _trunk(h, wf, bf, wa, ba, wb, bb, dropout, seed):
    """Shared forward/backward recompute: ``(xc, mzx, a, g, a_eff, g_eff)``.

    ``mzx`` folds relu' with the trunk keep mask (the backward's dz factor).
    """
    dt = h.dtype
    b, n, _ = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    z = _mm(h, wf, dt) + bf
    if dropout > 0:
        kx = _keep_scale(seed, dropout, b, n, l1, 0, h.device, dt)
        mzx = torch.where(z > 0, kx, torch.zeros((), dtype=dt, device=h.device))
        xc = z.to(dt) * mzx
    else:
        mzx = (z > 0).to(dt)
        xc = torch.relu(z).to(dt)
    a = torch.tanh(_mm(xc, wa, dt) + ba).to(dt)
    g = torch.sigmoid(_mm(xc, wb, dt) + bb).to(dt)
    if dropout > 0:
        ka = _keep_scale(seed, dropout, b, n, d, 1, h.device, dt)
        kb = _keep_scale(seed, dropout, b, n, d, 2, h.device, dt)
        a_eff, g_eff = a * ka, g * kb
    else:
        ka = kb = None
        a_eff, g_eff = a, g
    return xc, mzx, a, g, a_eff, g_eff, ka, kb


def fused_trunk_plain_fwd(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout=0.0,
                          seed=0, perm=None, lam=None):
    """Plain PyTorch forward (mirror of the TPU forward kernel): ``(M, p, s)``."""
    dt = h.dtype
    if perm is not None:
        h = apply_mix(h, perm, lam)
    xc, _, _, _, a_eff, g_eff, _, _ = _trunk(h, wf, bf, wa, ba, wb, bb, dropout, seed)
    u = a_eff * g_eff
    s = (u.float() @ wc.to(dt).float()) + bc
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, _NEG_INF)), dim=-1)
    m = (p.to(dt).float().unsqueeze(1) @ xc.float()).squeeze(1)
    return m, p, s


def fused_trunk_plain_bwd(h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs,
                          dropout=0.0, seed=0, perm=None, lam=None):
    """Plain PyTorch backward (mirror of the TPU backward kernel, no ``dh``):
    ``(dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc)`` in float32, summed over bags."""
    dt = h.dtype
    if perm is not None:
        h = apply_mix(h, perm, lam)
    xc, mzx, a, g, a_eff, g_eff, ka, kb = _trunk(h, wf, bf, wa, ba, wb, bb, dropout, seed)
    u = a_eff * g_eff

    dp = (xc.float() @ gm.to(dt).float().unsqueeze(-1)).squeeze(-1) + gp
    ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros_like(ds)) + gs
    ds_t = ds.to(dt)
    dbc = ds.sum()
    dwc = torch.einsum("bnd,bn->d", u.float(), ds_t.float())
    du = ds_t.unsqueeze(-1) * wc.to(dt)
    da, dg = du * g_eff, du * a_eff
    if dropout > 0:
        da, dg = da * ka, dg * kb
    dza = da * (1 - a * a)
    dzb = dg * g * (1 - g)

    flat = lambda t: t.reshape(-1, t.shape[-1]).float()  # noqa: E731
    dwa, dba = flat(xc).T @ flat(dza), flat(dza).sum(0)
    dwb, dbb = flat(xc).T @ flat(dzb), flat(dzb).sum(0)
    dx = (p.unsqueeze(-1) * gm.unsqueeze(1)).to(dt) + (dza.float() @ wa.to(dt).float().T).to(dt)
    dx = dx + (dzb.float() @ wb.to(dt).float().T).to(dt)
    dz = dx * mzx
    dwf, dbf = flat(h).T @ flat(dz), flat(dz).sum(0)
    return dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc


def _check_shapes(name, h, wf, wa):
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: bags must be float32 or bfloat16")
    if fin % 64 or l1 % _TN or d % _TN:
        raise ValueError(f"{name}: needs Fin % 64 == 0 and L1, D multiples of {_TN} "
                         f"(got {fin}, {l1}, {d})")
    smem = 4 * max(_TM * (fin + 1) + _TM * (l1 + 1) + _KC * _TN,
                   _TM * (l1 + 1) + 2 * _TM * (d + 1) + _KC * _TN + 2 * _TM + d + 32,
                   n + 32)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: tiles need {smem} bytes of shared memory")


def _cuda_args(h, wf, bf, wa, ba, wb, bb, wc, mask, perm, lam, dropout, seed):
    """Kernel operands: weights in the bag dtype, biases f32, all contiguous."""
    dt = h.dtype
    c = lambda t, ty: t.to(ty).contiguous()  # noqa: E731
    ops = dict(
        h=h.contiguous(), wf=c(wf, dt), bf=c(bf, torch.float32), wa=c(wa, dt),
        ba=c(ba, torch.float32), wb=c(wb, dt), bb=c(bb, torch.float32), wc=c(wc, dt),
        mask=c(mask, torch.bool),
        perm=None if perm is None else c(perm, torch.int64),
        lam=None if lam is None else c(lam, torch.float32))
    drop = (int(dropout > 0), int(seed) & _M32,
            dropout_threshold(dropout) if dropout > 0 else 0,
            float(1.0 / (1.0 - dropout)))
    return ops, drop


def _p(t):
    return None if t is None else t.data_ptr()


def _fwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed, perm, lam):
    name = "fused_trunk_attention_pool"
    _check_shapes(name, h, wf, wa)
    o, drop = _cuda_args(h, wf, bf, wa, ba, wb, bb, wc, mask, perm, lam, dropout, seed)
    bc32 = bc.to(torch.float32).reshape(1).contiguous()
    _cuda.require_cuda(name, *[t for t in o.values() if t is not None], bc32)
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    dev = h.device
    xc = torch.empty((b, n, l1), dtype=h.dtype, device=dev)
    m = torch.empty((b, l1), dtype=torch.float32, device=dev)
    p = torch.empty((b, n), dtype=torch.float32, device=dev)
    s = torch.empty((b, n), dtype=torch.float32, device=dev)
    err = _cuda.library().murcl_fused_trunk_fwd(
        int(h.dtype == torch.bfloat16), _p(o["h"]), _p(o["perm"]), _p(o["lam"]),
        _p(o["wf"]), _p(o["bf"]), _p(o["wa"]), _p(o["ba"]), _p(o["wb"]), _p(o["bb"]),
        _p(o["wc"]), _p(bc32), _p(o["mask"]), *drop, _p(xc), _p(m), _p(p), _p(s),
        b, n, fin, l1, d, _cuda.stream())
    _cuda.check(err, name)
    _cuda.LAUNCHES["fused_trunk_fwd"] += 1
    return m, p, s


def _bwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, dropout, seed,
              perm, lam):
    name = "fused_trunk_attention_pool backward"
    o, drop = _cuda_args(h, wf, bf, wa, ba, wb, bb, wc, mask, perm, lam, dropout, seed)
    waT, wbT = o["wa"].T.contiguous(), o["wb"].T.contiguous()
    p, gm, gp, gs = (t.to(torch.float32).contiguous() for t in (p, gm, gp, gs))
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    dev, dt = h.device, h.dtype
    hm = torch.empty((b, n, fin), dtype=dt, device=dev)
    xc = torch.empty((b, n, l1), dtype=dt, device=dev)
    dz = torch.empty((b, n, l1), dtype=dt, device=dev)
    dza = torch.empty((b, n, d), dtype=dt, device=dev)
    dzb = torch.empty((b, n, d), dtype=dt, device=dev)
    dpv = torch.empty((b, n), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dwf, dbf = torch.empty((fin, l1), **f32), torch.empty((l1,), **f32)
    dwa, dba = torch.empty((l1, d), **f32), torch.empty((d,), **f32)
    dwb, dbb = torch.empty((l1, d), **f32), torch.empty((d,), **f32)
    dwc, dbc = torch.empty((d,), **f32), torch.empty((), **f32)
    _cuda.require_cuda(name, p, gm, gp, gs, waT, wbT)
    err = _cuda.library().murcl_fused_trunk_bwd(
        int(dt == torch.bfloat16), _p(o["h"]), _p(o["perm"]), _p(o["lam"]), _p(o["wf"]),
        _p(o["bf"]), _p(o["wa"]), _p(o["ba"]), _p(o["wb"]), _p(o["bb"]), _p(o["wc"]),
        _p(waT), _p(wbT), _p(o["mask"]), *drop, _p(p), _p(gm), _p(gp), _p(gs), _p(hm),
        _p(xc), _p(dpv), _p(dza), _p(dzb), _p(dz), _p(dwf), _p(dbf), _p(dwa), _p(dba),
        _p(dwb), _p(dbb), _p(dwc), _p(dbc), b, n, fin, l1, d, _cuda.stream())
    _cuda.check(err, name)
    _cuda.LAUNCHES["fused_trunk_bwd"] += 1
    return dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc


class _FusedTrunkAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed, perm, lam):
        if ctx.needs_input_grad[0]:
            raise ValueError("fused_trunk_attention_pool produces no gradient for the "
                             "bags; pass them as data (requires_grad=False)")
        if h.device.type == "cpu":
            m, p, s = fused_trunk_plain_fwd(h, wf, bf, wa, ba, wb, bb, wc, bc, mask,
                                            dropout, seed, perm, lam)
        else:
            m, p, s = _fwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed,
                                perm, lam)
        ctx.save_for_backward(h, wf, bf, wa, ba, wb, bb, wc, mask, p, perm, lam)
        ctx.dropout, ctx.seed = dropout, seed
        return m, p, s

    @staticmethod
    def backward(ctx, gm, gp, gs):
        h, wf, bf, wa, ba, wb, bb, wc, mask, p, perm, lam = ctx.saved_tensors
        args = (h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, ctx.dropout,
                ctx.seed, perm, lam)
        if h.device.type == "cpu":
            grads = fused_trunk_plain_bwd(*args)
        else:
            grads = _bwd_cuda(*args)
        dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc = grads
        return (None, dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc.reshape(()), None, None,
                None, None, None)


def fused_trunk_attention_pool(h, wf, bf, wa, ba, wb, bb, wc, bc, mask=None,
                               dropout: float = 0.0, seed: int = 0, mix=None):
    """CLAM trunk + gated attention pooling in one op: ``(M, p, s)``.

    ``h (B, N, Fin)`` float32 or bfloat16; ``wf (Fin, L1)``, ``wa``/``wb``
    ``(L1, D)``, ``wc (D,)``, biases and ``bc ()`` float32 (weights are
    rounded to the bag dtype). ``mix=(perm, lam)`` mixes bag ``i`` with bag
    ``perm[i]`` (absolute indices) before the trunk. ``seed`` keys the
    dropout masks. CPU tensors take the plain version; CUDA tensors always
    launch K2 (forward) and K3 (backward).
    """
    if mask is None:
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    perm, lam = mix if mix is not None else (None, None)
    return _FusedTrunkAttention.apply(h, wf, bf, wa, ba, wb, bb, wc, bc, mask,
                                      float(dropout), int(seed), perm, lam)
