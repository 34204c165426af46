"""Attention pooling kernels and their plain twins, each as one
:class:`torch.autograd.Function`: CLAM's fused mixup + trunk + attention
pool (K2/K3) and the attention pool over a bag that is already the trunk's
output (K7, :func:`gated_attention_pool`, at the end of the module).

Counterpart of ``murcl_tpu/ops/attention_pallas.py``
``fused_trunk_attention_pool`` on its Pallas route (forward
``_make_fused_trunk_fwd_kernel`` ``:563``, backward
``_make_fused_trunk_bwd_kernel`` ``:642``). Per bag ``i``:

    h   = lam_i * h_i + (1 - lam_i) * h[perm_i]      (only with ``mix``)
    xc  = drop(relu(h @ Wf + bf))
    a   = drop(tanh(xc @ Wa + ba)),  g = drop(sigmoid(xc @ Wb + bb))
    u   = a * g, or a with ``gated=False`` (Wb, bb unused; zero gradients)
    s   = u @ wc + bc,  p = softmax(s masked),  M = p @ xc

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

An ``h`` that requires grad gets ``dh = dz @ Wf^T`` (the TPU kernel's
``need_dh=True``, ``attention_pallas.py:797-800``), rounded to the bag dtype.
The TPU kernel takes any width; the port's kernels take Fin in multiples of
64 (128 with dh) and L1 and D in multiples of 128, and the wrappers zero-pad
the rest (:func:`pad_trunk_fin`, :func:`pad_trunk_widths`), the dropout hash
keeping the logical L1 and D as its row strides.
With ``mix`` the bags must be data: the partner bag's share of ``dh`` would
need a scatter, so the op refuses an ``h`` that requires grad, as
``attention_pallas.py:647-650`` does.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda
from murcl_tpu_torch.ops.mixup import apply_mix

_NEG_INF = -1e30
_M32 = 0xFFFFFFFF
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
# the column tile of the attention kernels' passes (csrc/tiles.cuh TN), the
# rows over which K8 keeps a running max, and the rows of its chunks' tiles
_TM, _TN, _K8_ROWS = 32, 128, 64
# csrc/wgmma_tiles.cuh (K2/K3, K7): stages of 16 KB slices (128 x 64 bf16)
# of A and B, three 8-byte barriers a stage, as many stages as fit
# (at most 6, at least 3 unless said) beside 1,024 bytes of alignment, the
# output staging (two warpgroups' 16 KB tiles), the dropout keep bits (two
# buffers of 64 per consumer thread) with five barriers (the bits' four and
# a kernel's own) and the kernel's arrays
_WG_SLICE, _WG_OUT, _WG_MAX_STAGES, _WG_MIN_STAGES = 128 * 64 * 2, 2 * 64 * 128 * 2, 6, 3
_WG_BITS = 2 * 256 * 8 + 5 * 8


def _wg_plan(stage: int, staging: int, extra: int, min_stages: int = _WG_MIN_STAGES):
    """``(stages, bytes)`` of one bf16 warpgroup kernel (``plan`` in
    ``csrc/wgmma_tiles.cuh``): as many ring stages of ``stage`` bytes as fit
    beside ``staging`` bytes of output tiles and ``extra`` bytes of arrays,
    at most 6; a plan that fits fewer than ``min_stages`` is reckoned at
    ``min_stages``, over the limit."""
    fixed = 1024 + staging + _WG_BITS + extra
    stages = min(_WG_MAX_STAGES, (_SMEM_LIMIT - fixed) // (stage + 24))
    return stages, fixed + max(stages, min_stages) * (stage + 24)


# The JAX package's route rule (``murcl_tpu/ops/attention_pallas.py:483-490``
# and ``:446-459``): a bag block over 6 MiB does not stay resident in the
# TPU's VMEM, so such a bag leaves the fused kernel K2, and a dropout-free one
# streams through K8. The port keeps the rule so that each bag takes the
# counterpart of the kernel it takes in JAX; it is not a GPU limit.
FUSED_RESIDENT_BUDGET = 6 * 1024 * 1024


def fused_trunk_resident(n: int, fin: int, l1: int, itemsize: int) -> bool:
    """True when an unmixed ``(N, max(Fin, L1))`` bag block fits the JAX
    package's fused-kernel budget."""
    return n * max(fin, l1) * itemsize <= FUSED_RESIDENT_BUDGET


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


def _keep_bits(seed: int, bags, rows: int, cols: int, stream: int, stride=None):
    """Dropout bits ``(len(bags), rows, cols)`` as int64 in [0, 2**32): bag
    ``i``, element ``(r, c)`` gets ``fmix32(key_i ^ (r*stride + c) * 0x7feb352d)``
    with ``key_i = fmix32(seed ^ (4 i + stream + 1) * 0x9e3779b1)``. The row
    stride is ``cols`` unless given: K7's kernels hash zero-padded gates at
    the logical width, so that every real unit keeps its bit."""
    key = _fmix32((seed & _M32) ^ _mul32(bags * 4 + stream + 1, 0x9E3779B1))
    ar = lambda k: torch.arange(k, device=bags.device, dtype=torch.int64)  # noqa: E731
    pos = (ar(rows)[:, None] * (stride or cols) + ar(cols)).reshape(-1)
    idx = _mul32(pos, 0x7FEB352D)
    return _fmix32(key[:, None] ^ idx[None, :]).reshape(len(bags), rows, cols)


def dropout_threshold(rate: float) -> int:
    return min(2**32 - 1, int(rate * 2**32))


def _keep_scale(seed, rate, b, rows, cols, stream, device, dt, stride=None):
    """{0, scale} multipliers in ``dt`` (scale taken in f32, then cast) from
    :func:`_keep_bits`' bits."""
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32, device=device).to(dt)
    out = torch.empty((b, rows, cols), dtype=dt, device=device)
    # the int64 bits take 8 bytes per element: build them a few bags at a time
    step = max(1, (1 << 24) // (rows * cols))
    thresh = dropout_threshold(rate)
    for b0 in range(0, b, step):
        bags = torch.arange(b0, min(b, b0 + step), device=device, dtype=torch.int64)
        bits = _keep_bits(seed, bags, rows, cols, stream, stride)
        out[b0:b0 + step] = torch.where(bits >= thresh, scale, torch.zeros_like(scale))
    return out


def _mm(x, w, dt):
    """``x @ w`` with both rounded to ``dt`` and the product taken in f32."""
    return x.to(dt).float() @ w.to(dt).float()


def _kept(v, k, lean: bool):
    """``v`` times its keep multiplier ``k`` (0 or the keep scale, in v's
    dtype), rounded to that dtype: ``lean``, one product; else (the
    ablations' pre-lean chains, ``csrc/fused_trunk.cu`` ``kept``) by the
    keep bit as 0 or 1, then by the scale: the same values."""
    if lean:
        return v * k
    return v * (k != 0).to(v.dtype) * k.amax()


# csrc/fused_trunk.cu kRefine: the f32 route takes z again where |z| is at
# most this times ||h row|| ||Wf column||
_REFINE = 2.0 ** -15


def _trunk_z(h, wf, bf, dt):
    """The trunk's pre-activations ``z = h @ Wf + bf``: in bf16 the product of
    the rounded operands in f32; in float32 the f32 product and, where
    ``|z|`` lies within ``2**-15 ||h row|| ||Wf column||`` of 0 (the
    elements the kernels' f32 route flags), the dot product again in
    float64, ``z + bf`` rounded to f32 once, as ``csrc/fused_trunk.cu``
    ``refine_kernel`` takes it: relu and relu' then see the exact product's
    side of 0 in both (two f32 sums in different orders can put a ``z`` of
    1e-7 on different sides)."""
    z = _mm(h, wf, dt) + bf
    if dt != torch.float32:
        return z
    bound = _REFINE * h.norm(dim=-1, keepdim=True) * wf.norm(dim=0)
    # a zero bound means a zero h row or Wf column: the f32 product is then
    # exactly 0, z exactly bf, and the float64 sum would give the same (the
    # padded rows of a bag, against every column whose bias is 0)
    near = (z.abs() <= bound) & (bound > 0)
    for idx in near.nonzero().split(1 << 16):
        b, n, c = idx.unbind(1)
        exact = (h[b, n].double() * wf[:, c].T.double()).sum(-1) + bf[c].double()
        z[b, n, c] = exact.float()
    return z


def _trunk(h, wf, bf, wa, ba, wb, bb, dropout, seed, gated=True, lean=True, hash_l1=None,
           hash_d=None):
    """Shared forward/backward recompute: ``(xc, mzx, a, g, a_eff, g_eff, ka,
    kb)``; ``g``, ``g_eff`` and ``kb`` are None when ungated.

    ``mzx`` folds relu' with the trunk keep mask (the backward's dz factor).
    ``lean=False`` takes the dropout products as the ablations' pre-lean
    chains do (:func:`_kept`): xc as ``rnd(relu(z))`` by the keep bit, then
    by the scale. ``hash_l1`` / ``hash_d``: the trunk's and the gates'
    dropout hash row strides, L1 and D unless given (the kernels' at widths
    zero-padded by :func:`pad_trunk_widths`).
    """
    dt = h.dtype
    b, n, _ = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    z = _trunk_z(h, wf, bf, dt)
    if dropout > 0:
        kx = _keep_scale(seed, dropout, b, n, l1, 0, h.device, dt, hash_l1)
        mzx = torch.where(z > 0, kx, torch.zeros((), dtype=dt, device=h.device))
        xc = z.to(dt) * mzx if lean else _kept(torch.relu(z).to(dt), kx, False)
    else:
        mzx = (z > 0).to(dt)
        xc = torch.relu(z).to(dt)
    a = torch.tanh(_mm(xc, wa, dt) + ba).to(dt)
    g = torch.sigmoid(_mm(xc, wb, dt) + bb).to(dt) if gated else None
    ka = kb = None
    a_eff, g_eff = a, g
    if dropout > 0:
        ka = _keep_scale(seed, dropout, b, n, d, 1, h.device, dt, hash_d)
        a_eff = _kept(a, ka, lean)
        if gated:
            kb = _keep_scale(seed, dropout, b, n, d, 2, h.device, dt, hash_d)
            g_eff = _kept(g, kb, lean)
    return xc, mzx, a, g, a_eff, g_eff, ka, kb


def fused_trunk_plain_fwd(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout=0.0,
                          seed=0, perm=None, lam=None, gated=True, lean=True, hash_l1=None,
                          hash_d=None):
    """Plain PyTorch forward (mirror of the TPU forward kernel): ``(M, p, s)``.
    ``lean=False``: the pre-lean ablation's twin; ``hash_l1``, ``hash_d``:
    the dropout hash's row strides (:func:`_trunk`)."""
    dt = h.dtype
    if perm is not None:
        h = apply_mix(h, perm, lam)
    xc, _, _, _, a_eff, g_eff, _, _ = _trunk(h, wf, bf, wa, ba, wb, bb, dropout, seed, gated,
                                             lean, hash_l1, hash_d)
    u = a_eff * g_eff if gated else a_eff
    s = (u.float() @ wc.to(dt).float()) + bc
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, _NEG_INF)), dim=-1)
    m = (p.to(dt).float().unsqueeze(1) @ xc.float()).squeeze(1)
    return m, p, s


def softmax_bwd(p, dp, gs, mask):
    """The softmax backward over each bag, as K3's and K7's
    ``softmax_bwd_kernel`` takes it: ``(ds, dbc)``, ``ds = p (dp - c)`` on
    live rows plus ``gs``, in f32 with ``c = sum p dp``, and ``dbc`` the sum
    of ``ds`` over every bag, taken in float64: ``sum gs`` plus each bag's
    softmax part against ``c`` over the bag's own sum of ``p``, which
    cancels to float64's rounding (a shift of every score moves no ``p``;
    in f32 the part carried about 1e-6 a bag, from ``p``'s own sum and
    ``c``'s rounding)."""
    ds = p * (dp - torch.sum(p * dp, dim=-1, keepdim=True))
    ds = torch.where(mask, ds, torch.zeros_like(ds)) + gs
    p64, dp64 = p.double(), dp.double()
    c = (p64 * dp64).sum(-1, keepdim=True) / torch.where(mask, p64, 0.0).sum(-1, keepdim=True)
    soft = torch.where(mask, p64 * (dp64 - c), 0.0)
    return ds, (gs.double().sum() + soft.sum()).float()


def fused_trunk_plain_bwd(h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs,
                          dropout=0.0, seed=0, perm=None, lam=None, gated=True,
                          need_dh=False, variant="full", hash_l1=None, hash_d=None):
    """Plain PyTorch backward (mirror of the TPU backward kernel):
    ``(dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc)`` in float32, summed over bags
    (``dwb``/``dbb`` zeros when ungated), and with ``need_dh`` a ninth entry,
    ``dh`` in the bag dtype. ``variant`` names an ablation's twin
    (:data:`TRUNK_BWD_VARIANTS`): the passes it skips leave their gradients
    zero, and ``prelean`` and ``lean2`` move roundings as their kernels do.
    ``hash_l1``, ``hash_d``: the dropout hash's row strides (:func:`_trunk`)."""
    if variant not in TRUNK_BWD_VARIANTS:
        raise ValueError(f"fused_trunk_plain_bwd: no variant {variant!r}")
    dt = h.dtype
    if variant == "nodrop":
        dropout = 0.0
    lean = variant != "prelean"
    if perm is not None:
        h = apply_mix(h, perm, lam)
    xc, mzx, a, g, a_eff, g_eff, ka, kb = _trunk(h, wf, bf, wa, ba, wb, bb, dropout, seed,
                                                 gated, lean, hash_l1, hash_d)
    u = a_eff * g_eff if gated else a_eff

    dp = (xc.float() @ gm.to(dt).float().unsqueeze(-1)).squeeze(-1) + gp
    ds, dbc = softmax_bwd(p, dp, gs, mask)
    ds_t = ds.to(dt)
    dwc = torch.einsum("bnd,bn->d", u.float(), ds_t.float())
    f32 = dict(dtype=torch.float32, device=h.device)
    fin, l1, d = wf.shape[0], wf.shape[1], wa.shape[1]
    if variant == "recompute":  # the gates replayed for u; dwc and dbc alone
        return (torch.zeros((fin, l1), **f32), torch.zeros((l1,), **f32),
                torch.zeros((l1, d), **f32), torch.zeros((d,), **f32),
                torch.zeros((l1, d), **f32), torch.zeros((d,), **f32), dwc, dbc)
    du = ds_t.unsqueeze(-1) * wc.to(dt)
    da = du * g_eff if gated else du
    if dropout > 0:
        da = _kept(da, ka, lean)
    dza = da * (1 - a * a)

    flat = lambda t: t.reshape(-1, t.shape[-1]).float()  # noqa: E731
    dwa, dba = flat(xc).T @ flat(dza), flat(dza).sum(0)
    if gated:
        dg = du * a_eff
        if dropout > 0:
            dg = _kept(dg, kb, lean)
        dzb = dg * g * (1 - g)
        dwb, dbb = flat(xc).T @ flat(dzb), flat(dzb).sum(0)
    else:
        dwb, dbb = torch.zeros_like(dwa), torch.zeros_like(dba)
    if variant == "nowgrad":  # the weight-gradient passes sum the biases too
        dwa, dba, dwb, dbb = (torch.zeros_like(t) for t in (dwa, dba, dwb, dbb))
    if variant in ("nowgrad", "nodx"):
        return (torch.zeros((fin, l1), **f32), torch.zeros((l1,), **f32), dwa, dba, dwb, dbb,
                dwc, dbc)
    pgm = p.unsqueeze(-1) * gm.unsqueeze(1)
    back = lambda dz_, w: dz_.float() @ w.to(dt).float().T  # noqa: E731
    if variant == "lean2":  # one f32 sum, one rounding
        dx = (pgm + (back(dza, wa) + back(dzb, wb) if gated else back(dza, wa))).to(dt)
    else:
        dx = pgm.to(dt) + back(dza, wa).to(dt)
        if gated:
            dx = dx + back(dzb, wb).to(dt)
    # pre-lean: dx by the keep bit, then the scale, then relu' (whose product
    # is exact: mzx != 0 is relu' and the keep bit at once)
    dz = dx * mzx if lean or dropout == 0 else _kept(dx, mzx, False)
    dwf, dbf = flat(h).T @ flat(dz), flat(dz).sum(0)
    grads = (dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc)
    if need_dh:
        grads += ((dz.float() @ wf.to(dt).float().T).to(dt),)
    return grads


def trunk_plans(l1: int, d: int, dtype: torch.dtype) -> dict:
    """K2/K3's launch plans at widths ``-> l1 -> d``, ``{kernel: (stages,
    bytes)}``, as ``csrc/fused_trunk.cu`` makes them (``kplan``;
    ``wgrad_wg_launch`` in ``csrc/wgmma_tiles.cuh``). A stage holds a 16 KB
    slice of each operand: in bf16 the trunk's widest (the mixing trunk's:
    the bag's, the partner's and Wf's), at least 3 stages; in float32, each
    operand as its two bf16 planes (:func:`split_bf16`), at least 2 stages.
    Beside the ring, the output staging (two warpgroups' 16 KB tiles, in
    float32 two planes each; ``dh_wg`` writes float32 dh from its
    accumulators) and the kernels' f32 arrays: ``bf``, two rows of ``gm``
    and, in float32, Wf's column norms in the trunk, ``ba``, ``bb``, ``wc``
    (and dwc's partial) in the gates, two rows of ``gm`` in dx. None has a
    term in N or Fin."""
    x3 = dtype == torch.float32
    planes, least = (2, 2) if x3 else (1, 3)

    def plan(slices: int, staged: bool, floats: int):
        return _wg_plan(planes * slices * _WG_SLICE, planes * _WG_OUT if staged else 0,
                        4 * floats, least)

    return {"trunk_wg": plan(2 if x3 else 3, True, (4 if x3 else 3) * l1),
            "gates_fwd_wg": plan(2, False, 3 * d),
            "gates_bwd_wg": plan(2, True, 4 * d),
            "dx_wg": plan(2, True, 2 * l1),
            "dh_wg": plan(2, not x3, 0),
            "wgrad_wg": plan(2, False, 0)}


def trunk_tile_smem(n: int, fin: int, l1: int, d: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory the widest block of K2/K3 takes at bags of
    ``n`` rows and widths ``fin -> l1 -> d``: the widest of
    :func:`trunk_plans` (the bag dtype's route: bf16, or float32 as three
    bf16 products, the CLIs' and the runbook's default), the pool pass's
    ``n + 32`` floats and, in float32, ``refine_kernel``'s row and column of
    ``fin`` floats for each of its 4 warps."""
    tiles = max(nb for _, nb in trunk_plans(l1, d, dtype).values())
    refine = 4 * 2 * fin * 4 if dtype == torch.float32 else 0
    return max(tiles, 4 * (n + 32), refine)


def trunk_fin(fin: int, need_dh: bool = False) -> int:
    """The feature width K2/K3's kernels take for bags of width ``fin``: the
    next multiple of 64 (the trunk's k-slices), of 128 with the bags'
    gradient (dh's 128-column passes)."""
    q = _TN if need_dh else 64
    return -(-fin // q) * q


def pad_trunk_fin(h, wf, need_dh: bool = False):
    """``(h, wf)`` at :func:`trunk_fin`'s width: h's last axis and Wf's rows
    zero-padded, each as given where ``fin`` is already so (the CLIs' 512,
    1024, 2048 and 4096 copy nothing). Exact: a zero column of h meets a zero
    row of Wf, and the trunk's dropout hash runs over (N, L1), not Fin, so
    the keep bits do not move; dh and dWf are sliced back."""
    fin = h.shape[-1]
    fp = trunk_fin(fin, need_dh)
    if fp == fin:
        return h, wf
    pad = torch.nn.functional.pad
    return pad(h, (0, fp - fin)), pad(wf, (0, 0, 0, fp - fin))


def pad_trunk_widths(wf, bf, wa, ba, wb, bb, wc):
    """K2/K3's weights at widths the kernels take: L1 and D zero-padded to
    multiples of 128 (Wf's columns and ``bf`` to L1; Wa's and Wb's rows to
    L1 and columns to D; ``ba``, ``bb`` and ``wc`` to D), each as given
    where its widths are already so (the CLIs' 512 -> 256 and 512 -> 384
    copy nothing). Exact: a padded trunk unit has ``relu(0 + 0) = 0`` and
    meets a zero row of Wa and Wb; a padded gate has ``tanh(0) sigmoid(0)
    = 0`` and meets ``wc = 0``. The kernels hash the dropout at the logical
    L1 and D (the twins' ``hash_l1``, ``hash_d``), so every real unit keeps
    its bit; the gradients are sliced back."""
    l1, d = wa.shape
    lp, dp = _padded(l1), _padded(d)
    if (lp, dp) == (l1, d):
        return wf, bf, wa, ba, wb, bb, wc
    pad = torch.nn.functional.pad
    wf, bf = pad(wf, (0, lp - l1)), pad(bf, (0, lp - l1))
    wa, wb = (pad(w, (0, dp - d, 0, lp - l1)) for w in (wa, wb))
    ba, bb, wc = (pad(v, (0, dp - d)) for v in (ba, bb, wc))
    return wf, bf, wa, ba, wb, bb, wc


def _check_shapes(name, h, wf, wa, need_dh=False):
    """K2/K3's rule: the tiles' shared memory at the widths the kernels take
    (any Fin, L1 and D, zero-padded by :func:`pad_trunk_fin` and
    :func:`pad_trunk_widths`)."""
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: bags must be float32 or bfloat16")
    smem = trunk_tile_smem(n, trunk_fin(fin, need_dh), _padded(l1), _padded(d), h.dtype)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: tiles need {smem} bytes of shared memory at (N, Fin, L1, "
                         f"D) = ({n}, {fin}, {l1}, {d}) in {h.dtype}")


def _cuda_args(h, wf, bf, wa, ba, wb, bb, wc, mask, perm, lam, dropout, seed):
    """Kernel operands: weights in the bag dtype, biases f32, the mask (B, N)
    (one broadcast over the bags is written out: the kernels read a bag's
    row of it), all contiguous."""
    dt = h.dtype
    c = lambda t, ty: t.to(ty).contiguous()  # noqa: E731
    ops = dict(
        h=h.contiguous(), wf=c(wf, dt), bf=c(bf, torch.float32), wa=c(wa, dt),
        ba=c(ba, torch.float32), wb=c(wb, dt), bb=c(bb, torch.float32), wc=c(wc, dt),
        mask=c(mask.expand(h.shape[:2]), torch.bool),
        perm=None if perm is None else c(perm, torch.int64),
        lam=None if lam is None else c(lam, torch.float32))
    drop = (int(dropout > 0), int(seed) & _M32,
            dropout_threshold(dropout) if dropout > 0 else 0,
            float(1.0 / (1.0 - dropout)))
    return ops, drop


def _p(t):
    return None if t is None else t.data_ptr()


def _planes_scratch(h, wf, wa, *widths):
    """The scratch of the float32 route (``csrc/fused_trunk.cu``): bf16
    ``(2, B, N, w)`` planes per width in ``widths``, then ``x3``, bytes for
    the weights' planes (bf16: Wf's, Wa's, Wb's), the refine masks (a bit
    per trunk element) and, in f32, the bags' row norms, Wf's column norms
    and Wf^T (``split_inputs``)."""
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    new = lambda *shape: torch.empty(shape, dtype=torch.bfloat16, device=h.device)  # noqa: E731
    x3 = 4 * (fin * l1 + 2 * l1 * d) + b * n * l1 // 8 + 4 * (b * n + l1 + l1 * fin)
    return [new(2, b, n, w) for w in widths] + [torch.empty(x3, dtype=torch.uint8,
                                                            device=h.device)]


def _fwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed, perm, lam, gated=True,
              variant=None):
    """K2: ``(M, p, s)`` of :func:`fused_trunk_plain_fwd`; with ``variant``
    (:data:`TRUNK_FWD_VARIANTS`) the ablation's entry point, counted under
    its own name."""
    name = "fused_trunk_attention_pool"
    _check_shapes(name, h, wf, wa)
    l1_l, d_l = wa.shape
    h, wf = pad_trunk_fin(h, wf)
    wf, bf, wa, ba, wb, bb, wc = pad_trunk_widths(wf, bf, wa, ba, wb, bb, wc)
    o, drop = _cuda_args(h, wf, bf, wa, ba, wb, bb, wc, mask, perm, lam, dropout, seed)
    bc32 = bc.to(torch.float32).reshape(1).contiguous()
    _cuda.require_cuda(name, *[t for t in o.values() if t is not None], bc32)
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    dev = h.device
    if h.dtype == torch.bfloat16:
        xc = torch.empty((b, n, l1), dtype=h.dtype, device=dev)
        # the mixed bag, which the trunk's later column passes read
        hm = torch.empty((b, n, fin), dtype=h.dtype, device=dev) if perm is not None else None
        x3 = None
    else:  # xc's planes, the (mixed) bags' planes, the weights' planes
        xc, hm, x3 = _planes_scratch(h, wf, wa, l1, fin)
    m = torch.empty((b, l1), dtype=torch.float32, device=dev)
    p = torch.empty((b, n), dtype=torch.float32, device=dev)
    s = torch.empty((b, n), dtype=torch.float32, device=dev)
    args = (int(h.dtype == torch.bfloat16), int(gated), _p(o["h"]), _p(o["perm"]), _p(o["lam"]),
            _p(o["wf"]), _p(o["bf"]), _p(o["wa"]), _p(o["ba"]), _p(o["wb"]), _p(o["bb"]),
            _p(o["wc"]), _p(bc32), _p(x3), _p(o["mask"]), *drop, _p(xc), _p(hm), _p(m), _p(p),
            _p(s), b, n, fin, l1, d, l1_l, d_l, _cuda.stream())
    if variant is None:
        _cuda.check(_cuda.library().murcl_fused_trunk_fwd(*args), name)
        _cuda.LAUNCHES["fused_trunk_fwd"] += 1
    else:
        _cuda.check(_cuda.probe_library().murcl_fused_trunk_fwd_ablate(
            TRUNK_FWD_VARIANTS[variant], *args), name)
        _cuda.LAUNCHES[f"trunk_fwd_{variant}"] += 1
    return _unpad(m, l1_l), p, s


def _bwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, dropout, seed,
              perm, lam, gated=True, need_dh=False, variant=None):
    """K3: the grads of :func:`fused_trunk_plain_bwd`, in its order; with
    ``variant`` (:data:`TRUNK_BWD_VARIANTS`) the ablation's entry point,
    counted under its own name."""
    name = "fused_trunk_attention_pool backward"
    _check_shapes(name, h, wf, wa, need_dh)
    fin_l, (l1_l, d_l) = h.shape[-1], wa.shape
    h, wf = pad_trunk_fin(h, wf, need_dh)
    wf, bf, wa, ba, wb, bb, wc = pad_trunk_widths(wf, bf, wa, ba, wb, bb, wc)
    gm = torch.nn.functional.pad(gm, (0, wa.shape[0] - l1_l)) if wa.shape[0] != l1_l else gm
    if variant == "nodrop":
        dropout = 0.0
    o, drop = _cuda_args(h, wf, bf, wa, ba, wb, bb, wc, mask, perm, lam, dropout, seed)
    p, gm, gp, gs = (t.to(torch.float32).contiguous() for t in (p, gm, gp, gs))
    b, n, fin = h.shape
    l1, d = wf.shape[1], wa.shape[1]
    dev, dt = h.device, h.dtype
    wz = 2 * d if gated else d  # [dza | dzb] side by side, or dza
    if dt == torch.bfloat16:
        # weights read as stored; the mixed bag only when mixed (dWf reads h
        # itself otherwise)
        new = lambda *shape: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
        xc, dz, dza = new(b, n, l1), new(b, n, l1), new(b, n, wz)
        hm = new(b, n, fin) if perm is not None else None
        x3 = None
    else:  # each as its two bf16 planes, and the weights' planes
        xc, dz, dza, hm, x3 = _planes_scratch(h, wf, wa, l1, l1, wz, fin)
    dh = torch.empty((b, n, fin), dtype=dt, device=dev) if need_dh else None
    # dp's partials per 128 columns of L1, then ds
    dpv = torch.empty((l1 // _TN + 1, b, n), dtype=torch.float32, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dwf, dbf = torch.empty((fin, l1), **f32), torch.empty((l1,), **f32)
    dwa, dba = torch.empty((l1, d), **f32), torch.empty((d,), **f32)
    dwb, dbb = torch.empty((l1, d), **f32), torch.empty((d,), **f32)
    dwc, dbc = torch.empty((d,), **f32), torch.empty((), **f32)
    _cuda.require_cuda(name, p, gm, gp, gs)
    args = (int(dt == torch.bfloat16), int(gated), _p(o["h"]), _p(o["perm"]), _p(o["lam"]),
            _p(o["wf"]), _p(o["bf"]), _p(o["wa"]), _p(o["ba"]), _p(o["wb"]), _p(o["bb"]),
            _p(o["wc"]), _p(x3), _p(o["mask"]), *drop, _p(p), _p(gm), _p(gp), _p(gs), _p(hm),
            _p(xc), _p(dpv), _p(dza), _p(dz), _p(dh), _p(dwf), _p(dbf), _p(dwa), _p(dba),
            _p(dwb), _p(dbb), _p(dwc), _p(dbc), b, n, fin, l1, d, l1_l, d_l, _cuda.stream())
    if variant is None:
        _cuda.check(_cuda.library().murcl_fused_trunk_bwd(*args), name)
        _cuda.LAUNCHES["fused_trunk_bwd"] += 1
    else:
        _cuda.check(_cuda.probe_library().murcl_fused_trunk_bwd_ablate(
            TRUNK_BWD_VARIANTS[variant], *args), name)
        _cuda.LAUNCHES[f"trunk_bwd_{variant}"] += 1
    if fin != fin_l:
        dh = _unpad(dh, fin_l) if need_dh else dh
    if (fin, l1, d) != (fin_l, l1_l, d_l):
        dwf, dwa, dwb = (w[:r, :c].contiguous() for w, r, c in
                         ((dwf, fin_l, l1_l), (dwa, l1_l, d_l), (dwb, l1_l, d_l)))
        dbf, dba, dbb, dwc = dbf[:l1_l], dba[:d_l], dbb[:d_l], dwc[:d_l]
    grads = (dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc)
    return grads + (dh,) if need_dh else grads


class _FusedTrunkAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed, perm, lam, gated):
        if ctx.needs_input_grad[0] and perm is not None:
            raise ValueError("fused_trunk_attention_pool with mix produces no gradient for "
                             "the bags; pass them as data (requires_grad=False)")
        if h.device.type == "cpu":
            m, p, s = fused_trunk_plain_fwd(h, wf, bf, wa, ba, wb, bb, wc, bc, mask,
                                            dropout, seed, perm, lam, gated)
        else:
            m, p, s = _fwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed,
                                perm, lam, gated)
        ctx.save_for_backward(h, wf, bf, wa, ba, wb, bb, wc, mask, p, perm, lam)
        ctx.dropout, ctx.seed, ctx.gated = dropout, seed, gated
        return m, p, s

    @staticmethod
    def backward(ctx, gm, gp, gs):
        h, wf, bf, wa, ba, wb, bb, wc, mask, p, perm, lam = ctx.saved_tensors
        need_dh = ctx.needs_input_grad[0]
        args = (h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, ctx.dropout,
                ctx.seed, perm, lam, ctx.gated, need_dh)
        if h.device.type == "cpu":
            grads = fused_trunk_plain_bwd(*args)
        else:
            grads = _bwd_cuda(*args)
        dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc = grads[:8]
        dh = grads[8] if need_dh else None
        return (dh, dwf, dbf, dwa, dba, dwb, dbb, dwc, dbc.reshape(()), None, None,
                None, None, None, None)


def fused_trunk_attention_pool(h, wf, bf, wa, ba, wb, bb, wc, bc, mask=None,
                               dropout: float = 0.0, seed: int = 0, mix=None,
                               gated: bool = True):
    """CLAM trunk + attention pooling in one op: ``(M, p, s)``.

    ``h (B, N, Fin)`` float32 or bfloat16; ``wf (Fin, L1)``, ``wa``/``wb``
    ``(L1, D)``, ``wc (D,)``, biases and ``bc ()`` float32 (weights are
    rounded to the bag dtype). ``gated=False`` scores ``tanh`` alone and
    ignores ``wb``/``bb``. ``mix=(perm, lam)`` mixes bag ``i`` with bag
    ``perm[i]`` (absolute indices) before the trunk; without it, an ``h``
    that requires grad gets its gradient. ``seed`` keys the dropout masks.
    CPU tensors take the plain version; CUDA tensors always launch K2
    (forward) and K3 (backward).
    """
    if mask is None:
        mask = torch.ones(h.shape[:2], dtype=torch.bool, device=h.device)
    perm, lam = mix if mix is not None else (None, None)
    return _FusedTrunkAttention.apply(h, wf, bf, wa, ba, wb, bb, wc, bc, mask,
                                      float(dropout), int(seed), perm, lam, bool(gated))


# ---------------------------------------------------------------------------
# K2/K3's ablations: the ports of the JAX package's TPU probes
# ---------------------------------------------------------------------------
# ``scripts/dbg_vpu_lean.py`` (``run_fwd`` ``:122``, ``run_bwd`` ``:280``) and
# ``scripts/dbg_bwd_ablate.py`` (``run_bwd`` ``:152``) time K2/K3 with parts
# removed or their elementwise chains rearranged; the port's scripts of the
# same names (``murcl_tpu_torch/scripts/``) run these variants of K2/K3
# (``csrc/fused_trunk.cu`` ``murcl_fused_trunk_fwd_ablate`` and
# ``murcl_fused_trunk_bwd_ablate``), each beside its twin here. Forward:
# ``lean`` the production kernels, ``prelean`` the trunk's and gates'
# epilogues with relu, the 0/1 keep and the scale as separate rounded
# products (the same values). Backward: ``full`` the production kernels,
# ``nodrop`` at dropout 0, ``nowgrad`` without the two weight-gradient
# passes (dWf, dbf, dWa, dba, dWb and dbb zero: the kernel sums the biases
# there), ``nodx`` without dx_wg and dWf's pass (dWf, dbf zero),
# ``recompute`` the trunk, the softmax backward and a gate pass that sums
# dwc alone (only dwc and dbc), ``prelean`` the pre-lean chains, ``lean2``
# dx's three terms in one f32 sum, rounded once (bf16; float32 has one
# accumulator already). They are measurement probes; no training path
# takes them.
TRUNK_FWD_VARIANTS = {"lean": 0, "prelean": 1}
TRUNK_BWD_VARIANTS = {"full": 0, "nodrop": 0, "nowgrad": 1, "nodx": 2, "recompute": 3,
                      "prelean": 4, "lean2": 5}


def fused_trunk_ablate_fwd(variant, h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout=0.0,
                           seed=0, gated=True):
    """K2's ablation ``variant`` (:data:`TRUNK_FWD_VARIANTS`) on unmixed
    bags: ``(M, p, s)``; CPU tensors take the twin
    (:func:`fused_trunk_plain_fwd`, ``lean=False`` for ``prelean``)."""
    if variant not in TRUNK_FWD_VARIANTS:
        raise ValueError(f"fused_trunk_ablate_fwd: no variant {variant!r}")
    if h.device.type == "cpu":
        return fused_trunk_plain_fwd(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed,
                                     gated=gated, lean=variant == "lean")
    return _fwd_cuda(h, wf, bf, wa, ba, wb, bb, wc, bc, mask, dropout, seed, None, None, gated,
                     variant)


def fused_trunk_ablate_bwd(variant, h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs,
                           dropout=0.0, seed=0, gated=True):
    """K3's ablation ``variant`` (:data:`TRUNK_BWD_VARIANTS`) on unmixed
    bags, without dh: the eight gradients of :func:`fused_trunk_plain_bwd`,
    those the variant skips zero; CPU tensors take that twin."""
    if variant not in TRUNK_BWD_VARIANTS:
        raise ValueError(f"fused_trunk_ablate_bwd: no variant {variant!r}")
    args = (h, wf, bf, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, dropout, seed, None, None,
            gated)
    if h.device.type == "cpu":
        return fused_trunk_plain_bwd(*args, variant=variant)
    return _bwd_cuda(*args, variant=variant)


# ---------------------------------------------------------------------------
# K7: attention pool without the trunk (gated or not), with a gradient for x
# ---------------------------------------------------------------------------
# Counterpart of ``murcl_tpu/ops/attention_pallas.py`` ``gated_attention_pool``
# on its Pallas route (forward ``_make_fwd_kernel``, backward
# ``_make_bwd_kernel``). Its rounding points differ from K2/K3: ``a``, ``g``,
# ``u`` and the gate dropout scale stay f32, only Wa/Wb are rounded to the bag
# dtype for the gate products, and wc stays f32. Both dtypes run warpgroup
# products (wgmma) fed by TMA over 128-row tiles (:func:`pool_plans`), and
# K7b's dx, an f32 product in the TPU kernel, takes three bf16 products of
# :func:`split_bf16`'s planes. In float32 (the supervised CLIs' default)
# every product is three bf16 products of the operands' planes, x's written
# by the kernels' ``split_kernel`` (forward and backward: 1.6 GB a pass at
# the supervised shape, (384, 1024, 512) f32) and W's by
# :func:`_w_planes_cuda`, and the dz scratch's planes feed dWa and dWb
# too. K7f's softmax pass holds a bag's N scores
# in shared memory, so K7f takes N up to about 58,000 (``4 (N + 32) <=
# 232,448`` bytes; :func:`pool_tile_smem`); K7b holds no term in N
# (:func:`pool_bwd_tile_smem`) and takes any bag. A dropout-free
# bag over 6 MiB takes K8 instead (:func:`attention_pool_tiled`, at the end
# of the module), by the JAX package's route rule.
# The kernels take F and D in multiples of 128; the JAX kernels take any
# width. The wrappers zero-pad the others (:func:`pad_pool_widths`) and
# slice the outputs back: exact, since a padded gate has u = 0 and wc 0 and
# a zero column of x meets a zero row of W. The dropout hash keeps the
# logical D as its row stride (``hash_width``), so the padded route drops
# the units the twin drops at the logical widths.


def gated_attention_pool_plain_fwd(x, wa, ba, wb, bb, wc, bc, mask, gated=True,
                                   dropout=0.0, seed=0, hash_width=None):
    """Plain PyTorch forward (mirror of the TPU forward kernel): ``(M, p, s)``.
    ``hash_width``: the dropout hash's row stride, D unless given (the
    kernels' at widths zero-padded by :func:`pad_pool_widths`)."""
    dt = x.dtype
    b, n, _ = x.shape
    d = wa.shape[1]
    xf = x.float()
    u = torch.tanh(xf @ wa.to(dt).float() + ba)
    keep = lambda stream: _keep_scale(seed, dropout, b, n, d, stream, x.device,  # noqa: E731
                                      torch.float32, hash_width)
    if dropout > 0:
        u = u * keep(1)
    if gated:
        g = torch.sigmoid(xf @ wb.to(dt).float() + bb)
        if dropout > 0:
            g = g * keep(2)
        u = u * g
    s = u @ wc.float() + bc
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, _NEG_INF)), dim=-1)
    m = (p.to(dt).float().unsqueeze(1) @ xf).squeeze(1)
    return m, p, s


def gated_attention_pool_plain_bwd(x, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, gated=True,
                                   dropout=0.0, seed=0, hash_width=None):
    """Plain PyTorch backward (mirror of the TPU backward kernel):
    ``(dx, dwa, dba, dwb, dbb, dwc, dbc)``; ``dx`` in the bag dtype, the
    rest f32 summed over bags (``dwb``/``dbb`` zeros when ungated);
    ``hash_width`` as in :func:`gated_attention_pool_plain_fwd`."""
    dt = x.dtype
    b, n, f = x.shape
    d = wa.shape[1]
    xf = x.float()
    keep = lambda stream: (_keep_scale(seed, dropout, b, n, d, stream, x.device,  # noqa: E731
                                       torch.float32, hash_width) if dropout > 0 else None)
    a = torch.tanh(xf @ wa.to(dt).float() + ba)
    ka = keep(1)
    a_eff = a * ka if ka is not None else a
    u = a_eff
    if gated:
        g = torch.sigmoid(xf @ wb.to(dt).float() + bb)
        kb = keep(2)
        g_eff = g * kb if kb is not None else g
        u = a_eff * g_eff

    dp = (xf @ gm.to(dt).float().unsqueeze(-1)).squeeze(-1) + gp
    ds, dbc = softmax_bwd(p, dp, gs, mask)
    dwc = torch.einsum("bnd,bn->d", u, ds)
    du = ds.unsqueeze(-1) * wc.float()
    da = du * g_eff if gated else du
    if ka is not None:
        da = da * ka
    dza = da * (1 - a * a)

    flat = lambda t: t.reshape(-1, t.shape[-1])  # noqa: E731
    dwa, dba = flat(xf).T @ flat(dza.to(dt).float()), flat(dza).sum(0)
    dx = p.unsqueeze(-1) * gm.unsqueeze(1) + dza @ wa.float().T
    if gated:
        dg = du * a_eff
        if kb is not None:
            dg = dg * kb
        dzb = dg * g * (1 - g)
        dwb, dbb = flat(xf).T @ flat(dzb.to(dt).float()), flat(dzb).sum(0)
        dx = dx + dzb @ wb.float().T
    else:
        dwb, dbb = torch.zeros_like(dwa), torch.zeros_like(dba)
    return dx.to(dt), dwa, dba, dwb, dbb, dwc, dbc


def split_bf16(t):
    """``(hi, lo)`` in bfloat16 with ``hi = rnd(t)`` and ``lo = rnd(t - hi)``:
    ``hi + lo`` holds ``t`` to about ``2**-16`` relative, so three bf16
    products ``hi_a hi_b + hi_a lo_b + lo_a hi_b``, summed in f32, stand in
    for one f32 product (K7b's dx, K7's float32 route,
    ``csrc/attention_pool.cu``)."""
    hi = t.to(torch.bfloat16)
    return hi, (t.float() - hi.float()).to(torch.bfloat16)


def pool_plans(f: int, d: int, gated: bool, dtype: torch.dtype) -> dict:
    """K7's launch plans at widths ``f -> d``, ``{kernel: (stages, bytes)}``,
    as ``csrc/attention_pool.cu`` makes them (``fwd_plan``, ``bwd_plan``,
    ``dx_plan``; ``wgrad_wg`` K3's): the gate kernels' stages hold a 128-row
    slice of x and a slice of Wa/Wb (in float32 each as its two bf16 planes),
    beside ``ba``, ``bb``, ``wc`` (and the backward's three partials per
    consumer warp, or per warpgroup where eight copies leave fewer than 2
    stages, and two warpgroups' hi and lo staging; at least 2 stages, and
    the float32 forward too); ``pool_dx_wg`` keeps a tile's hi and lo dz
    planes resident (its stages W's two slices) where that leaves 3 stages,
    else streams them (a stage holds the planes' and W's slices, at least
    2), beside one 64-column staging box per warpgroup in bf16 (none in
    float32: dx goes out from the accumulators) and a row of ``gm`` per
    warpgroup. None has a term in N."""
    x3 = dtype == torch.float32
    sl, box = _WG_SLICE, 64 * 64 * 2
    stage = (2 if x3 else 1) * 2 * sl  # a slice of x and of W
    staging = 0 if x3 else 2 * box
    arrays = 16 + 4 * 2 * f  # dx's two barriers, gm per warpgroup
    planes = (2 if gated else 1) * 2 * (d // 64) * sl
    resident = _wg_plan(2 * sl, staging, arrays + 1024 + planes)
    gates_bwd = _wg_plan(stage, 2 * _WG_OUT, 4 * (3 + 8 * 3) * d, 2)
    if gates_bwd[1] > _SMEM_LIMIT:
        gates_bwd = _wg_plan(stage, 2 * _WG_OUT, 4 * (3 + 2 * 3) * d, 2)
    return {"pool_gates_fwd_wg": _wg_plan(stage, 0, 4 * 3 * d, 2 if x3 else 3),
            "pool_gates_bwd_wg": gates_bwd,
            "pool_dx_wg": (resident if resident[1] <= _SMEM_LIMIT
                           else _wg_plan(4 * sl, staging, arrays, 2)),
            "wgrad_wg": _wg_plan(stage, 0, 0, 2 if x3 else 3)}


def pool_tile_smem(n: int, f: int, d: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory the widest block of K7 takes at bags of ``n``
    rows and widths ``f -> d``: the widest plan of :func:`pool_plans` in the
    bag dtype, gated or not, and the pool pass's ``n + 32`` floats."""
    tiles = max(nb for g in (True, False) for _, nb in pool_plans(f, d, g, dtype).values())
    return max(tiles, 4 * (n + 32))


def pool_bwd_tile_smem(f: int, d: int, dtype: torch.dtype) -> int:
    """Bytes of shared memory the widest block of K7b takes at widths
    ``f -> d``, at any bag length: the widest backward plan of
    :func:`pool_plans` in the bag dtype, gated or not. The bag's sum of ``p
    dp`` is taken per bag by its own kernel, so no term grows with N."""
    return max(nb for g in (True, False) for k, (_, nb) in pool_plans(f, d, g, dtype).items()
               if k != "pool_gates_fwd_wg")


def _padded(n: int) -> int:
    """``n`` rounded up to the kernels' multiple of 128."""
    return -(-n // _TN) * _TN


def pad_pool_widths(x, wa, ba, wb, bb, wc):
    """K7's and K8's operands at widths the kernels take: F and D
    zero-padded to multiples of 128 (x's columns and Wa's and Wb's rows; Wa's
    and Wb's columns, ``ba``, ``bb`` and ``wc``), each tensor as given where
    its widths are already so. The pool's outputs are the same on the
    logical columns: a padded gate has ``u = tanh(0) (sigmoid(0)) = 0`` and
    ``wc`` 0, and a zero column of x meets a zero row of W. No width the
    feature extractors give (512, 2048, 4096) copies the bag."""
    f, d = wa.shape
    fp, dp = _padded(f), _padded(d)
    pad = torch.nn.functional.pad
    if fp != f:
        x = pad(x, (0, fp - f))
    if (fp, dp) != (f, d):
        wa, wb = (pad(w, (0, dp - d, 0, fp - f)) for w in (wa, wb))
        ba, bb, wc = (pad(v, (0, dp - d)) for v in (ba, bb, wc))
    return x, wa, ba, wb, bb, wc


def _unpad(t, n: int):
    """``t``'s first ``n`` columns (the last dimension), contiguous."""
    return t if t.shape[-1] == n else t[..., :n].contiguous()


def _check_pool_shapes(name, x, wa, backward=False):
    """K7's rule, at the widths the kernels take (:func:`pad_pool_widths`):
    K7f's blocks, its softmax pass included; with ``backward`` K7b's own
    blocks, which take any bag length."""
    b, n, f = x.shape
    d = wa.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: bags must be float32 or bfloat16")
    fp, dp = _padded(f), _padded(d)
    smem = (pool_bwd_tile_smem(fp, dp, x.dtype) if backward
            else pool_tile_smem(n, fp, dp, x.dtype))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: tiles need {smem} bytes of shared memory at (N, F, D) = "
                         f"({n}, {f}, {d})")


def _pool_args(name, x, wa, ba, wb, bb, wc, mask, dropout, seed, gated):
    """Kernel operands at widths the kernels take (already padded): the
    gate products' Wa/Wb (bf16 bags: rounded to bf16; float32 bags: their
    :func:`_w_planes_cuda` planes, Wb's planes Wa's when ungated), biases and
    wc f32, the mask (B, N) (written out where it is broadcast over the
    bags), all contiguous; and the dropout arguments."""
    c = lambda t, ty: t.to(ty).contiguous()  # noqa: E731
    f32 = torch.float32
    if x.dtype == torch.bfloat16:
        wa_k, wb_k = c(wa, x.dtype), c(wb, x.dtype)
    else:
        wa_k = _w_planes_cuda(name, wa)
        wb_k = _w_planes_cuda(name, wb) if gated else wa_k
    ops = dict(x=x.contiguous(), wa=wa_k, ba=c(ba, f32), wb=wb_k, bb=c(bb, f32), wc=c(wc, f32),
               mask=c(mask.expand(x.shape[:2]), torch.bool))
    drop = (int(dropout > 0), int(seed) & _M32,
            dropout_threshold(dropout) if dropout > 0 else 0, float(1.0 / (1.0 - dropout)))
    return ops, drop


def _x_planes(x):
    """The float32 route's scratch of x's two bf16 planes, ``(2, B, N, F)``
    (``split_kernel`` writes it); None for bf16 bags."""
    if x.dtype == torch.bfloat16:
        return None
    return torch.empty((2, *x.shape), dtype=torch.bfloat16, device=x.device)


def _pool_gates(name, x, wa, ba, wb, bb, wc, bc, mask, gated, dropout, seed, pool):
    """K7f's C entry point on the operands padded to the kernels' widths
    (:func:`pad_pool_widths`): the scores ``s (B, N)`` and, with ``pool``,
    the softmax pass's ``M (B, Fp)`` and ``p (B, N)``; without it the gate
    pass alone (M and p None). Returns the padded operands of
    :func:`_pool_args` with ``(M, p, s)``; counts no launch."""
    d = wa.shape[1]
    x, wa, ba, wb, bb, wc = pad_pool_widths(x, wa, ba, wb, bb, wc)
    o, drop = _pool_args(name, x, wa, ba, wb, bb, wc, mask, dropout, seed, gated)
    bc32 = bc.to(torch.float32).reshape(1).contiguous()
    _cuda.require_cuda(name, *o.values(), bc32)
    b, n, fp = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    s = torch.empty((b, n), **f32)
    m, p = (torch.empty((b, fp), **f32), torch.empty((b, n), **f32)) if pool else (None, None)
    _cuda.check(_cuda.library().murcl_attention_pool_fwd(
        int(x.dtype == torch.bfloat16), int(gated), _p(o["x"]), _p(o["wa"]), _p(o["ba"]),
        _p(o["wb"]), _p(o["bb"]), _p(o["wc"]), _p(bc32), _p(o["mask"]), *drop,
        _p(_x_planes(x)), _p(m), _p(p), _p(s), b, n, fp, wa.shape[1], d, _cuda.stream()), name)
    return o, m, p, s


def _pool_fwd_cuda(x, wa, ba, wb, bb, wc, bc, mask, gated, dropout, seed):
    name = "gated_attention_pool"
    _check_pool_shapes(name, x, wa)
    _, m, p, s = _pool_gates(name, x, wa, ba, wb, bb, wc, bc, mask, gated, dropout, seed,
                             pool=True)
    _cuda.LAUNCHES["attention_pool_fwd"] += 1
    return _unpad(m, wa.shape[0]), p, s


def _pool_bwd_cuda(x, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, gated, dropout, seed):
    """K7b: the grads of :func:`gated_attention_pool_plain_bwd`, in its order."""
    return _pool_bwd_launch(x, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, gated, dropout,
                            seed)[0]


def _pool_bwd_launch(x, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, gated, dropout, seed):
    """K7b's launch: ``(grads, z)``, ``z`` its dz scratch ``(2, B, N, Wg)``
    at the padded widths (:func:`pad_pool_widths`): ``rnd(dz)``, then the
    rest (:func:`split_bf16`), of ``[dza | dzb]`` per row gated (``Wg = 2
    D``) or ``dza`` (``Wg = D``). The dx products take W's two planes
    (:func:`w_planes`), as do the gate products of float32 bags."""
    name = "gated_attention_pool backward"
    _check_pool_shapes(name, x, wa, backward=True)
    f, dl = wa.shape
    x, wa, ba, wb, bb, wc = pad_pool_widths(x, wa, ba, wb, bb, wc)
    gm = torch.nn.functional.pad(gm, (0, x.shape[-1] - f)) if x.shape[-1] != f else gm
    o, drop = _pool_args(name, x, wa, ba, wb, bb, wc, mask, dropout, seed, gated)
    dev, dt = x.device, x.dtype
    b, n, fp = x.shape
    d = wa.shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    if dt == torch.bfloat16:
        wa2 = _w_planes_cuda(name, wa)
        wb2 = _w_planes_cuda(name, wb) if gated else wa2
    else:
        wa2, wb2 = o["wa"], o["wb"]
    dpv = torch.empty((2, b, n), **f32)  # dp, then ds
    z = torch.empty((2, b, n, 2 * d if gated else d), dtype=torch.bfloat16, device=dev)
    xpl = _x_planes(x)
    p, gm, gp, gs = (t.to(torch.float32).contiguous() for t in (p, gm, gp, gs))
    _cuda.require_cuda(name, *o.values(), wa2, wb2, p, gm, gp, gs)
    dx = torch.empty((b, n, fp), dtype=dt, device=dev)
    dwa, dba = torch.empty((fp, d), **f32), torch.empty((d,), **f32)
    dwb, dbb = torch.empty((fp, d), **f32), torch.empty((d,), **f32)
    dwc, dbc = torch.empty((d,), **f32), torch.empty((), **f32)
    err = _cuda.library().murcl_attention_pool_bwd(
        int(dt == torch.bfloat16), int(gated), _p(o["x"]), _p(o["wa"]), _p(o["ba"]),
        _p(o["wb"]), _p(o["bb"]), _p(o["wc"]), _p(wa2), _p(wb2), _p(o["mask"]), *drop, _p(p),
        _p(gm), _p(gp), _p(gs), _p(dpv), _p(z), _p(xpl), _p(dx), _p(dwa), _p(dba), _p(dwb),
        _p(dbb), _p(dwc), _p(dbc), b, n, fp, d, dl, _cuda.stream())
    _cuda.check(err, name)
    _cuda.LAUNCHES["attention_pool_bwd"] += 1
    if (fp, d) != (f, dl):
        dwa, dwb = (w[:f, :dl].contiguous() for w in (dwa, dwb))
        dx, dba, dbb, dwc = _unpad(dx, f), dba[:dl], dbb[:dl], dwc[:dl]
    return (dx, dwa, dba, dwb, dbb, dwc, dbc), z


class _AttentionPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wa, ba, wb, bb, wc, bc, mask, gated, dropout, seed):
        if x.device.type == "cpu":
            m, p, s = gated_attention_pool_plain_fwd(x, wa, ba, wb, bb, wc, bc, mask, gated,
                                                     dropout, seed)
        else:
            m, p, s = _pool_fwd_cuda(x, wa, ba, wb, bb, wc, bc, mask, gated, dropout, seed)
        ctx.save_for_backward(x, wa, ba, wb, bb, wc, mask, p)
        ctx.gated, ctx.dropout, ctx.seed = gated, dropout, seed
        return m, p, s

    @staticmethod
    def backward(ctx, gm, gp, gs):
        x, wa, ba, wb, bb, wc, mask, p = ctx.saved_tensors
        args = (x, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, ctx.gated, ctx.dropout, ctx.seed)
        if x.device.type == "cpu":
            dx, dwa, dba, dwb, dbb, dwc, dbc = gated_attention_pool_plain_bwd(*args)
        else:
            dx, dwa, dba, dwb, dbb, dwc, dbc = _pool_bwd_cuda(*args)
        return dx, dwa, dba, dwb, dbb, dwc, dbc.reshape(()), None, None, None, None


def gated_attention_pool(x, wa, ba, wb, bb, wc, bc, mask=None, gated: bool = True,
                         dropout: float = 0.0, seed: int = 0):
    """Attention pooling over bags ``x (B, N, F)``: ``(M (B, F), p, s)``.

    ``wa``/``wb`` ``(F, D)``, ``wc (D,)``, biases and ``bc ()`` float32;
    ``gated=False`` ignores ``wb``/``bb`` and returns zero gradients for them.
    ``seed`` keys the gate dropout masks (hash streams 1 and 2, bag = index in
    the batch). The gradient flows to ``x`` as well as to the weights. CPU
    tensors take the plain twins; CUDA tensors always launch K7f (forward)
    and K7b (backward), except that a bag over 6 MiB at dropout 0 streams
    through :func:`attention_pool_tiled` (K8), as
    ``murcl_tpu/ops/attention_pallas.py:446-459`` routes it.
    """
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    if dropout == 0 and x[0].numel() * x.element_size() > FUSED_RESIDENT_BUDGET:
        return attention_pool_tiled(x, wa, ba, wb, bb, wc, bc, mask=mask, gated=gated)
    return _AttentionPool.apply(x, wa, ba, wb, bb, wc, bc, mask, bool(gated), float(dropout),
                                int(seed))


# ---------------------------------------------------------------------------
# K8: streaming attention pool over a bag of any length (full-slide heatmaps)
# ---------------------------------------------------------------------------
# Counterpart of ``murcl_tpu/ops/attention_pallas.py`` ``attention_pool_tiled``
# (forward ``_make_tiled_fwd_kernel``). The kernel (``csrc/attention_tiled.cu``)
# runs in two parts, split by what bounds each. The gate products and the
# scores ``s`` of the whole bag go through K7f's gate kernel
# (``pool_gates_fwd_wg``: warpgroup products over 128-row tiles fed by TMA; in
# f32 each product three bf16 products of :func:`split_bf16`'s planes, about
# ``2**-16`` relative, where the TPU kernel takes f32 operands). Then a
# bytes-bound chunk pass splits each bag into chunks of :func:`tiled_chunk`
# rows, one block each, walks each chunk's rows in ``_TM``-row halves with an
# online max, rounds ``e = exp(s - running max)`` to the bag dtype before its
# product with ``x`` (read once) and writes the chunk's (max, sum, F sums); a
# last kernel merges the chunks. The TPU kernel took the running max over
# 2048-row tiles of the whole bag, so in bf16 the two round ``e`` at other
# maxima. ``p`` is the masked softmax of ``s``, taken outside the kernel as
# JAX takes it in XLA. The backward is K7b's (dropout 0), as JAX's is its XLA
# pool's. Widths are padded as K7's are (:func:`pad_pool_widths`).


def tiled_chunk(b: int, n: int) -> int:
    """Rows per block of K8's chunk pass for ``b`` bags of ``n`` rows: whole
    64-row tiles, one per block until the grid holds more than 8 blocks per
    H100 SM (one wave of the pass's 256-thread blocks), then as many per
    block as keep it near that. The twin takes the same chunks, so in bf16
    both round ``e`` at the same running maxima."""
    tiles = -(-n // _K8_ROWS)
    return _K8_ROWS * max(1, b * tiles // (8 * _cuda.H100_SMS))


def tiled_chunk_smem(chunk: int) -> int:
    """Bytes of shared memory a block of K8's chunk pass takes
    (``tiled_impl`` in ``csrc/attention_tiled.cu``): each row's rounded ``e``
    and each ``_TM``-row half's rescale, in f32."""
    return 4 * (chunk + chunk // _TM)


def tiled_plans(b: int, n: int, f: int, d: int, dtype: torch.dtype) -> dict:
    """K8's launch plans at ``b`` bags of ``n`` rows and widths ``f -> d``,
    ``{kernel: (stages or None, bytes)}``: the gate pass's, K7f's
    ``pool_gates_fwd_wg`` at the padded widths (no term in N), and the chunk
    pass's (no ring)."""
    gates = pool_plans(_padded(f), _padded(d), True, dtype)["pool_gates_fwd_wg"]
    return {"pool_gates_fwd_wg": gates,
            "chunk_kernel": (None, tiled_chunk_smem(tiled_chunk(b, n)))}


def attention_pool_tiled_plain(x, wa, ba, wb, bb, wc, bc, mask, gated=True):
    """Plain PyTorch forward (mirror of K8): ``(M, p, s)``. Per chunk of
    :func:`tiled_chunk` rows it takes the kernel's running max over
    ``_TM``-row tiles and rounds ``e`` at it, so kernel and twin differ by
    summation order (and, in f32, by the kernel's three bf16 products)."""
    dt = x.dtype
    b, n, f = x.shape
    xf = x.float()
    u = torch.tanh(xf @ wa.to(dt).float() + ba)
    if gated:
        u = u * torch.sigmoid(xf @ wb.to(dt).float() + bb)
    s = u @ wc.float() + bc
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, _NEG_INF)), dim=-1)

    chunk = tiled_chunk(b, n)
    pad = (-n) % chunk
    nc, tiles = (n + pad) // chunk, chunk // _TM
    live = torch.nn.functional.pad(mask, (0, pad)).reshape(b, nc, tiles, _TM)
    st = torch.nn.functional.pad(s, (0, pad)).reshape(b, nc, tiles, _TM)
    st = torch.where(live, st, torch.full_like(st, _NEG_INF))
    run = st.amax(-1).cummax(-1).values  # (b, nc, tiles): the max after each tile
    e = torch.where(live, torch.exp(st - run[..., None]), torch.zeros_like(st))
    xt = torch.nn.functional.pad(xf, (0, 0, 0, pad)).reshape(b, nc, tiles, _TM, f)
    mt = torch.einsum("bctr,bctrf->bctf", e.to(dt).float(), xt)
    scale = torch.exp(run - run[..., -1:])  # each tile's rescale to the chunk's max
    m_c = (scale[..., None] * mt).sum(2)
    l_c = (scale * e.sum(-1)).sum(2)
    mx_c = run[..., -1]
    w = torch.exp(mx_c - mx_c.amax(-1, keepdim=True))
    m = (w[..., None] * m_c).sum(1) / (w * l_c).sum(1)[:, None]
    return m, p, s


def _check_tiled_shapes(name, x, wa):
    """K8's rule: its gate pass's blocks (K7f's, at the padded widths) and
    its chunk pass's, neither with a term in F; the chunk grows with the
    rows only past one wave of 64-row chunks."""
    b, n, f = x.shape
    d = wa.shape[1]
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: bags must be float32 or bfloat16")
    smem = max(nb for _, nb in tiled_plans(b, n, f, d, x.dtype).values())
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: tiles need {smem} bytes of shared memory at (N, F, D) = "
                         f"({n}, {f}, {d})")


def w_planes(w):
    """``w (F, D)`` as the f32 route's B operand: :func:`split_bf16`'s hi
    rows, then its lo rows, ``(2 F, D)`` bf16: the plain twin of
    ``murcl_split_bf16``, which writes it on the card."""
    return torch.cat(split_bf16(w.float()))


def _w_planes_cuda(name, w):
    """:func:`w_planes` on the card, in one launch where the plain twin
    takes four."""
    w = w.to(torch.float32).contiguous()
    _cuda.require_cuda(name, w)
    f, d = w.shape
    out = torch.empty((2 * f, d), dtype=torch.bfloat16, device=w.device)
    _cuda.check(_cuda.library().murcl_split_bf16(_p(w), _p(out), f, d, _cuda.stream()), name)
    return out


def _tiled_fwd_cuda(x, wa, ba, wb, bb, wc, bc, mask, gated=True):
    """K8: ``(M, p, s)`` of :func:`attention_pool_tiled_plain`: the gate
    pass (K7f's gate kernel, not counted as a K7f launch), then the chunk
    pass and the merge; one launch of K8."""
    name = "attention_pool_tiled"
    _check_tiled_shapes(name, x, wa)
    b, n, f = x.shape
    o, _, _, s = _pool_gates(name, x, wa, ba, wb, bb, wc, bc, mask, gated, 0.0, 0, pool=False)
    if o["x"].data_ptr() % 16:
        raise ValueError(f"{name}: the bags must start on a 16-byte boundary")
    fp, chunk = o["x"].shape[-1], tiled_chunk(b, n)
    chunks = -(-n // chunk)
    out = dict(dtype=torch.float32, device=x.device)
    m, m_part = torch.empty((b, fp), **out), torch.empty((b, chunks, fp), **out)
    mx_part, l_part = torch.empty((b, chunks), **out), torch.empty((b, chunks), **out)
    _cuda.check(_cuda.library().murcl_attention_pool_tiled(
        int(x.dtype == torch.bfloat16), _p(o["x"]), _p(s), _p(o["mask"]), _p(m_part),
        _p(mx_part), _p(l_part), _p(m), b, n, fp, chunk, _cuda.stream()), name)
    _cuda.LAUNCHES["attention_pool_tiled"] += 1
    p = torch.softmax(torch.where(o["mask"], s, _NEG_INF), dim=-1)
    return _unpad(m, f), p, s


class _AttentionPoolTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, wa, ba, wb, bb, wc, bc, mask, gated):
        if x.device.type == "cpu":
            m, p, s = attention_pool_tiled_plain(x, wa, ba, wb, bb, wc, bc, mask, gated)
        else:
            m, p, s = _tiled_fwd_cuda(x, wa, ba, wb, bb, wc, bc, mask, gated)
        ctx.save_for_backward(x, wa, ba, wb, bb, wc, mask, p)
        ctx.gated = gated
        return m, p, s

    @staticmethod
    def backward(ctx, gm, gp, gs):
        x, wa, ba, wb, bb, wc, mask, p = ctx.saved_tensors
        args = (x, wa, ba, wb, bb, wc, mask, p, gm, gp, gs, ctx.gated, 0.0, 0)
        if x.device.type == "cpu":
            dx, dwa, dba, dwb, dbb, dwc, dbc = gated_attention_pool_plain_bwd(*args)
        else:
            dx, dwa, dba, dwb, dbb, dwc, dbc = _pool_bwd_cuda(*args)
        return dx, dwa, dba, dwb, dbb, dwc, dbc.reshape(()), None, None


def attention_pool_tiled(x, wa, ba, wb, bb, wc, bc, mask=None, gated: bool = True):
    """Streaming attention pooling over bags ``x (B, N, F)`` of any length,
    without dropout: ``(M (B, F), p (B, N), s (B, N))`` in float32, with
    :func:`gated_attention_pool`'s arguments. CPU tensors take the plain
    twin; CUDA tensors always launch K8 (forward) and K7b (backward, at any
    N). The TPU kernel's ``tile`` (a Mosaic knob) is not carried over."""
    if mask is None:
        mask = torch.ones(x.shape[:2], dtype=torch.bool, device=x.device)
    return _AttentionPoolTiled.apply(x, wa, ba, wb, bb, wc, bc, mask, bool(gated))
