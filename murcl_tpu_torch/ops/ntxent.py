"""NT-Xent (SimCLR) loss: kernel K4 (forward and backward) and its plain twins.

Counterpart of ``murcl_tpu/ops/ntxent.py`` ``nt_xent`` (the plain version)
and ``murcl_tpu/ops/ntxent_pallas.py`` ``nt_xent_pallas`` (the kernels,
``csrc/ntxent.cu``). For row ``i`` of the ``2B`` stacked projections,
``loss_i = logsumexp_{j != i}(sim_ij) - sim_{i, i +- B}`` with
``sim = zn @ zn^T / temperature`` and ``zn = z / max(|z|, 1e-8)``; the loss
is the mean over rows.

The kernels keep a residual of three ``2B`` rows, ``stats = [row max, row
sum of exp, norm]``: the forward writes it, the backward reads it instead of
recomputing the statistics. ``nt_xent_plain_fwd`` / ``nt_xent_plain_bwd``
are the plain pair with that interface, rounding where the kernels do.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda

_NEG_INF = -1e9
_EPS = 1e-8
_COLS, _DEPTH = 256, 128  # csrc/ntxent.cu kCols and kDepth: zn's row and k padding
_TICKETS: dict[int, torch.Tensor] = {}  # device index -> the forward's u32 ticket


def nt_xent_plain(z_i, z_j, temperature):
    """Plain PyTorch NT-Xent over two views ``(B, d)``; autograd gives its grads."""
    b = z_i.shape[0]
    z = torch.cat([z_i, z_j], dim=0).to(torch.float32)
    norms = torch.linalg.vector_norm(z, dim=-1, keepdim=True).clamp_min(_EPS)
    zn = z / norms
    sim = (zn @ zn.T) / temperature
    n = 2 * b
    rows = torch.arange(n, device=z.device)
    eye = rows[:, None] == rows[None, :]
    lse = torch.logsumexp(sim.masked_fill(eye, _NEG_INF), dim=1)
    pos = sim[rows, (rows + b) % n]
    return torch.mean(lse - pos)


def _sim(z, norms, temperature):
    """``(zn, sim, eye, partner mask)`` of the stacked views ``z`` (2B, d)."""
    zn = z / norms[:, None]
    sim = (zn @ zn.T) / temperature
    n = z.shape[0]
    rows = torch.arange(n, device=z.device)
    eye = rows[:, None] == rows[None, :]
    return zn, sim, eye, rows[None, :] == ((rows + n // 2) % n)[:, None]


def nt_xent_plain_fwd(z_i, z_j, temperature):
    """K4f's plain twin: ``(loss, stats)``, stats ``(3, 2B)`` = row max of
    the masked sim, row sum of ``exp(sim - max)``, norm; the loss is the sum
    of ``(log(sum) + max) - pos`` over rows, over ``2B``."""
    z = torch.cat([z_i, z_j], dim=0).to(torch.float32)
    norms = torch.sqrt((z * z).sum(dim=1)).clamp_min(_EPS)
    _, sim, eye, partner = _sim(z, norms, temperature)
    sm = sim.masked_fill(eye, _NEG_INF)
    row_max = sm.amax(dim=1)
    row_sum = torch.exp(sm - row_max[:, None]).sum(dim=1)
    pos = sim[partner]
    loss = ((torch.log(row_sum) + row_max) - pos).sum() / z.shape[0]
    return loss, torch.stack([row_max, row_sum, norms])


def nt_xent_plain_bwd(z_i, z_j, temperature, stats, g):
    """K4b's plain twin: ``(dz_i, dz_j)`` from the forward's ``stats`` and
    the loss's cotangent ``g``, as ``ntxent_pallas.py`` ``_bwd_kernel``."""
    b = z_i.shape[0]
    z = torch.cat([z_i, z_j], dim=0).to(torch.float32)
    row_max, row_sum, norms = stats
    zn, sim, eye, partner = _sim(z, norms, temperature)
    soft = torch.exp(sim.masked_fill(eye, _NEG_INF) - row_max[:, None]) / row_sum[:, None]
    gsim = ((soft - partner.to(torch.float32)) / (2 * b)).masked_fill(eye, 0.0) * g
    dzn = ((gsim + gsim.T) @ zn) / temperature
    radial = (zn * dzn).sum(dim=1, keepdim=True)
    nrm = norms[:, None]
    dz = torch.where(nrm <= _EPS, dzn / _EPS, (dzn - zn * radial) / nrm)
    return dz[:b], dz[b:]


def _check(name, z_i, z_j):
    """The views the kernels take: two float32 ``(B, d)`` of one shape, B >= 1."""
    if z_i.dtype != torch.float32 or z_j.dtype != torch.float32:
        raise ValueError(f"{name}: expects float32 projections")
    if z_i.dim() != 2 or z_i.shape != z_j.shape:
        raise ValueError(f"{name}: expects two (B, d) views of one shape")
    if z_i.shape[0] == 0:
        raise ValueError(f"{name}: an empty batch has no loss")


def _ticket(device) -> torch.Tensor:
    t = _TICKETS.get(device.index)
    if t is None:
        t = _TICKETS[device.index] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _scratch(z_i) -> torch.Tensor:
    """The kernels' zn scratch: 2B rows and d columns, padded to multiples of
    ``_COLS`` and ``_DEPTH``."""
    b, d = z_i.shape
    n_pad, d_pad = -(-2 * b // _COLS) * _COLS, -(-d // _DEPTH) * _DEPTH
    return torch.empty((n_pad, d_pad), dtype=torch.float32, device=z_i.device)


def _fwd_cuda(z_i, z_j, temperature):
    """K4f: ``(loss, stats)`` as :func:`nt_xent_plain_fwd`."""
    _check("nt_xent", z_i, z_j)
    _cuda.require_cuda("nt_xent", z_i, z_j)
    b, d = z_i.shape
    loss = torch.empty((), dtype=torch.float32, device=z_i.device)
    work = torch.empty((4, 2 * b), dtype=torch.float32, device=z_i.device)  # stats; terms
    zn = _scratch(z_i)
    err = _cuda.library().murcl_ntxent_fwd(
        z_i.data_ptr(), z_j.data_ptr(), float(temperature), loss.data_ptr(), work.data_ptr(),
        work[3].data_ptr(), _ticket(z_i.device).data_ptr(), zn.data_ptr(), b, d,
        _cuda.stream())
    _cuda.check(err, "nt_xent forward")
    _cuda.LAUNCHES["ntxent_fwd"] += 1
    return loss, work[:3]


def _bwd_cuda(z_i, z_j, temperature, stats, g):
    """K4b: ``(dz_i, dz_j)`` as :func:`nt_xent_plain_bwd`; ``g`` stays on the
    device (no host sync)."""
    g = torch.as_tensor(g, dtype=torch.float32, device=z_i.device).contiguous()
    _cuda.require_cuda("nt_xent backward", z_i, z_j, stats, g)
    dzi, dzj, zn = torch.empty_like(z_i), torch.empty_like(z_j), _scratch(z_i)
    err = _cuda.library().murcl_ntxent_bwd(
        z_i.data_ptr(), z_j.data_ptr(), float(temperature), stats.data_ptr(), g.data_ptr(),
        dzi.data_ptr(), dzj.data_ptr(), zn.data_ptr(), z_i.shape[0], z_i.shape[1],
        _cuda.stream())
    _cuda.check(err, "nt_xent backward")
    _cuda.LAUNCHES["ntxent_bwd"] += 1
    return dzi, dzj


class _NTXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_i, z_j, temperature):
        z_i, z_j = z_i.contiguous(), z_j.contiguous()
        loss, stats = _fwd_cuda(z_i, z_j, temperature)
        ctx.save_for_backward(z_i, z_j, stats)
        ctx.temperature = float(temperature)
        return loss

    @staticmethod
    def backward(ctx, g):
        z_i, z_j, stats = ctx.saved_tensors
        return *_bwd_cuda(z_i, z_j, ctx.temperature, stats, g), None


def nt_xent(z_i, z_j, temperature):
    """NT-Xent loss; CPU tensors take the plain version, CUDA tensors K4."""
    if z_i.device.type == "cpu":
        return nt_xent_plain(z_i, z_j, temperature)
    if float(temperature) <= 0:
        raise ValueError("temperature must be positive")
    return _NTXent.apply(z_i, z_j, temperature)
