"""NT-Xent (SimCLR) loss: kernel K4 (forward and backward) and its plain twin.

Counterpart of ``murcl_tpu/ops/ntxent.py`` ``nt_xent`` (the plain version)
and ``murcl_tpu/ops/ntxent_pallas.py`` ``nt_xent_pallas`` (the kernels,
``csrc/ntxent.cu``). For row ``i`` of the ``2B`` stacked projections,
``loss_i = logsumexp_{j != i}(sim_ij) - sim_{i, i +- B}`` with
``sim = zn @ zn^T / temperature`` and ``zn = z / max(|z|, 1e-8)``; the loss
is the mean over rows.
"""

from __future__ import annotations

import torch

from murcl_tpu_torch.ops import _cuda

_NEG_INF = -1e9
_EPS = 1e-8
_SMEM_LIMIT = 232448  # bytes of shared memory one H100 block may use
_WARPS = 16  # csrc/ntxent.cu kThreads / 32


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


def _check(name, z_i, z_j):
    _cuda.require_cuda(name, z_i, z_j)
    if z_i.dtype != torch.float32 or z_j.dtype != torch.float32:
        raise ValueError(f"{name}: expects float32 projections")
    if z_i.dim() != 2 or z_i.shape != z_j.shape:
        raise ValueError(f"{name}: expects two (B, d) views of one shape")
    b, d = z_i.shape
    n = 2 * b
    smem = 4 * (n * (d + 1) + 4 * n + _WARPS * n)
    if d % 32 or d > 256 or smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: needs d % 32 == 0, d <= 256 and zn in one "
                         f"block's shared memory (B={b}, d={d})")


class _NTXent(torch.autograd.Function):
    @staticmethod
    def forward(ctx, z_i, z_j, temperature):
        z_i, z_j = z_i.contiguous(), z_j.contiguous()
        _check("nt_xent", z_i, z_j)
        loss = torch.empty((), dtype=torch.float32, device=z_i.device)
        lib = _cuda.library()
        err = lib.murcl_ntxent_fwd(z_i.data_ptr(), z_j.data_ptr(), float(temperature),
                                   loss.data_ptr(), z_i.shape[0], z_i.shape[1],
                                   _cuda.stream())
        _cuda.check(err, "nt_xent forward")
        _cuda.LAUNCHES["ntxent_fwd"] += 1
        ctx.save_for_backward(z_i, z_j)
        ctx.temperature = float(temperature)
        return loss

    @staticmethod
    def backward(ctx, g):
        z_i, z_j = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        dzi, dzj = torch.empty_like(z_i), torch.empty_like(z_j)
        lib = _cuda.library()
        err = lib.murcl_ntxent_bwd(z_i.data_ptr(), z_j.data_ptr(), ctx.temperature,
                                   g.data_ptr(), dzi.data_ptr(), dzj.data_ptr(),
                                   z_i.shape[0], z_i.shape[1], _cuda.stream())
        _cuda.check(err, "nt_xent backward")
        _cuda.LAUNCHES["ntxent_bwd"] += 1
        return dzi, dzj, None


def nt_xent(z_i, z_j, temperature):
    """NT-Xent loss; CPU tensors take the plain version, CUDA tensors K4."""
    if z_i.device.type == "cpu":
        return nt_xent_plain(z_i, z_j, temperature)
    if float(temperature) <= 0:
        raise ValueError("temperature must be positive")
    return _NTXent.apply(z_i, z_j, temperature)
