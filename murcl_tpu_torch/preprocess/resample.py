"""The port's host resize: Pillow's ``Image.resize`` with its default filter
(bicubic in Pillow 12), reproduced bit for bit in numpy, so that resizing
needs no PIL.

The JAX package resizes with PIL in three places (``slide_io.py:105``,
``extract.py:144``, ``decode_pool.py:69``). Pillow's resampler
(``libImaging/Resample.c``) runs two separable passes, horizontal first:

- per axis and output pixel, the bicubic weights (``a = -0.5``, support 2
  times the scale when shrinking) are computed in double over the input
  pixels ``[xmin, xmax)`` around the pixel's centre and normalised to sum
  to 1, then rounded to integers as ``int(±0.5 + k * 2**22)``;
- each pass sums ``pixel * weight`` from ``2**21`` and keeps ``sum >> 22``
  clipped to 0-255, so the horizontal pass ends in uint8 before the
  vertical one starts;
- RGBA is premultiplied first (Pillow's ``RGBa``) and divided back after.

Every partial sum is an integer below 2**31 in magnitude, so a float64
product of the pixels with the integer weights is exact in any order. On
the host (:func:`resize_u8`) each pass is a few BLAS products, one per
block of output pixels over the input span the block reads; on the card
(:func:`resize_u8_torch`, which the feature extraction and the tiling's
downsample use there) each pass is one float64 product with the axis's
dense weight matrix, and the output is the same, bit for bit.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np

PRECISION_BITS = 22
_BLOCK = 16  # output pixels per product


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's ``bicubic_filter`` (a = -0.5), in its order of operations."""
    x = np.abs(x)
    near = ((-0.5 + 2.0) * x - (-0.5 + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _coeffs(in_size: int, out_size: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(xmin (out,), taps (out,), weights (out, ksize) int64)`` as
    Pillow's ``precompute_coeffs`` and ``normalize_coeffs_8bpc`` give them
    for the whole input span."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    k = np.zeros((out_size, ksize))
    ww = np.zeros(out_size)
    for x in range(ksize):  # the sum in Pillow's order
        live = x < xmax
        w = _bicubic(((x + xmin) - center + 0.5) * ss)
        k[:, x] = np.where(live, w, 0.0)
        ww += k[:, x]
    k = np.where(ww[:, None] != 0.0, k / np.where(ww == 0.0, 1.0, ww)[:, None], k)
    scaled = k * (1 << PRECISION_BITS)
    ints = np.trunc(np.where(k < 0, -0.5 + scaled, 0.5 + scaled)).astype(np.int64)
    return xmin, xmax, ints


@lru_cache(maxsize=64)
def _blocks(in_size: int, out_size: int) -> tuple:
    """Per block of up to ``_BLOCK`` output pixels: ``(lo, hi, out slice,
    (hi - lo, n) float64 weights)``, the input span the block reads."""
    xmin, taps, ints = _coeffs(in_size, out_size)
    out = []
    for b0 in range(0, out_size, _BLOCK):
        b1 = min(b0 + _BLOCK, out_size)
        lo, hi = int(xmin[b0:b1].min()), int((xmin[b0:b1] + taps[b0:b1]).max())
        w = np.zeros((hi - lo, b1 - b0))
        for j, o in enumerate(range(b0, b1)):
            w[xmin[o] - lo:xmin[o] - lo + taps[o], j] = ints[o, :taps[o]]
        out.append((lo, hi, slice(b0, b1), w))
    return tuple(out)


def _round(acc: np.ndarray) -> np.ndarray:
    """``clip8``, in place: ``(sum + 2**21) >> 22`` clipped to 0-255 (exact:
    the sums are integers in float64 and 2**-22 is a power of two)."""
    acc += 1 << (PRECISION_BITS - 1)
    acc *= 2.0 ** -PRECISION_BITS
    np.floor(acc, out=acc)
    np.clip(acc, 0, 255, out=acc)
    return acc.astype(np.uint8)


def _pass_rows(img: np.ndarray, out_h: int) -> np.ndarray:
    """The vertical pass: ``(H, W, C)`` -> ``(out_h, W, C)``."""
    h, w, c = img.shape
    flat = img.reshape(h, w * c).astype(np.float64)
    acc = np.empty((out_h, w * c))
    for lo, hi, sl, wts in _blocks(h, out_h):
        acc[sl] = wts.T @ flat[lo:hi]
    return _round(acc).reshape(out_h, w, c)


def _pass_cols(img: np.ndarray, out_w: int) -> np.ndarray:
    """The horizontal pass: ``(H, W, C)`` -> ``(H, out_w, C)``, over rows of
    one channel each."""
    h, w, c = img.shape
    out = np.empty((h, out_w, c), dtype=np.uint8)
    rows = max(1, (1 << 24) // max(w * c, 1))  # rows per chunk: about 128 MiB of float64
    for r0 in range(0, h, rows):
        chunk = img[r0:r0 + rows]
        flat = np.empty((len(chunk), c, w))
        flat[...] = chunk.transpose(0, 2, 1)
        flat = flat.reshape(-1, w)
        acc = np.empty((flat.shape[0], out_w))
        for lo, hi, sl, wts in _blocks(w, out_w):
            acc[:, sl] = flat[:, lo:hi] @ wts
        out[r0:r0 + rows] = _round(acc).reshape(len(chunk), c, out_w).transpose(0, 2, 1)
    return out


def _premultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's ``rgbA2rgba``: each colour times alpha, ``MULDIV255``."""
    a = rgba[..., 3:].astype(np.uint32)
    t = rgba[..., :3].astype(np.uint32) * a + 128
    return np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)


def _unpremultiply(rgba: np.ndarray) -> np.ndarray:
    """Pillow's ``rgba2rgbA``: each colour times 255 over alpha, where alpha
    is neither 0 nor 255."""
    a = rgba[..., 3:].astype(np.uint32)
    rgb = rgba[..., :3].astype(np.uint32)
    div = np.minimum(rgb * 255 // np.maximum(a, 1), 255)
    rgb = np.where((a == 0) | (a == 255), rgb, div)
    return np.concatenate([rgb, a], axis=-1).astype(np.uint8)


def resize_u8(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """``(H, W, C)`` uint8 -> ``(h, w, C)`` uint8 for ``size = (w, h)``, equal
    to ``PIL.Image.fromarray(img).resize(size)`` (bicubic; C = 4 as RGBA); a
    copy when the size is unchanged."""
    w, h = int(size[0]), int(size[1])
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f"resize_u8: expects (H, W, C) uint8, got {img.shape} {img.dtype}")
    if w < 1 or h < 1:
        raise ValueError(f"resize_u8: size must be positive, got {size}")
    if img.shape[:2] == (h, w):
        return img.copy()
    if img.shape[2] == 4 and (img[..., 3] == 255).all():
        # opaque: premultiplying and dividing back change nothing, and the
        # alpha plane resizes to 255 (the weights sum to 2**22 within far
        # less than 2**21 / 255)
        out = np.empty((h, w, 4), np.uint8)
        out[..., :3] = _resize(img[..., :3], w, h)
        out[..., 3] = 255
        return out
    if img.shape[2] == 4:
        return _unpremultiply(_resize(_premultiply(img), w, h))
    return _resize(img, w, h)


def _resize(img: np.ndarray, w: int, h: int) -> np.ndarray:
    out = img
    if out.shape[1] != w:
        out = _pass_cols(out, w)
    if out.shape[0] != h:
        out = _pass_rows(out, h)
    return np.ascontiguousarray(out)


@lru_cache(maxsize=16)
def _dense(in_size: int, out_size: int, device) -> "torch.Tensor":
    """The ``(in_size, out_size)`` float64 weight matrix of one axis: column
    ``o`` holds output pixel ``o``'s integer weights over its taps."""
    import torch

    xmin, taps, ints = _coeffs(in_size, out_size)
    k = np.arange(ints.shape[1])
    live = k[None] < taps[:, None]
    cols = np.broadcast_to(np.arange(out_size)[:, None], live.shape)
    dense = np.zeros((in_size, out_size))
    dense[(xmin[:, None] + k[None])[live], cols[live]] = ints[live]
    return torch.from_numpy(dense).to(device)


def _round_t(acc):
    """``clip8`` on a float64 tensor, in place (exact, as ``_round``)."""
    return acc.add_(1 << (PRECISION_BITS - 1)).mul_(2.0 ** -PRECISION_BITS).floor_().clamp_(0, 255)


def resize_u8_torch(x, size: Tuple[int, int]):
    """``(N, H, W, C)`` uint8 tensor -> ``(N, h, w, C)`` uint8 on its device
    for ``size = (w, h)``: :func:`resize_u8` of each image, bit for bit, for
    images whose channels resize apart (RGB; not an RGBA with transparency,
    which Pillow premultiplies). The horizontal pass runs over row chunks
    of about 256 MiB of float64."""
    import torch

    w, h = int(size[0]), int(size[1])
    if x.dtype != torch.uint8 or x.dim() != 4:
        raise ValueError(f"resize_u8_torch: expects (N, H, W, C) uint8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, in_h, in_w, c = x.shape
    y = x.permute(0, 3, 1, 2)  # (N, C, H, W), a view
    if in_w != w:
        m = _dense(in_w, w, x.device)
        out = torch.empty((n, c, in_h, w), dtype=torch.float64, device=x.device)
        rows = max(1, (1 << 25) // max(n * c * in_w, 1))
        for r0 in range(0, in_h, rows):
            out[:, :, r0:r0 + rows] = _round_t(y[:, :, r0:r0 + rows].to(torch.float64) @ m)
        y = out
    else:
        y = y.to(torch.float64)
    if in_h != h:
        y = _round_t(_dense(in_h, h, x.device).T @ y)
    return y.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
