"""K8's and K1's grid and tile rules on the CPU, with no card.

``tiled_tile_smem`` reckons a K8 block's shared memory (a 64-row x tile as
bf16, or in f32 as ``[lo | hi]`` planes of a slab of at most 256 columns of
F, the B ring and the f32 row state); every width the port gives K8 must fit
one H100 block's 232,448 bytes, and ``_check_tiled_shapes`` refuses what
does not, naming the shape, on the meta device. In f32 the kernel takes each
gate product as three bf16 products over ``_slab_planes``' weight layout; a
CPU mirror of that layout matches an f64 product to 1e-5, where one bf16
product does not. ``tiled_chunk`` gives whole 64-row tiles per block, and
``compact_slot_slice`` splits a few bags' slots so that K1's grid fills the
card, its slices tiling the slots exactly.
"""

import numpy as np
import pytest
import torch

from murcl_tpu_torch.ops import attention as tat
from murcl_tpu_torch.ops.compact import compact_slot_slice

NAME = "attention_pool_tiled"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [128, 256, 384])
@pytest.mark.parametrize("f", [512, 1024])
def test_tiled_tiles_fit(f, d, dtype):
    smem = tat.tiled_tile_smem(f, dtype)
    assert smem <= tat._SMEM_LIMIT == 232448
    fs = tat.tiled_slab(f, dtype)
    assert f % fs == 0 and fs % 64 == 0 and (dtype == torch.bfloat16 or fs <= 256)
    planes = 2 if dtype == torch.float32 else 1
    assert smem >= 2 * 64 * (planes * fs + 8) + 2 * 2 * 64 * 136 + 4 * f
    x = torch.empty(1, 60416, f, dtype=dtype, device="meta")
    tat._check_tiled_shapes(NAME, x, torch.empty(f, d, device="meta"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_two_blocks_per_sm_at_the_heatmap_width(dtype):
    assert 2 * (tat.tiled_tile_smem(512, dtype) + 1024) <= 228 * 1024


@pytest.mark.parametrize("n,f,d,dtype,match", [
    (60416, 448, 256, torch.float32, r"multiples of 128 \(got F 448, D 256\)"),
    (60416, 512, 192, torch.bfloat16, r"multiples of 128 \(got F 512, D 192\)"),
    (60416, 2048, 256, torch.bfloat16, r"bytes .* \(N, F, D\) = \(60416, 2048, 256\)"),
    (60416, 512, 256, torch.float16, r"float32 or bfloat16"),
])
def test_check_tiled_shapes_refuses(n, f, d, dtype, match):
    with pytest.raises(ValueError, match=match):
        tat._check_tiled_shapes(NAME, torch.empty(1, n, f, dtype=dtype, device="meta"),
                                torch.empty(f, d, device="meta"))


@pytest.mark.parametrize("f", [512, 1024])
def test_three_bf16_products_over_slabs_match_f64(f):
    """The kernel's f32 gate pre-activation: per slab q, the tile's
    ``[lo | hi]`` planes against the slab's ``[Whi; Wlo]`` rows, plus
    ``hi`` against ``Whi``, summed in f32."""
    rng = np.random.default_rng(0)
    x = torch.tensor(np.abs(rng.standard_normal((256, f), dtype=np.float32)))
    w = torch.tensor(rng.standard_normal((f, 256), dtype=np.float32) * f ** -0.5)
    want = x.double() @ w.double()
    fs = tat.tiled_slab(f, torch.float32)
    planes = tat._slab_planes(w, fs).float()  # bf16 values, exact in f32
    assert planes.shape == (2 * f, 256)
    got = torch.zeros(256, 256)
    for q in range(f // fs):
        hi, lo = tat.split_bf16(x[:, q * fs:(q + 1) * fs])
        tile = torch.cat([lo, hi], 1).float()
        wq = planes[2 * q * fs:2 * (q + 1) * fs]
        got += tile @ wq + hi.float() @ wq[:fs]
    one = x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()

    def rel(t):
        return float((t.double() - want).norm() / want.norm())

    assert rel(got) <= 1e-5, rel(got)
    assert rel(one) > 1e-3, rel(one)


@pytest.mark.parametrize("b,n,rows", [(1, 60416, 64), (1, 12288, 64), (4, 12288, 64),
                                      (2, 100000, 128), (1, 1, 64)])
def test_tiled_chunk(b, n, rows):
    """One 64-row tile per block until the grid holds 8 blocks per SM."""
    chunk = tat.tiled_chunk(b, n)
    assert chunk == rows and chunk % 64 == 0
    assert chunk == 64 or b * -(-n // chunk) >= 8 * 132


@pytest.mark.parametrize("batch,feat,slices", [(64, 1024, 8), (1536, 1024, 1), (128, 1024, 4),
                                               (64, 1000, 8), (64, 100, 4), (1, 1024, 32),
                                               (384, 1024, 1)])
def test_compact_slot_slices(batch, feat, slices):
    per = compact_slot_slice(batch, feat)
    assert per % 32 == 0 and per >= 32
    n = -(-feat // per)
    assert n == slices
    ranges = [(i * per, min(feat, (i + 1) * per)) for i in range(n)]
    assert ranges[0][0] == 0 and ranges[-1][1] == feat
    assert all(a < b for a, b in ranges) and all(ranges[i][1] == ranges[i + 1][0]
                                                 for i in range(n - 1))
    assert batch * n >= 2 * 132 or per == 32  # two blocks per SM where the slots allow


def test_k5_shape_fills_the_card():
    """At a supervised step's 64 bags of 1024 slots: at least two blocks per
    SM; at the main shape's 1536 bags: one block per bag."""
    assert 64 * -(-1024 // compact_slot_slice(64, 1024)) >= 2 * 132
    assert compact_slot_slice(1536, 1024) == 1024
