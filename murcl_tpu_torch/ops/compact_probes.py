"""The one-hot compaction probes: K1's function computed as the TPU kernels
compute it, variant by variant, and each variant's plain twin.

Counterparts of the ``pallas_call`` sites of the JAX package's TPU probes of
its one-hot compaction, ``scripts/dbg_compact_ablate.py:160`` (``build`` /
``make_kernel``, one bag per grid step), ``scripts/dbg_grouped_ablate.py:176``
and ``scripts/dbg_grouped_gate.py:187`` (the slide-grouped kernel, ``GROUP``
bags of one slide per grid step). The port's production compaction, K1
(``ops/compact.py``), is a row copy; these time the formulation it replaced
(``csrc/compact_onehot.cu``, its design there) beside it, through the port's
scripts of the same names. Probes, on no training path.

Per bag, over its window's 128-row tiles ``t`` (``bank[offs + 128 t ..]``),
with ``base`` the bag's kept count (ranks ``>= 0``) before ``t`` and
``base_al = min(128 (base // 128), feat - 256)``: the one-hot slab
``oh[m, k] = (base_al + m == ranks[128 t + k])`` (256 x 128), ``prod = oh @
rows_t`` in f32, ``acc[base_al : base_al + 256] += prod`` in the
accumulator's dtype; the output is ``acc`` in the bank's dtype (bf16). A
:class:`Probe` sets what a variant changes: the accumulator's dtype, the slab
(``"compare"`` as above; ``"rebased"``, ``iota == ranks - base_al``, whose
kernel scatters the ones; ``"const"``, row 0 all ones), ``overwrite`` (the
product stored, not added), the per-tile gate (``128 t < nump``, the tile's
work skipped), the chunk-liveness gate (chunks of ``chunk_tiles`` tiles
starting at or past ``nump`` skipped), and ``dmafloor`` (the window's first
``feat`` rows, as they are). The grouped scripts read each group's window and
``nump`` at its first bag (``flat0``), as the JAX kernels do. The variants
that keep the result (every slot gets its row from one tile, the rest adds
exact zeros) equal :func:`murcl_tpu_torch.ops.compact.gather_compact_plain`;
``normw``, ``noonehot`` and ``dmafloor`` compute something else, which
:func:`onehot_compact_plain` defines.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from murcl_tpu_torch.ops import _cuda

TILE, SLAB = 128, 256  # a window tile's rows, the one-hot slab's rows
ONEHOT = {"compare": 0, "rebased": 1, "const": 2}  # the kernel's slab: compare, scatter, constant


@dataclass(frozen=True)
class Probe:
    """What one variant computes: ``group`` bags of a slide per window read
    (1 or 4), the accumulator's dtype, how the slab is made
    (:data:`ONEHOT`), ``overwrite``, the per-tile and chunk-liveness gates,
    the chunk in tiles (0: the whole window), or ``dmafloor``."""

    group: int = 1
    acc: torch.dtype = torch.float32
    onehot: str = "compare"
    overwrite: bool = False
    tile_gate: bool = False
    live_gate: bool = False
    chunk_tiles: int = 0
    dmafloor: bool = False


_BF16 = torch.bfloat16
# scripts/dbg_compact_ablate.py: one bag per block, the tile gate on, the
# whole window one chunk, an f32 accumulator
COMPACT = {
    "full": Probe(tile_gate=True),
    "dmafloor": Probe(dmafloor=True),
    "normw": Probe(tile_gate=True, overwrite=True),
    "bf16acc": Probe(tile_gate=True, acc=_BF16),
    "leanoh": Probe(tile_gate=True, onehot="rebased"),
    "bf16lean": Probe(tile_gate=True, acc=_BF16, onehot="rebased"),
}
# scripts/dbg_grouped_ablate.py: 4 bags of a slide share each tile, no gate,
# chunks of 8 tiles (16 for chunk16), the bf16 output block the accumulator
_G = dict(group=4, acc=_BF16, chunk_tiles=8)
GROUPED = {
    "full": Probe(**_G),
    "dmafloor": Probe(**{**_G, "dmafloor": True}),
    "normw": Probe(**_G, overwrite=True),
    "noonehot": Probe(**_G, onehot="const"),
    "leanoh": Probe(**_G, onehot="rebased"),
    "chunk16": Probe(**{**_G, "chunk_tiles": 16}),
}
# scripts/dbg_grouped_gate.py: the grouped kernel in chunks of 16 tiles with
# its ragged-window gates on or off
_GG = {**_G, "chunk_tiles": 16}
GATE = {
    "copy": Probe(**_GG, live_gate=True, tile_gate=True),
    "nolive": Probe(**_GG, tile_gate=True),
    "noinner": Probe(**_GG, live_gate=True),
    "nogate": Probe(**_GG),
}
PROBES = {"compact": COMPACT, "grouped": GROUPED, "gate": GATE}
# the variants whose output is K1's (bitwise), and those that compute
# something else
KEEPS_RESULT = {(s, v) for s, table in PROBES.items() for v, p in table.items()
                if not (p.dmafloor or p.overwrite or p.onehot == "const")}


def _leads(b: int, group: int, slides: int, device):
    """Each bag's group's first bag: bag ``(go group + j) slides + s`` is the
    ``j``-th of group ``(go, s)`` (the engines' repeat layout); with
    ``group`` 1, itself."""
    bag = torch.arange(b, device=device)
    return (bag // (group * slides)) * group * slides + bag % slides


def onehot_compact_plain(probe: Probe, bank, offs, ranks, feat: int, nump, slides: int = 0):
    """The twin of ``probe``: ``(B, feat, D)`` in the bank's dtype from
    ``bank (P, D)``, ``offs``/``nump (B,)`` and ``ranks (B, Nmax)`` (Nmax a
    multiple of 128), walking the tiles as the JAX loop does (the module's
    docstring); ``slides`` the slots per repeat of the grouped layout."""
    b, nmax = ranks.shape
    dev = ranks.device
    lead = _leads(b, probe.group, slides or b, dev)
    woff, wn = offs.long()[lead], nump.long()[lead]
    if probe.dmafloor:
        return bank[woff[:, None] + torch.arange(feat, device=dev)]
    n_tiles = nmax // TILE
    ct = probe.chunk_tiles or n_tiles
    acc = torch.zeros((b, feat, bank.shape[1]), dtype=probe.acc, device=dev)
    base = torch.zeros(b, dtype=torch.int64, device=dev)
    iota, rows = torch.arange(SLAB, device=dev), torch.arange(TILE, device=dev)
    bags = torch.arange(b, device=dev)[:, None]
    for c in range(-(-n_tiles // ct)):
        live = (c * ct * TILE < wn) if probe.live_gate else torch.ones_like(wn, dtype=torch.bool)
        for t in range(c * ct, min(n_tiles, (c + 1) * ct)):
            on = live & (t * TILE < wn) if probe.tile_gate else live
            r = ranks[:, t * TILE:(t + 1) * TILE].long()
            base_al = torch.clamp(base // 128 * 128, max=feat - SLAB)
            if probe.onehot == "const":
                oh = (iota < 1)[None, :, None].expand(b, SLAB, TILE)
            elif probe.onehot == "rebased":
                oh = iota[None, :, None] == (r - base_al[:, None])[:, None, :]
            else:
                oh = (iota[None, :, None] + base_al[:, None, None]) == r[:, None, :]
            x = bank[woff[:, None] + t * TILE + rows]
            prod = (oh.to(bank.dtype).float() @ x.float()).to(probe.acc)
            idx = base_al[:, None] + iota
            cur = acc[bags, idx]
            acc[bags, idx] = torch.where(on[:, None, None], prod if probe.overwrite else cur + prod,
                                         cur)
            base = torch.where(on, base + (r >= 0).sum(1), base)
    return acc.to(bank.dtype)


def _onehot_cuda(script, variant, probe, bank, offs, ranks, feat, nump, slides):
    name = f"onehot_{script}_{variant}"
    offs64, nump64 = offs.to(torch.int64).contiguous(), nump.to(torch.int64).contiguous()
    bank, ranks = bank.contiguous(), ranks.contiguous()
    _cuda.require_cuda(name, bank, offs64, ranks, nump64)
    b, nmax = ranks.shape
    d = bank.shape[1]
    slides = slides or b
    if bank.dtype != torch.bfloat16 or ranks.dtype != torch.int32:
        raise ValueError(f"{name}: needs a bf16 bank and int32 ranks")
    if (nmax % TILE or feat % TILE or feat < SLAB or feat > 32767 or d % 64
            or b % (probe.group * slides) or bank.data_ptr() % 16):
        raise ValueError(f"{name}: needs Nmax and feat multiples of {TILE}, {SLAB} <= feat < "
                         f"32768, D a multiple of 64 and the bags whole groups of "
                         f"{probe.group} x {slides} (got B {b}, Nmax {nmax}, feat {feat}, D {d})")
    out = torch.empty((b, feat, d), dtype=bank.dtype, device=bank.device)
    _cuda.check(_cuda.probe_library().murcl_compact_onehot(
        probe.group, int(probe.acc == torch.bfloat16), ONEHOT[probe.onehot],
        int(probe.overwrite), int(probe.tile_gate), int(probe.live_gate),
        probe.chunk_tiles or nmax // TILE, int(probe.dmafloor), bank.data_ptr(), bank.shape[0],
        offs64.data_ptr(), ranks.data_ptr(), nump64.data_ptr(), out.data_ptr(), b, nmax, feat, d,
        slides, _cuda.stream()), name)
    _cuda.LAUNCHES[name] += 1
    return out


def onehot_compact(script: str, variant: str, bank, offs, ranks, feat: int, nump,
                   slides: int = 0):
    """Variant ``variant`` of the probe script ``script`` (``compact``,
    ``grouped`` or ``gate``; :data:`PROBES`) over a bf16 ``bank (P, D)``
    (P past every window's end), ``offs``/``nump (B,)`` and ``ranks (B,
    Nmax)`` int32: ``(B, feat, D)``. ``slides``: the grouped layout's slots
    (bags ``m slides + s`` read slot ``s``'s window). CPU tensors take
    :func:`onehot_compact_plain`; CUDA tensors launch the kernel."""
    probe = PROBES[script][variant]
    if bank.device.type == "cpu":
        return onehot_compact_plain(probe, bank, offs, ranks, feat, nump, slides)
    return _onehot_cuda(script, variant, probe, bank, offs, ranks, feat, nump, slides)
