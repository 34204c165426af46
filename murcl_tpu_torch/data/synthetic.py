"""Synthetic dataset written in the on-disk contract, without pandas.

Counterpart of ``murcl_tpu/data/synthetic.py`` (``make_synthetic_slide``,
``generate_synthetic_dataset``): fake slides with random patch features,
class-dependent signal and clusters by construction. ``slide_patches``
fixes every slide's patch count (the benchmark shape); otherwise counts are
drawn from ``[min_patches, max_patches]``. :func:`synthetic_slide` draws
a slide image (tissue blobs and pen strokes on white) for the
preprocessing path, and :func:`write_tiff` writes slide images as tiled,
pyramidal TIFF files (Aperio's ``.svs`` layout included) with numpy and the
standard library, for machines without PIL or libtiff.
"""

from __future__ import annotations

import struct
from concurrent.futures import ThreadPoolExecutor
from fractions import Fraction
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from murcl_tpu_torch.data import contract
from murcl_tpu_torch.utils.general import dump_json


def make_synthetic_slide(rng: np.random.Generator, num_patches: int, dim: int,
                         num_clusters: int, label: int, signal: float = 2.0):
    """One fake slide: features ``(N, D)`` float32 + cluster labels ``(N,)``."""
    centroids = rng.normal(size=(num_clusters, dim)).astype(np.float32)
    assignment = rng.integers(0, num_clusters, size=num_patches)
    feats = centroids[assignment] + 0.3 * rng.normal(
        size=(num_patches, dim)).astype(np.float32)
    if label == 1:
        tumor_mask = assignment == int(rng.integers(0, num_clusters))
        feats[tumor_mask] += signal / np.sqrt(dim)
    return feats.astype(np.float32), assignment.astype(np.int64)


def generate_synthetic_dataset(root, num_slides: int = 8, dim: int = 64,
                               num_clusters: int = 5, min_patches: int = 60,
                               max_patches: int = 200, seed: int = 985,
                               splits: Optional[dict] = None,
                               slide_patches: Optional[int] = None,
                               signal: float = 2.0) -> dict:
    """Write ``features/``, ``k-means-K/``, ``synthetic_{K}.csv`` and
    ``data_split.json`` under ``root``; return their paths. ``signal`` is
    the shift of the label-1 slides' tumour cluster (times ``1 / sqrt(dim)``;
    ``scale_smoke`` draws 6.0)."""
    root = Path(root)
    feat_dir = root / "features"
    cluster_dir = root / f"k-means-{num_clusters}"
    feat_dir.mkdir(parents=True, exist_ok=True)
    cluster_dir.mkdir(parents=True, exist_ok=True)

    rng = np.random.default_rng(seed)
    rows: List[dict] = []
    case_ids: List[str] = []
    for i in range(num_slides):
        case_id = f"synt_{i:03d}"
        label = i % 2
        n = slide_patches or int(rng.integers(min_patches, max_patches + 1))
        feats, assignment = make_synthetic_slide(rng, n, dim, num_clusters, label, signal)
        side = int(np.ceil(np.sqrt(n)))
        coords = np.stack([np.arange(n) // side, np.arange(n) % side], axis=1)
        feat_path = feat_dir / f"{case_id}.npz"
        contract.save_features_npz(feat_path, case_id, num_row=side, num_col=side,
                                   img_features=feats, coords=coords.astype(np.int64))
        contract.save_cluster_npz_json(
            assignment, num_clusters,
            npz_path=cluster_dir / f"{case_id}.npz",
            json_path=cluster_dir / f"{case_id}.json")
        rows.append({
            "case_id": case_id,
            "features_filepath": str(feat_path),
            "label": label,
            "clusters_filepath": str(cluster_dir / f"{case_id}.npz"),
            "clusters_json_filepath": str(cluster_dir / f"{case_id}.json"),
        })
        case_ids.append(case_id)

    data_csv = root / f"synthetic_{num_clusters}.csv"
    contract.save_manifest(data_csv, rows)

    if splits is None:
        n_train = max(2, int(0.5 * num_slides))
        n_valid = max(1, int(0.25 * num_slides))
        splits = {
            "train": case_ids[:n_train],
            "valid": case_ids[n_train:n_train + n_valid],
            "test": case_ids[n_train + n_valid:] or case_ids[-2:],
        }
    split_path = root / "data_split.json"
    dump_json(splits, split_path)
    return {
        "data_csv": str(data_csv),
        "data_split_json": str(split_path),
        "feat_dir": str(feat_dir),
        "cluster_dir": str(cluster_dir),
        "case_ids": case_ids,
        "num_clusters": num_clusters,
        "dim": dim,
    }


def synthetic_slide(height: int, width: int, seed: int = 0, cell: int = 32) -> np.ndarray:
    """An ``(height, width, 3)`` uint8 RGB slide: white, with a few elliptic
    blobs of pink tissue texture (a 256-pixel random tile repeated) and red
    and blue pen strokes, drawn on a grid of ``cell`` pixels so that a
    gigapixel slide takes seconds; ``height`` and ``width`` are multiples of
    ``cell``."""
    rng = np.random.default_rng(seed)
    gh, gw = height // cell, width // cell
    yy, xx = np.mgrid[0:gh, 0:gw]
    tissue = np.zeros((gh, gw), dtype=bool)
    for _ in range(4):
        cy, cx = rng.uniform(0.2, 0.8) * gh, rng.uniform(0.2, 0.8) * gw
        ry, rx = rng.uniform(0.12, 0.3) * gh, rng.uniform(0.12, 0.3) * gw
        tissue |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1.0
    pen = np.zeros((gh, gw), dtype=np.uint8)  # 1 red, 2 blue
    for colour in (1, 2):
        row = int(rng.integers(gh // 10, gh - gh // 10))
        c0 = int(rng.integers(0, gw // 4))
        pen[row:row + max(gh // 40, 1), c0:c0 + gw // 2] = colour
    tile = np.stack([rng.integers(180, 230, (256, 256)), rng.integers(120, 170, (256, 256)),
                     rng.integers(160, 210, (256, 256))], axis=-1).astype(np.uint8)
    up = lambda m: np.repeat(np.repeat(m, cell, axis=0), cell, axis=1)  # noqa: E731
    img = np.where(up(tissue)[..., None], np.tile(tile, (-(-height // 256), -(-width // 256), 1))
                   [:height, :width], np.uint8(255))
    pens = up(pen)
    img[pens == 1] = (230, 30, 40)
    img[pens == 2] = (40, 50, 220)
    return img


# compression name -> TIFF code (JPEG blocks come from the caller's encoder)
TIFF_CODECS = {"none": 1, "lzw": 5, "jpeg": 7, "deflate": 8, "adobe_deflate": 32946,
               "packbits": 32773}


def aperio_description(width: int, height: int, tile: int, app_mag: float = 40,
                       mpp: float = 0.25) -> str:
    """An Aperio ImageDescription for level 0, as Aperio's scanners write it
    (``|``-separated ``key = value`` fields after the first line)."""
    return (f"Aperio Image Library v11.2.1 \r\n{width}x{height} [0,0 {width}x{height}] "
            f"({tile}x{tile}) RGB|AppMag = {app_mag:g}|MPP = {mpp:.4f}|Filename = synthetic")


def _differenced(block: np.ndarray) -> np.ndarray:
    """Predictor 2: each pixel minus its left neighbour, per channel, mod 256."""
    out = block.copy()
    out[:, 1:] -= block[:, :-1]
    return out


def _blocks(img: np.ndarray, bw: int, bh: int, tiled: bool):
    """Row-major blocks: full ``bh x bw`` tiles (edges zero-padded), or strips
    of ``bh`` rows (the last one shorter)."""
    h, w = img.shape[:2]
    for y in range(0, h, bh):
        if not tiled:
            yield img[y:y + bh]
            continue
        for x in range(0, w, bw):
            block = img[y:y + bh, x:x + bw]
            if block.shape[:2] != (bh, bw):
                full = np.zeros((bh, bw, img.shape[2]), np.uint8)
                full[:block.shape[0], :block.shape[1]] = block
                block = full
            yield block


class _TiffWriter:
    """Appends IFDs with their blocks to a TIFF or BigTIFF file."""

    def __init__(self, fp, bigtiff: bool, byteorder: str):
        self.fp, self.big, self.e = fp, bigtiff, byteorder
        mark = b"II" if byteorder == "<" else b"MM"
        if bigtiff:
            fp.write(mark + struct.pack(byteorder + "HHHQ", 43, 8, 0, 0))
            self._link = 8
        else:
            fp.write(mark + struct.pack(byteorder + "HI", 42, 0))
            self._link = 4

    def blocks(self, encoded) -> Tuple[list, list]:
        offsets, counts = [], []
        for data in encoded:
            offsets.append(self.fp.tell())
            counts.append(len(data))
            self.fp.write(data)
        return offsets, counts

    def ifd(self, tags: dict) -> None:
        """``tags``: number -> (type, values); ASCII and UNDEFINED take bytes."""
        e, fp = self.e, self.fp
        if fp.tell() % 2:
            fp.write(b"\0")
        pos = fp.tell()
        count_fmt, entry, inline, off_fmt = ("Q", 20, 8, "Q") if self.big else ("H", 12, 4, "I")
        n = len(tags)
        values_at = pos + struct.calcsize(count_fmt) + n * entry + struct.calcsize(off_fmt)
        entries, values = [], bytearray()
        for tag in sorted(tags):
            typ, vals = tags[tag]
            if typ in (2, 7):
                data, count = bytes(vals), len(vals)
            elif typ == 5:
                fr = [Fraction(v).limit_denominator(1 << 30) for v in vals]
                data = b"".join(struct.pack(e + "II", f.numerator, f.denominator) for f in fr)
                count = len(vals)
            else:
                code = {3: "H", 4: "I", 16: "Q"}[typ]
                data, count = struct.pack(f"{e}{len(vals)}{code}", *vals), len(vals)
            if len(data) <= inline:
                field = data.ljust(inline, b"\0")
            else:
                field = struct.pack(e + off_fmt, values_at + len(values))
                values += data
                if len(values) % 2:
                    values += b"\0"
            entries.append(struct.pack(e + "HH" + ("Q" if self.big else "I"), tag, typ, count)
                           + field)
        fp.write(struct.pack(e + count_fmt, n) + b"".join(entries)
                 + struct.pack(e + off_fmt, 0) + bytes(values))
        end = fp.tell()
        fp.seek(self._link)
        fp.write(struct.pack(e + off_fmt, pos))
        fp.seek(end)
        self._link = pos + struct.calcsize(count_fmt) + n * entry


def write_tiff(path, levels: Sequence[np.ndarray], *, tile: int = 256,
               compression: str = "deflate", predictor: int = 1, bigtiff: bool = False,
               stripped: bool = False, description: Optional[str] = None,
               resolution: Optional[Tuple[float, int]] = None, svs_extras: bool = False,
               jpeg: Optional[Tuple[bytes, Callable[[np.ndarray], bytes], int, Tuple[int, int]]]
               = None,
               byteorder: str = "<") -> None:
    """Write ``levels`` (``(H, W, 3 or 4)`` uint8 arrays, level 0 first) as a
    TIFF (``bigtiff=False``) or BigTIFF file, one IFD per level.

    - ``tile``: the tile size, or with ``stripped=True`` the rows per strip;
    - ``compression``: a key of :data:`TIFF_CODECS`. ``"jpeg"`` takes
      ``jpeg = (tables, encode, photometric, subsampling)``: the JPEGTables
      stream, a function from a tile's pixels to its abbreviated JPEG
      stream, the Photometric tag (2 RGB, 6 YCbCr) and, for YCbCr, the
      chroma subsampling ``(h, v)`` the streams were encoded with;
    - ``predictor``: 1, or 2 (horizontal differencing; LZW and deflate);
    - ``description``: level 0's ImageDescription (:func:`aperio_description`);
    - ``resolution``: ``(pixels per unit, ResolutionUnit)`` on every level;
    - ``svs_extras``: Aperio's other images, all stripped: a thumbnail after
      level 0, then a label (NewSubfileType 1) and a macro (9) at the end.
    Blocks are encoded by 8 threads (zlib releases the interpreter lock)."""
    code = TIFF_CODECS[compression]
    if predictor == 2 and compression not in ("lzw", "deflate", "adobe_deflate"):
        raise ValueError(f"write_tiff: Predictor 2 goes with LZW or deflate, not {compression}")
    if (code == 7) != (jpeg is not None):
        raise ValueError("write_tiff: jpeg=(tables, encode, photometric, subsampling) goes with "
                         "compression='jpeg' and only with it")
    from murcl_tpu_torch.preprocess import codecs

    def encode(block):
        if code == 7:
            return jpeg[1](block)
        if predictor == 2:
            block = _differenced(block)
        return codecs.compress(code, np.ascontiguousarray(block).tobytes())

    big = 16 if bigtiff else 4  # LONG8 or LONG offsets

    def base_tags(img, comp, photometric):
        h, w, c = img.shape
        tags = {256: (4, [w]), 257: (4, [h]), 258: (3, [8] * c), 259: (3, [comp]),
                262: (3, [photometric]), 277: (3, [c]), 284: (3, [1])}
        if c == 4:
            tags[338] = (3, [2])  # unassociated alpha
        if resolution is not None:
            tags.update({282: (5, [resolution[0]]), 283: (5, [resolution[0]]),
                         296: (3, [resolution[1]])})
        return tags

    def extra(writer, img, subfile, desc):
        tags = base_tags(img, 1, 2)
        offs, counts = writer.blocks(b.tobytes() for b in _blocks(img, img.shape[1], 64, False))
        tags.update({254: (4, [subfile]), 270: (2, desc.encode() + b"\0"),
                     273: (big, offs), 278: (4, [64]), 279: (big, counts)})
        writer.ifd(tags)

    with open(path, "wb") as fp, ThreadPoolExecutor(8) as pool:
        writer = _TiffWriter(fp, bigtiff, byteorder)
        for k, img in enumerate(levels):
            img = np.ascontiguousarray(img, dtype=np.uint8)
            photometric = jpeg[2] if code == 7 else 2
            tags = base_tags(img, code, photometric)
            offs, counts = writer.blocks(pool.map(encode, _blocks(img, tile, tile, not stripped)))
            if stripped:
                tags.update({273: (big, offs), 278: (4, [tile]), 279: (big, counts)})
            else:
                tags.update({322: (4, [tile]), 323: (4, [tile]), 324: (big, offs),
                             325: (big, counts)})
            if k > 0 and not svs_extras:
                tags[254] = (4, [1])  # a reduced-resolution image
            if predictor == 2:
                tags[317] = (3, [2])
            if code == 7:
                tags[347] = (7, jpeg[0])
                if photometric == 6:
                    tags[530] = (3, list(jpeg[3]))
            if description is not None and (k == 0 or svs_extras):
                tags[270] = (2, description.encode() + b"\0")
            writer.ifd(tags)
            if k == 0 and svs_extras:
                small = levels[-1][::2, ::2, :3]
                extra(writer, np.ascontiguousarray(small), 0, "Aperio thumbnail")
        if svs_extras:
            extra(writer, np.full((48, 64, 3), 200, np.uint8), 1, "Aperio label 64x48")
            extra(writer, np.full((40, 96, 3), 90, np.uint8), 9, "Aperio macro 96x40")


def write_jpeg_fixture_tiff(path, variant: str, repeat: int = 1, *, fixture=None,
                            size: Optional[Tuple[int, int]] = None,
                            downsamples: Sequence[int] = (1,),
                            description: Optional[str] = None) -> np.ndarray:
    """A JPEG-tiled TIFF of a committed fixture's four tiles of ``variant``
    (``preprocess/nvjpeg.py`` ``load_fixture``; ``FIXTURE`` unless
    ``fixture`` names another) in a 2 x 2 grid, repeated ``repeat`` times
    across; or, given ``size = (w, h)`` (multiples of the tile), a pyramid
    with one level per downsample in ``downsamples``, each that grid
    repeated over the level. Returns level 0 as PIL decodes it."""
    from murcl_tpu_torch.preprocess.nvjpeg import FIXTURE, load_fixture

    fx = load_fixture(fixture or FIXTURE)[variant]
    t = fx["decoded"].shape[1]
    grid = np.concatenate([np.concatenate(list(fx["decoded"][r * 2:r * 2 + 2]), axis=1)
                           for r in range(2)])
    if size is None:
        levels = [np.ascontiguousarray(np.tile(grid, (1, repeat, 1)))]
    else:
        levels = []
        for d in downsamples:
            w, h = size[0] // d, size[1] // d
            if w % t or h % t:
                raise ValueError(f"write_jpeg_fixture_tiff: level {w} x {h} is not made of "
                                 f"{t}-pixel tiles")
            reps = (-(-h // (2 * t)), -(-w // (2 * t)), 1)
            levels.append(np.ascontiguousarray(np.tile(grid, reps)[:h, :w]))
    streams = {d.tobytes(): s for d, s in zip(fx["decoded"], fx["streams"])}
    sub = (2, 2) if variant == "ycbcr420" else (1, 1)
    write_tiff(path, levels, tile=t, compression="jpeg", description=description,
               jpeg=(fx["tables"], lambda tile: streams[tile.tobytes()], fx["photometric"], sub))
    return levels[0]
