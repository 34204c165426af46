"""A TIFF and BigTIFF reader on numpy and the standard library, for
pyramidal slides (generic tiled TIFF, Aperio ``.svs``) without OpenSlide,
libtiff or PIL.

The layout it reads: headers ``II``/``MM`` with versions 42 (TIFF) and 43
(BigTIFF); the chain of image file directories (IFDs) with BYTE, ASCII,
SHORT, LONG, RATIONAL, UNDEFINED, LONG8 and the signed and floating types;
tiled images (tags 322-325) and stripped ones (273/278/279);
PlanarConfiguration 1, 8 bits per sample, 3 or 4 samples; Predictor 2
(each row a running sum per channel, modulo 256) with LZW and deflate, the
codecs libtiff applies it to. Edge tiles are stored at
full tile size, so a reader crops them.

Which IFDs are pyramid levels follows OpenSlide: the tiled ones, in order.
An Aperio file holds level 0 (tiled), a stripped thumbnail, the tiled
reductions, then the label and macro images (stripped, NewSubfileType 1 and
9), so its levels skip those. A file with no tiled IFD is one level, its
first IFD.

:class:`TiffFile` reads the directories and each tile's or strip's bytes
with ``os.pread``, which shares no file offset between threads.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from murcl_tpu_torch.preprocess import codecs

# tag numbers
NEW_SUBFILE_TYPE, IMAGE_WIDTH, IMAGE_LENGTH, BITS_PER_SAMPLE = 254, 256, 257, 258
COMPRESSION, PHOTOMETRIC, IMAGE_DESCRIPTION, STRIP_OFFSETS = 259, 262, 270, 273
SAMPLES_PER_PIXEL, ROWS_PER_STRIP, STRIP_BYTE_COUNTS = 277, 278, 279
X_RESOLUTION, Y_RESOLUTION, PLANAR_CONFIG, RESOLUTION_UNIT = 282, 283, 284, 296
PREDICTOR, TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTE_COUNTS = 317, 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT, JPEG_TABLES, YCBCR_SUBSAMPLING = 338, 339, 347, 530

# field type -> (struct code, size)
TYPES = {1: ("B", 1), 2: ("s", 1), 3: ("H", 2), 4: ("I", 4), 5: ("II", 8), 6: ("b", 1),
         7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 10: ("ii", 8), 11: ("f", 4), 12: ("d", 8),
         13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8)}
PHOTOMETRIC_RGB, PHOTOMETRIC_YCBCR = 2, 6


@dataclass
class TiffPage:
    """One IFD: its image's geometry and the tags a reader needs."""

    index: int
    tags: Dict[int, tuple]
    width: int = 0
    height: int = 0
    tiled: bool = False
    block_w: int = 0  # tile width, or the image width for strips
    block_h: int = 0  # tile length, or RowsPerStrip
    offsets: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))
    counts: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))

    def __post_init__(self):
        t = self.tags
        self.width, self.height = int(t[IMAGE_WIDTH][0]), int(t[IMAGE_LENGTH][0])
        self.tiled = TILE_OFFSETS in t
        if self.tiled:
            self.block_w, self.block_h = int(t[TILE_WIDTH][0]), int(t[TILE_LENGTH][0])
            offsets, counts = t[TILE_OFFSETS], t.get(TILE_BYTE_COUNTS, ())
        else:
            self.block_w = self.width
            self.block_h = min(int(t.get(ROWS_PER_STRIP, (self.height,))[0]), self.height)
            offsets, counts = t.get(STRIP_OFFSETS, ()), t.get(STRIP_BYTE_COUNTS, ())
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.counts = np.asarray(counts, dtype=np.int64)

    def tag(self, number: int, default=None):
        value = self.tags.get(number)
        return default if value is None else value[0]

    @property
    def compression(self) -> int:
        return int(self.tag(COMPRESSION, 1))

    @property
    def photometric(self) -> int:
        return int(self.tag(PHOTOMETRIC, PHOTOMETRIC_RGB))

    @property
    def samples(self) -> int:
        return int(self.tag(SAMPLES_PER_PIXEL, 1))

    @property
    def predictor(self) -> int:
        return int(self.tag(PREDICTOR, 1))

    @property
    def subfile_type(self) -> int:
        return int(self.tag(NEW_SUBFILE_TYPE, 0))

    @property
    def description(self) -> str:
        return self.tag(IMAGE_DESCRIPTION, "")

    @property
    def jpeg_tables(self) -> bytes:
        value = self.tags.get(JPEG_TABLES)
        return bytes(value) if value is not None else b""

    @property
    def grid(self) -> Tuple[int, int]:
        """(blocks across, blocks down)."""
        return -(-self.width // self.block_w), -(-self.height // self.block_h)

    def check_readable(self) -> None:
        """Raise unless this reader can decode the page's pixels."""
        bits = self.tags.get(BITS_PER_SAMPLE, (1,))
        where = f"TIFF IFD {self.index}"
        if any(int(b) != 8 for b in bits):
            raise ValueError(f"{where}: {tuple(int(b) for b in bits)} bits per sample; "
                             "only 8 is read")
        if self.samples not in (3, 4):
            raise ValueError(f"{where}: {self.samples} samples per pixel; only 3 (RGB) or 4 "
                             "(RGBA) are read")
        if int(self.tag(PLANAR_CONFIG, 1)) != 1:
            raise ValueError(f"{where}: PlanarConfiguration {self.tag(PLANAR_CONFIG)}; only 1 "
                             "(chunky) is read")
        if self.predictor not in (1, 2):
            raise ValueError(f"{where}: Predictor {self.predictor}; only 1 and 2 are read")
        if self.compression == codecs.JPEG:
            if self.photometric not in (PHOTOMETRIC_RGB, PHOTOMETRIC_YCBCR):
                raise ValueError(f"{where}: JPEG with Photometric {self.photometric}; only "
                                 "RGB (2) and YCbCr (6) are read")
        elif self.compression not in (codecs.NONE, codecs.LZW, codecs.DEFLATE,
                                      codecs.ADOBE_DEFLATE, codecs.PACKBITS):
            raise codecs.unsupported(self.compression)
        elif self.photometric != PHOTOMETRIC_RGB:
            raise ValueError(f"{where}: Photometric {self.photometric} without JPEG; only RGB "
                             "(2) is read")
        n = self.grid[0] * self.grid[1]
        if len(self.offsets) < n or len(self.counts) < n:
            raise ValueError(f"{where}: {len(self.offsets)} offsets and {len(self.counts)} byte "
                             f"counts for {n} blocks")


class TiffFile:
    """The directories of a TIFF or BigTIFF file and its blocks' bytes."""

    def __init__(self, path):
        self.path = str(path)
        self._fd = os.open(self.path, os.O_RDONLY)
        try:
            self.pages = self._read_pages()
        except Exception:
            os.close(self._fd)
            raise

    def close(self) -> None:
        if self._fd >= 0:
            os.close(self._fd)
            self._fd = -1

    def read(self, offset: int, count: int) -> bytes:
        data = os.pread(self._fd, int(count), int(offset))
        if len(data) != count:
            raise ValueError(f"{self.path}: {count} bytes at {offset} run past the file's end")
        return data

    def _read_pages(self) -> List[TiffPage]:
        head = self.read(0, 16) if os.fstat(self._fd).st_size >= 16 else self.read(0, 8)
        if head[:2] not in (b"II", b"MM"):
            raise ValueError(f"{self.path}: not a TIFF file (byte order {head[:2]!r})")
        e = "<" if head[:2] == b"II" else ">"
        version = struct.unpack(e + "H", head[2:4])[0]
        if version == 42:
            big, offset = False, struct.unpack(e + "I", head[4:8])[0]
        elif version == 43:
            big, offset = True, struct.unpack(e + "Q", head[8:16])[0]
        else:
            raise ValueError(f"{self.path}: TIFF version {version}; only 42 (TIFF) and 43 "
                             "(BigTIFF) are read")
        pages, seen = [], set()
        while offset and offset not in seen:
            seen.add(offset)
            tags, offset = self._read_ifd(e, big, offset)
            pages.append(TiffPage(len(pages), tags))
        return pages

    def _read_ifd(self, e: str, big: bool, offset: int):
        count_fmt, entry_size, inline, next_fmt = ("Q", 20, 8, "Q") if big else ("H", 12, 4, "I")
        csize = struct.calcsize(count_fmt)
        n = struct.unpack(e + count_fmt, self.read(offset, csize))[0]
        raw = self.read(offset + csize, n * entry_size + struct.calcsize(next_fmt))
        tags = {}
        for i in range(n):
            entry = raw[i * entry_size:(i + 1) * entry_size]
            tag, typ = struct.unpack(e + "HH", entry[:4])
            count = struct.unpack(e + ("Q" if big else "I"), entry[4:4 + (8 if big else 4)])[0]
            field_bytes = entry[entry_size - inline:]
            if typ not in TYPES:
                continue  # a type this reader does not know: the tag is skipped
            code, size = TYPES[typ]
            nbytes = size * count
            data = (field_bytes[:nbytes] if nbytes <= inline
                    else self.read(struct.unpack(e + ("Q" if big else "I"), field_bytes)[0],
                                   nbytes))
            tags[tag] = _decode_field(e, typ, code, count, data)
        next_offset = struct.unpack(e + next_fmt, raw[n * entry_size:])[0]
        return tags, next_offset

    @property
    def levels(self) -> List[TiffPage]:
        """The pyramid, as OpenSlide takes it: the tiled IFDs in order, else
        the first IFD."""
        tiled = [p for p in self.pages if p.tiled]
        return tiled or self.pages[:1]

    def block(self, page: TiffPage, i: int,
              jpeg: Optional[Callable[[bytes, int], np.ndarray]] = None) -> np.ndarray:
        """Block ``i`` (row-major) of ``page`` as ``(rows, block_w, samples)``
        uint8: a full tile, or a strip (the last one may hold fewer rows).
        ``jpeg(stream, photometric)`` decodes a JPEG block to RGB."""
        rows = page.block_h if page.tiled else min(page.block_h,
                                                   page.height - i * page.block_h)
        raw = self.read(page.offsets[i], page.counts[i])
        if page.compression == codecs.JPEG:
            if jpeg is None:
                raise ValueError(f"{self.path}: JPEG blocks need a JPEG decoder")
            tables = page.jpeg_tables
            stream = tables[:-2] + raw[2:] if tables else raw  # splice the shared tables in
            arr = jpeg(stream, page.photometric)
            if arr.shape[0] < rows or arr.shape[1] < page.block_w:
                raise ValueError(f"{self.path}: JPEG block {i} decodes to {arr.shape[:2]}, "
                                 f"not ({rows}, {page.block_w})")
            return arr[:rows, :page.block_w]
        data = codecs.decompress(page.compression, raw)
        need = rows * page.block_w * page.samples
        if len(data) < need:
            raise ValueError(f"{self.path}: block {i} of IFD {page.index} holds {len(data)} "
                             f"bytes, not {need}")
        arr = np.frombuffer(data, dtype=np.uint8, count=need).reshape(rows, page.block_w,
                                                                      page.samples)
        if page.predictor == 2 and page.compression in codecs.PREDICTED:
            arr = np.cumsum(arr, axis=1, dtype=np.uint8)  # horizontal differencing undone
        return arr


def _decode_field(e: str, typ: int, code: str, count: int, data: bytes) -> tuple:
    if typ == 2:  # ASCII, NUL-terminated
        return (data.split(b"\0", 1)[0].decode("latin-1"),)
    if typ in (1, 7):
        return tuple(data)
    if typ in (5, 10):
        vals = struct.unpack(f"{e}{2 * count}{code[0]}", data)
        return tuple(vals[i] / vals[i + 1] if vals[i + 1] else 0.0
                     for i in range(0, len(vals), 2))
    return struct.unpack(f"{e}{count}{code}", data)


def slide_properties(page: TiffPage) -> Dict[str, str]:
    """OpenSlide's properties from level 0's tags: ``aperio.*`` from an
    Aperio ImageDescription (``...|AppMag = 20|...|MPP = 0.4990``), with
    ``openslide.mpp-x``/``-y`` and ``openslide.objective-power`` from them;
    otherwise ``openslide.mpp-x``/``-y`` from XResolution/YResolution
    (``10000 / x`` for ResolutionUnit 3, centimetres; ``25400 / x`` for 2,
    inches)."""
    props = {}
    desc = page.description
    if desc:
        props["tiff.ImageDescription"] = desc
    if desc.startswith("Aperio"):
        for part in desc.split("|")[1:]:
            key, sep, value = part.partition("=")
            if sep:
                props[f"aperio.{key.strip()}"] = value.strip()
        if "aperio.MPP" in props:
            props["openslide.mpp-x"] = props["openslide.mpp-y"] = props["aperio.MPP"]
        if "aperio.AppMag" in props:
            props["openslide.objective-power"] = props["aperio.AppMag"]
        return props
    unit = int(page.tag(RESOLUTION_UNIT, 2))
    scale = {2: 25400.0, 3: 10000.0}.get(unit)
    for axis, tag in (("x", X_RESOLUTION), ("y", Y_RESOLUTION)):
        res = page.tag(tag)
        if scale is not None and res:
            props[f"openslide.mpp-{axis}"] = repr(scale / float(res))
    return props
