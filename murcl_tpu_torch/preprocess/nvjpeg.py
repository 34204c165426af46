"""JPEG tiles of TIFF slides, decoded on the card by nvJPEG, or on the CPU by
PIL.

On the card: ``libnvjpeg`` from the CUDA toolkit that ``ops/_cuda.py`` finds
``nvcc`` in (its ``lib64`` or ``targets/*/lib``), loaded with :mod:`ctypes`
and kept out of the kernels' library, so that a toolkit without it breaks
no kernel build. :class:`NvJpegDecoder` creates one handle
(``nvjpegCreateSimple``) and, per calling thread, one ``nvjpegJpegState``
and one CUDA stream: the extraction reads patches with several threads,
and a decode then waits only for its own stream. ``nvjpegDecode`` writes
into a CUDA tensor on that stream, which is copied back to the host, so
``read_region`` keeps its numpy contract. A failure to load or run
nvJPEG raises with the library's name; nothing falls back to the CPU.

The TIFF's Photometric tag decides the colour space, as libtiff and
OpenSlide decide it, not the stream's markers: with Photometric RGB (2),
as in Aperio's files, the stream's three components are R, G and B already
and carry no Adobe marker that says so, so they are decoded raw
(``NVJPEG_OUTPUT_UNCHANGED``, planar). Photometric YCbCr (6) is decoded to
its planes (``NVJPEG_OUTPUT_YUV``, chroma at its subsampled size: 4:2:0 in
Camelyon16-style files), and :func:`ycc_to_rgb` (one launch of
``csrc/ycc_rgb.cu`` per tile) upsamples and converts them on the card as
libjpeg does (the fancy upsampling and the 16-bit fixed-point tables PIL's
and OpenSlide's libjpeg use): nvJPEG's own RGB output upsamples chroma
otherwise, and then differs from PIL by up to 25 on 4:2:0 tiles.

On the CPU (``device="cpu"``, as the tests run) JPEG blocks go to PIL where
it imports, told the same colour space; where it does not, they are refused
by name.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import io
import os
import threading
from functools import lru_cache
from pathlib import Path
from typing import List

import numpy as np

PHOTOMETRIC_RGB, PHOTOMETRIC_YCBCR = 2, 6
NVJPEG_OUTPUT_UNCHANGED, NVJPEG_OUTPUT_YUV = 0, 1
CSS_444 = 0
_STATUS = {1: "NOT_INITIALIZED", 2: "INVALID_PARAMETER", 3: "BAD_JPEG",
           4: "JPEG_NOT_SUPPORTED", 5: "ALLOCATOR_FAILURE", 6: "EXECUTION_FAILED",
           7: "ARCH_MISMATCH", 8: "INTERNAL_ERROR", 9: "IMPLEMENTATION_NOT_SUPPORTED",
           10: "INCOMPLETE_BITSTREAM"}


class _Image(ctypes.Structure):
    """``nvjpegImage_t``: up to four planes and their pitches."""

    _fields_ = [("channel", ctypes.c_void_p * 4), ("pitch", ctypes.c_size_t * 4)]


_lib = None
_lib_lock = threading.Lock()
_launch_lock = threading.Lock()  # the reading threads count ycc_to_rgb's launches
FIXTURE = Path(__file__).resolve().parent / "fixtures" / "jpeg_tiles.npz"
# four 256 x 256 YCbCr 4:2:0 tiles, a slide's tile size, for slides of the
# card's size made of them
FIXTURE_256 = FIXTURE.with_name("jpeg_tiles_256.npz")
# nvJPEG against PIL (libjpeg-turbo) on the fixture, per variant: (max,
# mean) absolute difference. Upsampling and colour conversion are
# libjpeg's own (ycc_to_rgb), so only the IDCT differs: JPEG lets a
# decoder's IDCT differ by 1 per sample (IEEE 1180); raw RGB components
# then differ by 1, and YCbCr by up to 1 + 1.772 after conversion. The
# means read on an H100 were 0.020-0.030 (YCbCr) and 0.012 (RGB); a
# wrong upsampling or colour conversion that stays within the max moves
# the mean well past these limits.
FIXTURE_BOUND = {"ycbcr444": (3, 0.1), "ycbcr420": (3, 0.1), "rgb": (1, 0.05)}


class DecoderUnavailable(RuntimeError):
    """The JPEG decoder asked for cannot run here (libnvjpeg or the card for
    a CUDA device, PIL for the CPU): no slide with JPEG tiles can be read,
    so the CLIs stop rather than skip slide after slide."""


def load_fixture(path=FIXTURE) -> dict:
    """Committed JPEG tiles (written by PIL, their JPEGTables split out:
    in ``FIXTURE`` YCbCr 4:4:4 and 4:2:0 and RGB without an Adobe marker,
    in ``FIXTURE_256`` YCbCr 4:2:0) with PIL's decode of each (stored as
    differences across, then down, modulo 256): variant -> ``{"tables",
    "streams", "decoded", "photometric"}``."""
    out = {}
    with np.load(path) as z:
        for variant in dict.fromkeys(k.split("_")[0] for k in z.files):
            data, lengths = z[f"{variant}_streams"].tobytes(), z[f"{variant}_lengths"]
            starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
            delta = z[f"{variant}_decoded_delta"]
            decoded = np.cumsum(np.cumsum(delta, axis=1, dtype=np.uint8), axis=2, dtype=np.uint8)
            out[variant] = {"tables": z[f"{variant}_tables"].tobytes(),
                            "streams": [data[s:s + n] for s, n in zip(starts, lengths)],
                            "decoded": decoded,
                            "photometric": int(z[f"{variant}_photometric"])}
    return out


def library_candidates() -> List[Path]:
    """``libnvjpeg.so*`` beside the toolkit of ``nvcc``, then under
    ``$CUDA_HOME`` (default ``/usr/local/cuda``)."""
    roots = []
    try:
        from murcl_tpu_torch.ops._cuda import _nvcc

        roots.append(Path(_nvcc()).resolve().parents[1])
    except RuntimeError:
        pass
    roots.append(Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")))
    found = []
    for root in roots:
        for pattern in ("lib64/libnvjpeg.so*", "lib/libnvjpeg.so*", "targets/*/lib/libnvjpeg.so*"):
            found += [p for p in sorted(root.glob(pattern)) if p not in found]
    return found


def load_library():
    """Load libnvjpeg once; raise naming it when it cannot be found or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        paths = [str(p) for p in library_candidates()]
        system = ctypes.util.find_library("nvjpeg")
        if system:
            paths.append(system)
        errors = []
        for path in paths:
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError as e:
                errors.append(f"{path}: {e}")
        else:
            raise DecoderUnavailable("JPEG tiles on the card need libnvjpeg (the CUDA toolkit's "
                               "nvJPEG); none could be loaded"
                               + (": " + "; ".join(errors) if errors else
                                  " (no libnvjpeg.so* beside nvcc or under $CUDA_HOME)"))
        P, I, S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
        sigs = {
            "nvjpegCreateSimple": [ctypes.POINTER(P)],
            "nvjpegDestroy": [P],
            "nvjpegJpegStateCreate": [P, ctypes.POINTER(P)],
            "nvjpegJpegStateDestroy": [P],
            "nvjpegGetImageInfo": [P, ctypes.c_char_p, S, ctypes.POINTER(I), ctypes.POINTER(I),
                                   ctypes.POINTER(I * 4), ctypes.POINTER(I * 4)],
            "nvjpegDecode": [P, P, ctypes.c_char_p, S, I, ctypes.POINTER(_Image), P],
        }
        for fn, argtypes in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = I
        _lib = lib
        return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"libnvjpeg: {what} failed with "
                           f"NVJPEG_STATUS_{_STATUS.get(status, status)}")


@lru_cache(maxsize=8)
def _ycc_tables(device) -> tuple:
    """libjpeg's ``build_ycc_rgb_table`` (jdcolor.c), 16-bit fixed point, on
    ``device`` (built once per device)."""
    import torch

    x = torch.arange(256, dtype=torch.int64) - 128

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    half = 1 << 15
    tabs = ((fix(1.40200) * x + half) >> 16, (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)
    return tuple(t.to(device=device, dtype=torch.int32) for t in tabs)


def _fancy(plane, axis: int, out_len: int):
    """libjpeg's fancy upsampling by 2 along ``axis`` of an int32 plane, for
    one axis alone (``h2v1``/``h1v2``): 3/4 of the nearer sample and 1/4 of
    the further, rounding biases 1 and 2, edges replicated."""
    import torch

    n = plane.shape[axis]
    idx = torch.arange(n, device=plane.device)
    prev = plane.index_select(axis, (idx - 1).clamp_min(0))
    nxt = plane.index_select(axis, (idx + 1).clamp_max(n - 1))
    near = 3 * plane
    out = torch.stack(((near + prev + 1) >> 2, (near + nxt + 2) >> 2), dim=axis + 1)
    shape = list(plane.shape)
    shape[axis] = 2 * n
    return out.reshape(shape).narrow(axis, 0, out_len)


def _fancy_h2v2(plane, h: int, w: int):
    """libjpeg's ``h2v2_fancy_upsample``: column sums ``3 * near + far`` per
    output row, then ``(3 * sum + neighbour's sum + 8 or 7) >> 4``."""
    import torch

    rows, cols = plane.shape
    r = torch.arange(rows, device=plane.device)
    above = plane[(r - 1).clamp_min(0)]
    below = plane[(r + 1).clamp_max(rows - 1)]
    sums = torch.stack((3 * plane + above, 3 * plane + below), dim=1).reshape(2 * rows, cols)
    c = torch.arange(cols, device=plane.device)
    left = sums[:, (c - 1).clamp_min(0)]
    right = sums[:, (c + 1).clamp_max(cols - 1)]
    out = torch.stack(((3 * sums + left + 8) >> 4, (3 * sums + right + 7) >> 4), dim=2)
    return out.reshape(2 * rows, 2 * cols)[:h, :w]


def _factors(luma, chroma) -> tuple:
    """``(fv, fh)``: 2 where the chroma plane is halved down / across."""
    (h, w), (ph, pw) = luma, chroma
    for fv, fh in ((1, 1), (2, 2), (1, 2), (2, 1)):
        if (ph, pw) == (-(-h // fv), -(-w // fh)):
            return fv, fh
    raise ValueError(f"JPEG chroma of {ph} x {pw} for luma of {h} x {w} is not read")


def ycc_to_rgb(y, cb, cr):
    """JPEG YCbCr planes (uint8; chroma full size, or halved across, down or
    both) -> ``(h, w, 3)`` uint8 RGB, as libjpeg-turbo decodes them: fancy
    upsampling, then ``ycc_rgb_convert``'s tables, clamped to 0-255. On CUDA
    tensors one launch of ``csrc/ycc_rgb.cu`` on the current stream; on the
    CPU its plain twin, :func:`ycc_to_rgb_plain`."""
    import torch

    if y.device.type != "cuda":
        return ycc_to_rgb_plain(y, cb, cr)
    from murcl_tpu_torch.ops import _cuda

    if cb.shape != cr.shape:
        raise ValueError(f"JPEG chroma planes of {tuple(cb.shape)} and {tuple(cr.shape)}")
    (h, w), (ch, cw) = y.shape, cb.shape
    fv, fh = _factors((h, w), (ch, cw))
    _cuda.require_cuda("ycc_to_rgb", y, cb, cr)
    out = torch.empty((h, w, 3), dtype=torch.uint8, device=y.device)
    _cuda.check(_cuda.library().murcl_ycc_to_rgb(y.data_ptr(), cb.data_ptr(), cr.data_ptr(),
                                                 out.data_ptr(), h, w, ch, cw, fv, fh,
                                                 _cuda.stream()), "ycc_to_rgb")
    with _launch_lock:
        _cuda.LAUNCHES["ycc_to_rgb"] += 1
    return out


def ycc_to_rgb_plain(y, cb, cr):
    """:func:`ycc_to_rgb` in PyTorch ops, on any device: the kernel's twin."""
    import torch

    h, w = y.shape
    chroma = []
    for plane in (cb, cr):
        p = plane.to(torch.int32)
        fv, fh = _factors((h, w), p.shape)
        if (fv, fh) == (2, 2):
            p = _fancy_h2v2(p, h, w)
        elif fh == 2:
            p = _fancy(p, 1, w)
        elif fv == 2:
            p = _fancy(p, 0, h)
        chroma.append(p.long())
    cb, cr = chroma
    cr_r, cb_b, cr_g, cb_g = _ycc_tables(y.device)
    yy = y.to(torch.int32)
    r = yy + cr_r[cr]
    g = yy + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = yy + cb_b[cb]
    return torch.stack((r, g, b), dim=-1).clamp_(0, 255).to(torch.uint8)


class NvJpegDecoder:
    """JPEG streams -> RGB uint8 numpy arrays, decoded by nvJPEG on
    ``device`` (a CUDA ``torch.device``). Thread-safe: each thread gets its
    own decoder state and stream. :attr:`decoded` counts the decodes."""

    def __init__(self, device):
        import torch

        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"NvJpegDecoder needs a CUDA device, got {self.device}")
        self._lib = load_library()
        self._handle = ctypes.c_void_p()
        try:
            with torch.cuda.device(self.device):
                torch.cuda.init()
                _check(self._lib.nvjpegCreateSimple(ctypes.byref(self._handle)),
                       "nvjpegCreateSimple")
        except (RuntimeError, AssertionError) as e:
            raise DecoderUnavailable(f"libnvjpeg: no decoder on {self.device} ({e})") from e
        self._local = threading.local()
        self._states: List[ctypes.c_void_p] = []
        self._lock = threading.Lock()
        self.decoded = 0

    def _thread_state(self):
        local = self._local
        if getattr(local, "state", None) is None:
            import torch

            state = ctypes.c_void_p()
            _check(self._lib.nvjpegJpegStateCreate(self._handle, ctypes.byref(state)),
                   "nvjpegJpegStateCreate")
            with self._lock:
                self._states.append(state)
            local.state = state
            local.stream = torch.cuda.Stream(device=self.device)
        return local.state, local.stream

    def __call__(self, stream: bytes, photometric: int) -> np.ndarray:
        """One JPEG stream -> ``(h, w, 3)`` uint8 RGB on the host."""
        import torch

        if self._handle is None:
            raise RuntimeError("NvJpegDecoder: used after close()")
        if photometric not in (PHOTOMETRIC_RGB, PHOTOMETRIC_YCBCR):
            raise ValueError(f"JPEG tile with Photometric {photometric}; only RGB (2) and YCbCr "
                             "(6) are read")
        state, cuda_stream = self._thread_state()
        n, css = ctypes.c_int(), ctypes.c_int()
        widths, heights = (ctypes.c_int * 4)(), (ctypes.c_int * 4)()
        _check(self._lib.nvjpegGetImageInfo(self._handle, stream, len(stream), ctypes.byref(n),
                                            ctypes.byref(css), ctypes.byref(widths),
                                            ctypes.byref(heights)), "nvjpegGetImageInfo")
        if n.value != 3:
            raise ValueError(f"JPEG tile with {n.value} components; only 3 are read")
        if photometric == PHOTOMETRIC_RGB and css.value != CSS_444:
            raise ValueError("JPEG tile with Photometric RGB and subsampled components "
                             f"(nvjpegChromaSubsampling_t {css.value}) is not read")
        img = _Image()
        with torch.cuda.device(self.device), torch.cuda.stream(cuda_stream):
            planes = [torch.empty((heights[c], widths[c]), dtype=torch.uint8, device=self.device)
                      for c in range(3)]
            for c, plane in enumerate(planes):
                img.channel[c] = plane.data_ptr()
                img.pitch[c] = plane.shape[1]
            # the raw components (R, G, B, or Y, Cb, Cr at their own sizes)
            fmt = NVJPEG_OUTPUT_UNCHANGED if photometric == PHOTOMETRIC_RGB else NVJPEG_OUTPUT_YUV
            _check(self._lib.nvjpegDecode(self._handle, state, stream, len(stream), fmt,
                                          ctypes.byref(img),
                                          ctypes.c_void_p(cuda_stream.cuda_stream)),
                   "nvjpegDecode")
            rgb = (torch.stack(planes, dim=-1) if photometric == PHOTOMETRIC_RGB
                   else ycc_to_rgb(*planes))
            host = rgb.cpu().numpy()  # waits for this thread's stream only
        with self._lock:
            self.decoded += 1
        return host

    def close(self) -> None:
        """Destroy every thread's state, then the handle."""
        if self._handle is None:
            return
        import torch

        torch.cuda.synchronize(self.device)
        with self._lock:
            for state in self._states:
                self._lib.nvjpegJpegStateDestroy(state)
            self._states.clear()
        self._lib.nvjpegDestroy(self._handle)
        self._handle = None


def decode_pil(stream: bytes, photometric: int) -> np.ndarray:
    """The CPU's decode of one JPEG stream by PIL (libjpeg), told the colour
    space by ``photometric`` as libtiff tells it: raw components for RGB,
    YCbCr converted to RGB."""
    try:
        from PIL import Image
    except ImportError as e:
        raise DecoderUnavailable("JPEG tiles on the CPU are decoded by PIL, which cannot be "
                                 f"imported here ({e}); decode them on the card (--device N)"
                                 ) from e
    if photometric not in (PHOTOMETRIC_RGB, PHOTOMETRIC_YCBCR):
        raise ValueError(f"JPEG tile with Photometric {photometric}; only RGB (2) and YCbCr "
                         "(6) are read")
    im = Image.open(io.BytesIO(stream))
    if im.mode != "RGB":
        raise ValueError(f"JPEG tile of mode {im.mode}; only 3 components are read")
    jpegmode = "RGB" if photometric == PHOTOMETRIC_RGB else "YCbCr"
    im.tile = [t._replace(args=("RGB", jpegmode)) for t in im.tile]  # (rawmode, file's space)
    return np.asarray(im)


def jpeg_decoder(device):
    """The JPEG decoder for ``device``: PIL's for the CPU, else an
    :class:`NvJpegDecoder` (which raises where nvJPEG cannot run)."""
    import torch

    device = torch.device(device)
    if device.type == "cpu":
        return decode_pil
    return NvJpegDecoder(device)
