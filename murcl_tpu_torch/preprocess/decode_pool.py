"""Process-based patch decode pool for feature extraction (counterpart of
``murcl_tpu/preprocess/decode_pool.py``).

The thread producer of :mod:`murcl_tpu_torch.preprocess.extract` overlaps
decoding with the device's encoding, but slide reads and resizes hold the
interpreter lock part of the time, so threads stop scaling before the
cores do. This pool scales with processes: a persistent spawn-context
``ProcessPoolExecutor`` (forking a process that holds a CUDA context is
unsafe) whose workers write decoded patches straight into a
``SharedMemory`` block, so pixels cross the process boundary once; tasks
are row ranges of one slide's coord list, and each worker keeps its opened
slides by path. A worker imports the slide reader and the resize and
nothing that initialises CUDA, so it decodes every tile on the host: a
slide whose tiles are JPEG, read for a CUDA device, is refused by name
(its tiles are the card's to decode, by the threaded read); read for the
CPU, its workers decode JPEG with PIL.
"""

from __future__ import annotations

from multiprocessing import get_context
from multiprocessing.shared_memory import SharedMemory
from typing import List, Optional

import numpy as np

# per-worker-process slide-handle cache (path -> slide)
_SLIDES: dict = {}


def _get_slide(path: str):
    slide = _SLIDES.get(path)
    if slide is None:
        from murcl_tpu_torch.preprocess.slide_io import open_slide

        slide = open_slide(path)
        _SLIDES[path] = slide
    return slide


def _decode_chunk(task) -> int:
    from murcl_tpu_torch.preprocess.resample import resize_u8
    from murcl_tpu_torch.preprocess.slide_io import read_patch

    (path, shm_name, shape, lo, coords, patch_size_level0, patch_size,
     resize_on_host) = task
    shm = SharedMemory(name=shm_name)
    try:
        out = np.ndarray(shape, dtype=np.uint8, buffer=shm.buf)
        slide = _get_slide(path)
        for j, c in enumerate(coords):
            img = read_patch(slide, (c["x"], c["y"]), (patch_size_level0, patch_size_level0))
            if resize_on_host and patch_size_level0 != patch_size:
                img = resize_u8(img, (patch_size, patch_size))
            out[lo + j] = img
    finally:
        shm.close()
    return len(coords)


def _jpeg_tiled(path: str) -> bool:
    """Whether the port's TIFF reader would meet JPEG tiles in ``path``."""
    from murcl_tpu_torch.preprocess.slide_io import TIFF_SUFFIXES
    from murcl_tpu_torch.preprocess.tiff import TiffFile

    if not path.lower().endswith(TIFF_SUFFIXES):
        return False
    tf = TiffFile(path)
    try:
        return any(page.compression == 7 for page in tf.levels)
    finally:
        tf.close()


class ProcessDecodePool:
    """Persistent spawn-context decode pool writing into shared memory."""

    def __init__(self, num_workers: int, chunks_per_worker: int = 4):
        from concurrent.futures import ProcessPoolExecutor

        self.num_workers = max(1, num_workers)
        self._chunks_per_worker = chunks_per_worker
        self._pool = ProcessPoolExecutor(self.num_workers, mp_context=get_context("spawn"))

    def read_patches(self, slide_path: str, coords: List[dict],
                     patch_size_level0: int, patch_size: int,
                     resize_on_host: bool = True, device="cpu") -> np.ndarray:
        """Decode one slide's patch regions into ``(N, S, S, 3) uint8``;
        refuse a JPEG-tiled slide read for a CUDA ``device``."""
        if str(device) != "cpu" and _jpeg_tiled(slide_path):
            raise ValueError(f"{slide_path}: JPEG tiles are decoded on the card, which the "
                             "process decode pool's workers do not open; use --decode_pool "
                             "thread (the default), or --device cpu")
        n = len(coords)
        out_size = patch_size if resize_on_host else patch_size_level0
        shape = (n, out_size, out_size, 3)
        shm = SharedMemory(create=True, size=max(int(np.prod(shape)), 1))
        try:
            chunk = max(1, -(-n // (self.num_workers * self._chunks_per_worker)))
            tasks = [(slide_path, shm.name, shape, lo, coords[lo:lo + chunk],
                      patch_size_level0, patch_size, resize_on_host)
                     for lo in range(0, n, chunk)]
            list(self._pool.map(_decode_chunk, tasks))  # raises a worker's exception here
            return np.ndarray(shape, np.uint8, buffer=shm.buf).copy()
        finally:
            shm.close()
            shm.unlink()

    def close(self) -> None:
        self._pool.shutdown()

    def __enter__(self) -> "ProcessDecodePool":
        return self

    def __exit__(self, *exc) -> Optional[bool]:
        self.close()
        return None
