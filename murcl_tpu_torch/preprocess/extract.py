"""Batched patch-feature extraction (counterpart of
``murcl_tpu/preprocess/extract.py``; reference
``wsi_processing/extract_features.py:47-102``, one patch per forward).

A producer thread reads a slide's patches, up to ``READ_CHUNK`` at a time
(threaded crops into a pinned host buffer, the slide's JPEG tiles decoded
on the encoder's device, or a
:class:`~murcl_tpu_torch.preprocess.decode_pool.ProcessDecodePool`) while
the device encodes the previous chunk; a queue of depth 2 holds the chunks
between them. :class:`PatchEncoder` queues every fixed-size batch (host to
device copy, the resize, ``/255``, optional ImageNet normalisation, the
encoder) before it reads any back.

The resize is PIL's bicubic, bit for bit: on the card the host threads
only crop at level 0 and :func:`resize_u8_torch` resizes each batch there;
on the CPU the threads resize with :func:`resize_u8`. ``--resize_on_device``
asks instead for the JAX package's bilinear device resize. Preprocessing is the reference's:
``ToTensor`` scaling only, no ImageNet normalisation unless
``imagenet_norm``.

"f32" is full f32: the encoder runs with cuDNN's and cuBLAS's TF32 off, as
the JAX package's f32 is. ``dtype="bfloat16"`` runs the encoder's weights
and activations in bf16.

Weights: ``--weights`` (a pickle of the JAX package's flax tree, written by
``python -m murcl_tpu_torch.scripts.export_torchvision_weights`` from
torchvision, or with torch alone from a downloaded ``.pth``),
else torchvision's ImageNet weights where it imports, else a random
initialisation with a loud warning (``extract.py:69-81``).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from murcl_tpu_torch.data.contract import save_features_npz
from murcl_tpu_torch.preprocess.resample import resize_u8, resize_u8_torch
from murcl_tpu_torch.preprocess.resnet import (create_encoder, load_params_npz,
                                              load_torchvision_weights, state_dict_from_jax)
from murcl_tpu_torch.preprocess.slide_io import open_slide, read_patch
from murcl_tpu_torch.utils.general import load_json

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
READ_CHUNK = 1024  # patches per host buffer (about 800 MB of 512-pixel crops)


@contextlib.contextmanager
def full_f32():
    """cuDNN's and cuBLAS's TF32 off for the scope, restored after."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


class PatchEncoder:
    """Batched image encoder with a fixed batch shape, on ``device`` (the
    card ``cuda:0`` by default, ``"cpu"`` for the CPU path; resolved as the
    drivers' ``--device`` is)."""

    def __init__(self, image_encoder: str = "resnet18", batch_size: int = 256,
                 patch_size: int = 256, weights: Optional[str] = None,
                 imagenet_norm: bool = False, dtype: str = "float32",
                 resize_on_device: bool = False, device="cuda:0"):
        from murcl_tpu_torch.drivers.murcl import resolve_device

        self.device = resolve_device(device)
        self.batch_size = batch_size
        self.patch_size = patch_size
        self.imagenet_norm = imagenet_norm
        self.resize_on_device = resize_on_device
        self.dtype = torch.bfloat16 if dtype == "bfloat16" else torch.float32
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the random encoder is the same in every run
            self.model, self.feature_dim = create_encoder(image_encoder)
        if weights is not None:
            state = state_dict_from_jax(load_params_npz(weights), image_encoder)
        else:
            try:
                state = load_torchvision_weights(image_encoder)
            except Exception as e:
                state = None
                print(f"WARNING: pretrained {image_encoder} weights unavailable "
                      f"({type(e).__name__}: {e}); using random init. "
                      f"Pass --weights <params.pkl> for ImageNet features.")
        if state is not None:
            self.model.load_state_dict(state)
        self.model.to(device=self.device, dtype=self.dtype,
                      memory_format=torch.channels_last).eval()
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device).view(1, 3, 1, 1)
        self._std = torch.tensor(IMAGENET_STD, device=self.device).view(1, 3, 1, 1)

    def _encode(self, batch_u8: torch.Tensor) -> torch.Tensor:
        """``(B, H, W, 3)`` uint8 on the device -> ``(B, feature_dim)`` f32."""
        if batch_u8.shape[1] != self.patch_size and not self.resize_on_device:
            batch_u8 = resize_u8_torch(batch_u8, (self.patch_size, self.patch_size))
        x = batch_u8.permute(0, 3, 1, 2).to(self.dtype)  # NCHW over NHWC memory, no copy
        if self.resize_on_device and x.shape[2] != self.patch_size:
            # host threads then only crop; the bilinear (antialiased) downscale
            # runs here, as jax.image.resize(..., "bilinear") in the JAX package
            x = F.interpolate(x, size=(self.patch_size, self.patch_size), mode="bilinear",
                              antialias=True, align_corners=False)
        x = x / 255.0  # ToTensor
        if self.imagenet_norm:
            x = (x - self._mean.to(x.dtype)) / self._std.to(x.dtype)
        return self.model(x).float()

    @torch.no_grad()
    def encode_patches(self, patches_u8) -> np.ndarray:
        """``(N, H, W, 3)`` uint8 (numpy, or a pinned CPU tensor) -> ``(N,
        feature_dim)`` f32. The last batch is padded to the batch size; every
        batch is queued before the features are read back."""
        src = torch.as_tensor(patches_u8)
        n, bs = src.shape[0], self.batch_size
        out = torch.empty((-(-n // bs) * bs, self.feature_dim), device=self.device)
        with full_f32():
            for start in range(0, n, bs):
                chunk = src[start:start + bs].to(self.device, non_blocking=True)
                if chunk.shape[0] < bs:
                    pad = chunk.new_zeros((bs - chunk.shape[0],) + tuple(chunk.shape[1:]))
                    chunk = torch.cat([chunk, pad])
                out[start:start + bs] = self._encode(chunk)
        return out[:n].cpu().numpy()


def _read_patches(slide, coords: List[dict], patch_size_level0: int, patch_size: int,
                  num_workers: int = 8, resize_on_host: bool = True,
                  pin_memory: bool = False) -> torch.Tensor:
    """One slide's patch regions as ``(N, S, S, 3)`` uint8, read by
    ``num_workers`` threads into one (optionally pinned) host tensor; with
    ``resize_on_host=False`` at level-0 size, for the device to resize."""
    n = len(coords)
    size = patch_size if resize_on_host else patch_size_level0
    out = torch.empty((n, size, size, 3), dtype=torch.uint8, pin_memory=pin_memory)
    view = out.numpy()

    def work(i):
        c = coords[i]
        img = read_patch(slide, (c["x"], c["y"]), (patch_size_level0, patch_size_level0))
        view[i] = resize_u8(img, (patch_size, patch_size)) if size != patch_size_level0 else img

    if num_workers <= 1 or n < 4:
        for i in range(n):
            work(i)
    else:
        with ThreadPoolExecutor(num_workers) as pool:
            list(pool.map(work, range(n)))
    return out


def extract_features(patch_dir, save_dir, image_encoder: str = "resnet18",
                     batch_size: int = 256, num_workers: int = 8,
                     weights: Optional[str] = None, exist_ok: bool = False,
                     imagenet_norm: bool = False, resize_on_device: bool = False,
                     decode_pool: str = "thread", device="cuda:0") -> List[dict]:
    """Every coord json under ``patch_dir/coord`` -> one feature npz per slide
    in ``save_dir``, skipping existing npz files (``extract_features.py:61-63``)
    and slides without patches. Returns, per slide written, ``{case_id,
    num_patches, read_ms, encode_ms}``: the producer's host time to read the
    slide's patches and the consumer's time to encode them (read back
    included), summed over its chunks. ``resize_on_device`` resizes to the
    coord jsons' patch size (the JAX package's encoder resizes to 256
    whatever the tiling's size)."""
    patch_dir, save_dir = Path(patch_dir), Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    todo = []
    for cp in sorted((patch_dir / "coord").glob("*.json")):
        if (save_dir / f"{cp.stem}.npz").exists() and not exist_ok:
            print(f"{cp.stem} skipped: npz exists")
            continue
        todo.append(cp)
    if not todo:
        return []

    encoder = PatchEncoder(image_encoder, batch_size=batch_size,
                           patch_size=load_json(todo[0])["patch_size"], weights=weights,
                           imagenet_norm=imagenet_norm, resize_on_device=resize_on_device,
                           device=device)
    pin = encoder.device.type == "cuda"
    # the host resizes only for an encoder on the CPU; the card resizes its own
    resize_on_host = not pin and not resize_on_device
    chunk = batch_size * max(1, READ_CHUNK // batch_size)
    q: "queue.Queue" = queue.Queue(maxsize=2)
    pool = None
    if decode_pool == "process":
        from murcl_tpu_torch.preprocess.decode_pool import ProcessDecodePool

        pool = ProcessDecodePool(num_workers)

    def producer():
        try:
            for cp in todo:
                coord = load_json(cp)
                if coord["num_patches"] == 0:  # extract_features.py:69-71
                    print(f"{cp.stem}'s num_patches is 0, skip!")
                    continue
                slide = None
                if pool is None:
                    slide = open_slide(coord["slide_filepath"], device=encoder.device)
                try:
                    cs = coord["coords"]
                    for lo in range(0, len(cs), chunk):
                        t0 = time.perf_counter()
                        if slide is None:
                            patches = pool.read_patches(
                                coord["slide_filepath"], cs[lo:lo + chunk],
                                coord["patch_size_level0"], coord["patch_size"],
                                resize_on_host=resize_on_host, device=encoder.device)
                        else:
                            patches = _read_patches(
                                slide, cs[lo:lo + chunk], coord["patch_size_level0"],
                                coord["patch_size"], num_workers,
                                resize_on_host=resize_on_host, pin_memory=pin)
                        q.put((cp.stem, coord, patches, 1e3 * (time.perf_counter() - t0),
                               lo + chunk >= len(cs)))
                finally:
                    if slide is not None:
                        slide.close()
        except Exception as e:  # handed to the consumer, which raises it
            q.put(e)
        q.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    records, total, t_start = [], 0, time.perf_counter()
    parts, read_ms, encode_ms = [], 0.0, 0.0
    try:
        while (item := q.get()) is not None:
            if isinstance(item, Exception):
                raise item
            stem, coord, patches, chunk_read_ms, last = item
            t0 = time.perf_counter()
            parts.append(encoder.encode_patches(patches))
            encode_ms += 1e3 * (time.perf_counter() - t0)
            read_ms += chunk_read_ms
            if not last:
                continue
            feats = np.concatenate(parts)
            coords_rc = np.asarray([[c["row"], c["col"]] for c in coord["coords"]],
                                   dtype=np.int64)
            save_features_npz(save_dir / f"{stem}.npz", filename=stem,
                              num_row=coord["num_row"], num_col=coord["num_col"],
                              img_features=feats, coords=coords_rc)
            total += feats.shape[0]
            print(f"{stem}: {feats.shape[0]} patches -> {tuple(feats.shape)} "
                  f"({total / (time.perf_counter() - t_start):.1f} patches/sec cumulative)")
            records.append({"case_id": stem, "num_patches": int(feats.shape[0]),
                            "read_ms": read_ms, "encode_ms": encode_ms})
            parts, read_ms, encode_ms = [], 0.0, 0.0
    finally:
        while thread.is_alive():  # a consumer that failed drains the producer
            with contextlib.suppress(queue.Empty):
                q.get(timeout=0.1)
        thread.join()
        if pool is not None:
            pool.close()
    return records
