"""Streaming feature feed (counterpart of ``murcl_tpu/data/streaming.py``).

The resident :class:`~murcl_tpu_torch.data.bank.FeatureBank` keeps a whole
split's patch features on the device: about 2 GB at Camelyon16's scale, tens
of GB for 10,000+ TCGA slides of up to 10,240 patches. :class:`StreamingBank`
keeps the split on the host and stages each batch's slides as a mini-bank:
a ``FeatureBank`` on the device that the engines take as they take the
resident one (they read ``feats``, ``offsets``, ``num_patches``,
``cluster_sizes``, ``patch_cluster``, ``patch_pos`` and ``labels``), plus the
batch's ``slide_ids`` into it.

- A metadata pass reads the cluster tables and the feature files' npy
  headers; features are read per batch and never cached (the OS page cache
  serves re-reads).
- Each distinct slide of a batch is staged once, back to back as the
  resident bank packs them (the compaction kernel needs neither the TPU
  kernel's 8-row alignment nor its power-of-two row bucket); ``slide_ids``
  map repeats onto it. The sub-bags are then bitwise those of the resident
  bank.
- On a CUDA device, ``READ_THREADS`` threads read the feature rows (f32,
  the files' own) straight from the (uncompressed) npz members into a
  pinned buffer, refilled only after its last copy has finished; the copy
  to the card and the cast to ``dtype`` run ``non_blocking`` on a side
  stream, and the consumer's stream waits on its event, so no batch
  synchronises the host. :meth:`iter_epoch` stages the next batch on a
  one-deep prefetch thread while the card computes on the current one,
  into two pinned buffers in turn, and re-raises the thread's errors in the
  caller; :meth:`stage` (the drivers' whole-split evaluation) uses one, so
  repeated evaluations of a split hold one split-sized pinned buffer.
- On the CPU (``device="cpu"``, which the tests ask for) the rows are
  copied synchronously.

A gather and a cast commute, so casting on the card gives the resident
bank's bits. On the H100's 8-core host, f32 rows on 4 readers gave the
fastest MuRCL step at TCGA's slide sizes: a cast to bf16 on the host costs
more than the halved copy saves, and more readers slow the thread that
launches the step (``PERF.md``).
"""

from __future__ import annotations

import collections
import queue
import struct
import threading
import time
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from murcl_tpu_torch.data import contract
from murcl_tpu_torch.data.bank import FeatureBank, _patch_cluster_pos

FEATURES_MEMBER = "img_features.npy"
READ_THREADS = 4


def npy_member_span(path) -> Tuple[Optional[int], tuple, np.dtype]:
    """``(offset, shape, dtype)`` of the features array in a feature npz:
    ``offset`` is where its bytes start in the file when the member is
    stored uncompressed in C order, else ``None``."""
    with zipfile.ZipFile(path) as z:
        info = z.getinfo(FEATURES_MEMBER)
        with z.open(info) as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            else:
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            header = f.tell()
    if info.compress_type != zipfile.ZIP_STORED or fortran:
        return None, shape, dtype
    with open(path, "rb") as fp:
        fp.seek(info.header_offset)
        local = fp.read(30)
    name_len, extra_len = struct.unpack("<HH", local[26:30])
    return info.header_offset + 30 + name_len + extra_len + header, shape, dtype


def _distinct(ids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """``(distinct ids in first-occurrence order, each id's index into them)``."""
    uniq, first, inverse = np.unique(ids, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    where = np.empty_like(order)
    where[order] = np.arange(order.size)
    return uniq[order], where[inverse.reshape(-1)]


class _Failure:
    def __init__(self, error: BaseException):
        self.error = error


_END = object()


def _put(q: "queue.Queue", item, stop: threading.Event) -> bool:
    while not stop.is_set():
        try:
            q.put(item, timeout=0.1)
            return True
        except queue.Full:
            continue
    return False


class StreamingBank:
    """A split on the host, staged batch by batch onto ``device``.

    ``stage(ids)`` returns ``(FeatureBank, slide_ids)`` ready for an engine
    step on the caller's current stream; ``iter_epoch(batches)`` yields the
    same for each batch, staged one ahead on a thread. ``max_patches`` (the
    width of the staged patch tables, at least the largest slide's patch
    count) may be raised to share one width across splits. ``stage_log`` is
    the feed's instrument: per staged batch the host's assembly time
    (``host_ms``), the bytes it copies and, on the card, the copy's start
    and end events (the streaming phase of ``chip_smoke.py`` reads them).
    """

    def __init__(self, data_csv, indices: Optional[Sequence[str]] = None, device="cpu",
                 dtype: Optional[torch.dtype] = None, max_patches: Optional[int] = None):
        num_clusters = contract.num_clusters_from_csv(data_csv)
        rows = contract.load_manifest(data_csv, indices)
        if not rows:
            raise ValueError(f"empty manifest selection for {data_csv}")
        self.device = torch.device(device)
        self.dtype = dtype or torch.float32
        self.num_clusters = num_clusters
        self.case_ids: List[str] = [str(r["case_id"]) for r in rows]
        self.labels = np.asarray([int(r["label"]) for r in rows], dtype=np.int64)
        self._paths = [str(r["features_filepath"]) for r in rows]

        # metadata pass: cluster tables and the npy headers, no features
        self._offsets, counts, tables, dims = [], [], [], set()
        for row in rows:
            offset, shape, dtype_ = npy_member_span(row["features_filepath"])
            if len(shape) != 2:
                raise ValueError(f"{row['case_id']}: features of shape {shape}, expected (N, D)")
            self._offsets.append(offset if dtype_ == np.float32 else None)
            counts.append(int(shape[0]))
            dims.add(int(shape[1]))
            clusters = contract.load_cluster_json(row["clusters_json_filepath"])
            if len(clusters) != num_clusters:
                raise ValueError(f"{row['case_id']}: cluster json has {len(clusters)} "
                                 f"clusters, expected {num_clusters}")
            tables.append(clusters)
        if len(dims) != 1:
            raise ValueError(f"feature widths differ across slides: {sorted(dims)}")
        self.patch_dim = dims.pop()
        self.num_patches = np.asarray(counts, dtype=np.int64)
        self._largest = int(self.num_patches.max())
        self.max_patches = max(int(max_patches or 0), self._largest)
        s = len(rows)
        self.cluster_sizes = np.zeros((s, num_clusters), dtype=np.int64)
        self.patch_cluster = np.zeros((s, self._largest), dtype=np.int32)
        self.patch_pos = np.full((s, self._largest), -1, dtype=np.int32)
        for i, clusters in enumerate(tables):
            self.cluster_sizes[i] = [len(c) for c in clusters]
            self.patch_cluster[i], self.patch_pos[i] = _patch_cluster_pos(clusters,
                                                                          self._largest)

        self._pool = ThreadPoolExecutor(max_workers=READ_THREADS,
                                        thread_name_prefix="stream-read")
        self.stage_log = collections.deque(maxlen=256)  # one record per staged batch
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            self._buffers: list = [None, None]
            self._copied: list = [None, None]

    @property
    def num_slides(self) -> int:
        return len(self.case_ids)

    def _read(self, i: int, out: torch.Tensor) -> None:
        """Slide ``i``'s feature rows into ``out`` (an f32 host tensor view)."""
        offset = self._offsets[i]
        if offset is None:
            out.copy_(torch.from_numpy(contract.load_features_npz(self._paths[i])))
            return
        view = memoryview(out.numpy()).cast("B")
        with open(self._paths[i], "rb", buffering=0) as fp:
            fp.seek(offset)
            done = 0
            while done < len(view):
                n = fp.readinto(view[done:])
                if not n:
                    raise EOFError(f"{self._paths[i]}: features end early")
                done += n

    def _fill(self, rows: torch.Tensor, uniq: np.ndarray, offsets: np.ndarray) -> None:
        spans = [(int(i), rows[o:o + n]) for i, o, n in
                 zip(uniq, offsets, self.num_patches[uniq])]
        list(self._pool.map(lambda span: self._read(*span), spans))

    def _host_meta(self, uniq: np.ndarray, offsets: np.ndarray) -> dict:
        n = uniq.size
        pcid = np.zeros((n, self.max_patches), dtype=np.int64)
        ppos = np.full((n, self.max_patches), -1, dtype=np.int64)
        pcid[:, :self._largest] = self.patch_cluster[uniq]
        ppos[:, :self._largest] = self.patch_pos[uniq]
        return {"offsets": torch.from_numpy(offsets),
                "num_patches": torch.from_numpy(self.num_patches[uniq]),
                "cluster_sizes": torch.from_numpy(self.cluster_sizes[uniq]),
                "patch_cluster": torch.from_numpy(pcid), "patch_pos": torch.from_numpy(ppos),
                "labels": torch.from_numpy(self.labels[uniq])}

    def _pinned(self, k: int, rows: int) -> torch.Tensor:
        """Pinned buffer ``k`` of at least ``rows`` rows, once its last copy
        has finished."""
        if self._copied[k] is not None:
            self._copied[k].synchronize()
        buf = self._buffers[k]
        if buf is None or buf.shape[0] < rows:
            grow = rows if buf is None else max(rows, buf.shape[0] * 5 // 4)
            buf = self._buffers[k] = torch.empty((grow, self.patch_dim), dtype=torch.float32,
                                                 pin_memory=True)
        return buf

    def _stage(self, ids, k: int = 0) -> tuple:
        """Assemble batch ``ids`` in pinned buffer ``k`` and start copying it:
        ``(bank, slide_ids, ready)``, ``ready`` the side stream's event
        (``None`` on the CPU)."""
        if self.max_patches < self._largest:
            raise ValueError(f"max_patches {self.max_patches} < the largest slide's "
                             f"{self._largest} patches")
        t0 = time.perf_counter()
        uniq, slide_ids = _distinct(np.asarray(ids, dtype=np.int64).reshape(-1))
        counts = self.num_patches[uniq]
        offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
        total = int(counts.sum())
        meta = self._host_meta(uniq, offsets)
        cuda = self.device.type == "cuda"
        if cuda:
            rows = self._pinned(k, total)
        else:
            rows = torch.empty((total, self.patch_dim), dtype=torch.float32)
        self._fill(rows, uniq, offsets)
        record = {"host_ms": (time.perf_counter() - t0) * 1e3,
                  "bytes": sum(t.numel() * t.element_size() for t in meta.values())
                  + total * self.patch_dim * 4}
        sid, ready = torch.from_numpy(slide_ids), None
        if cuda:
            start, ready = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            with torch.cuda.stream(self._side):
                start.record()
                feats = torch.empty((total, self.patch_dim), dtype=torch.float32,
                                    device=self.device)
                feats.copy_(rows[:total], non_blocking=True)
                meta = {name: t.pin_memory().to(self.device, non_blocking=True)
                        for name, t in meta.items()}
                sid = sid.pin_memory().to(self.device, non_blocking=True)
                feats = feats.to(self.dtype)
                ready.record()
            self._copied[k] = ready
            record["events"] = (start, ready)
        else:
            feats = rows.to(self.dtype)
        self.stage_log.append(record)
        bank = FeatureBank(feats=feats, **meta, case_ids=[self.case_ids[i] for i in uniq],
                           num_clusters=self.num_clusters, max_patches=self.max_patches)
        return bank, sid, ready

    def _ready(self, staged: tuple) -> Tuple[FeatureBank, torch.Tensor]:
        """Make the caller's stream wait for the batch's copies; its tensors,
        allocated on the side stream, are then in use on the caller's."""
        bank, slide_ids, ready = staged
        if ready is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(ready)
            for t in (bank.feats, bank.offsets, bank.num_patches, bank.cluster_sizes,
                      bank.patch_cluster, bank.patch_pos, bank.labels, slide_ids):
                t.record_stream(current)
        return bank, slide_ids

    def stage(self, ids) -> Tuple[FeatureBank, torch.Tensor]:
        """One batch as ``(mini-bank, slide_ids)`` on the device."""
        return self._ready(self._stage(ids))

    def iter_epoch(self, batches: Sequence) -> Iterator[Tuple[FeatureBank, torch.Tensor]]:
        """Yield :meth:`stage` of each batch in order, the next one staged on
        a background thread (in the other pinned buffer) while the caller
        computes on the current one."""
        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def producer():
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                for n, ids in enumerate(batches):
                    if not _put(q, self._stage(ids, n % 2), stop):
                        return
                item = _END
            except BaseException as e:  # handed to the caller, which re-raises it
                item = _Failure(e)
            _put(q, item, stop)

        thread = threading.Thread(target=producer, name="stream-prefetch", daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    return
                if isinstance(item, _Failure):
                    raise item.error
                yield self._ready(item)
        finally:
            stop.set()
            thread.join()
