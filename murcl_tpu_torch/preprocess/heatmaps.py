"""Full-slide attention heatmaps over slide thumbnails (counterpart of
``murcl_tpu/preprocess/heatmaps.py``; reference ``scripts/create_heatmaps.py``).

Per slide: CLAM_SB (gated, with a fresh ``classifiers`` head) scores the
whole, unsampled bag in eval mode (:class:`AttentionScorer`); the raw scores
are min-max scaled to uint8, coloured with JET, painted patch by patch onto
the thumbnail, blended 50/50 with it and written as PNG. A bag of more than
3,072 padded patches at dim 512 is not resident by the JAX package's rule,
so its trunk is a plain product and its pool streams through K8; smaller
slides take the fused K2 (see ``murcl_tpu_torch/models/clam.py``).

The painting is numpy and equals OpenCV's bitwise: :data:`JET` is
``cv2.COLORMAP_JET``, rectangles are filled with inclusive corners and
clipped to the image, and the blend rounds half to even as
``cv2.addWeighted`` does. ROI contours (``cv2.drawContours`` at thickness
5) are :func:`murcl_tpu_torch.preprocess.cvcompat.polylines`, which differs
from OpenCV's on a few pixels of slanted segments.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional
from xml.dom import minidom

import numpy as np
import torch

from murcl_tpu_torch.preprocess import cvcompat
from murcl_tpu_torch.preprocess.slide_io import as_rgb, get_three_points, open_slide
from murcl_tpu_torch.utils.general import load_json
from murcl_tpu_torch.utils.png import write_png

# cv2.COLORMAP_JET as (level, value) knots per BGR channel; it is linear
# between them in steps of 4
_JET_KNOTS = (
    ([0, 31, 32, 95, 96, 158, 159, 160, 255], [128, 252, 255, 255, 254, 6, 1, 0, 0]),
    ([0, 32, 95, 96, 159, 160, 223, 255], [0, 0, 252, 255, 255, 252, 0, 0]),
    ([0, 95, 96, 159, 160, 223, 224, 255], [0, 0, 2, 254, 255, 255, 252, 128]),
)
JET = np.stack([np.interp(np.arange(256), k, v) for k, v in _JET_KNOTS],
               axis=1).astype(np.uint8)  # (256, 3) BGR


def load_annotations_xml(annotations_xml) -> List[np.ndarray]:
    """Camelyon16 ROI polygons -> list of (N, 1, 2) float contours."""
    dom = minidom.parse(str(annotations_xml))
    contours = []
    for a in dom.documentElement.getElementsByTagName("Annotation"):
        coords = a.getElementsByTagName("Coordinates")[0].getElementsByTagName("Coordinate")
        contour = np.array([[c.getAttribute("X"), c.getAttribute("Y")] for c in coords],
                           dtype=np.float64)
        contours.append(contour[:, None, :])
    return contours


def blend(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``cv2.addWeighted(a, 0.5, b, 0.5, 0)`` on uint8: f32, half to even."""
    return np.rint(a.astype(np.float32) * np.float32(0.5)
                   + b.astype(np.float32) * np.float32(0.5)).astype(np.uint8)


def create_heatmap(coord_filepath, attention, slide_level: int = -1,
                   contours: Optional[list] = None, device="cpu") -> np.ndarray:
    """Paint per-patch attention onto the slide thumbnail, with the ROI
    ``contours`` (level-0 polygons) outlined in yellow; returns BGR uint8.
    ``device`` decodes the slide's JPEG tiles (``open_slide``)."""
    coord_dict = load_json(coord_filepath)
    coords = coord_dict["coords"]
    num_patches = coord_dict["num_patches"]
    slide = open_slide(coord_dict["slide_filepath"], device=device)
    try:
        thumbnail = np.ascontiguousarray(
            as_rgb(slide.get_thumbnail(slide.level_dimensions[slide_level]))[..., ::-1])
        level_downsample = slide.level_downsamples[slide_level]
    finally:
        slide.close()
    size = coord_dict["patch_size_level0"] / level_downsample
    assert num_patches == len(coords) == len(attention), \
        f"{num_patches}-{len(coords)}-{len(attention)}"

    attention = np.asarray(attention, dtype=np.float64)
    rng = np.max(attention) - np.min(attention)
    levels = np.uint8(255 * (attention - np.min(attention)) / (rng if rng else 1.0))
    colors = JET[levels]

    heatmap = np.full(thumbnail.shape, 255, dtype=np.uint8)
    for c, color in zip(coords, colors):  # in patch order: a later patch paints over
        (x0, y0), (x1, y1), _ = get_three_points(c["col"], c["row"], size)
        heatmap[y0:y1 + 1, x0:x1 + 1] = color
    heatmap = blend(heatmap, thumbnail)
    for contour in contours or ():
        cvcompat.polylines(heatmap, np.asarray(contour / level_downsample).astype(np.int32),
                           (0, 255, 255), thickness=5)
    return heatmap


class AttentionScorer:
    """CLAM_SB attention over full bags, padded to a multiple of ``bucket``
    with a mask, in f32 and eval mode on ``device``: the card ``cuda:0`` by
    default, ``"cpu"`` for the plain CPU path; resolved as the drivers'
    ``--device`` is, so without a CUDA device only ``"cpu"`` runs."""

    def __init__(self, dim_patch: int, num_classes: int, size_arg: str = "small",
                 k_sample: int = 8, checkpoint: Optional[str] = None, bucket: int = 512,
                 device="cuda:0"):
        from murcl_tpu_torch.drivers.murcl import resolve_device
        from murcl_tpu_torch.engine.checkpoint import load_checkpoint, transfer_state
        from murcl_tpu_torch.models.clam import CLAM_SB

        self.bucket = bucket
        self.device = resolve_device(device)
        self.model = CLAM_SB(in_dim=dim_patch, gate=True, size_arg=size_arg, dropout=0.25,
                             k_sample=k_sample, n_classes=num_classes, subtyping=True)
        if checkpoint is not None:
            # the aggregator's weights with a fresh classifier head
            # (create_heatmaps.py:58-59)
            fresh = {k: v.clone() for k, v in self.model.classifiers.state_dict().items()}
            transfer_state(self.model, load_checkpoint(checkpoint)["model_state_dict"])
            self.model.classifiers.load_state_dict(fresh)
        self.model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, feats: np.ndarray) -> np.ndarray:
        """``(N, D)`` full bag -> ``(N,)`` raw attention scores."""
        n = feats.shape[0]
        padded = -(-n // self.bucket) * self.bucket
        bag = torch.zeros((1, padded, feats.shape[1]), dtype=torch.float32, device=self.device)
        bag[0, :n] = torch.from_numpy(np.asarray(feats, dtype=np.float32)).to(self.device)
        mask = torch.zeros((1, padded), dtype=torch.bool, device=self.device)
        mask[0, :n] = True
        _, aux = self.model(bag, mask=mask)
        return aux["attention"][0, :n].cpu().numpy()


def run_heatmaps(args) -> List[dict]:
    """Batch CLI body (``create_heatmaps.py:135-179``). Returns, per slide
    written, ``{case_id, num_patches, path}`` and the host milliseconds of
    each phase (``load_ms``, ``score_ms``, ``paint_ms``, ``write_ms``)."""
    from murcl_tpu_torch.data.datasets import WSIDataset
    from murcl_tpu_torch.drivers.murcl import resolve_device

    device = resolve_device(args.device)
    dataset = WSIDataset(data_csv=args.data_csv, shuffle=False, preload=args.preload)
    scorer = AttentionScorer(dim_patch=dataset.patch_dim, num_classes=args.num_classes,
                             size_arg=args.size_arg, k_sample=args.k_sample,
                             checkpoint=args.checkpoint, bucket=args.bucket, device=device)
    save_dir = Path(args.save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)

    records = []
    for i in range(len(dataset)):
        t0 = time.perf_counter()
        feat, _label, case_id = dataset[i]
        out_path = save_dir / f"{case_id}.png"
        if out_path.exists() and not args.exist_ok:
            print(f"{case_id} skipped: heatmap exists")
            continue
        t1 = time.perf_counter()
        attention = scorer(feat)
        t2 = time.perf_counter()
        contours = None
        if args.annotation_dir is not None and args.draw_contours:
            xml = Path(args.annotation_dir) / f"{case_id}.xml"
            if xml.exists():
                contours = load_annotations_xml(xml)
        heatmap = create_heatmap(Path(args.coord_dir) / f"{case_id}.json", attention,
                                 slide_level=args.slide_level, contours=contours,
                                 device=device)
        t3 = time.perf_counter()
        write_png(out_path, heatmap)
        t4 = time.perf_counter()
        print(f"{case_id}: heatmap written ({len(attention)} patches)")
        records.append({"case_id": case_id, "num_patches": len(attention),
                        "path": str(out_path), "load_ms": 1e3 * (t1 - t0),
                        "score_ms": 1e3 * (t2 - t1), "paint_ms": 1e3 * (t3 - t2),
                        "write_ms": 1e3 * (t4 - t3)})
    return records
