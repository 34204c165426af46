"""WSI tiling: a tissue-masked grid walk that writes the coord json
(counterpart of ``murcl_tpu/preprocess/tiling.py``; reference
``wsi_processing/create_patches.py:15-125``).

Open the slide, take its level-0 magnification from ``aperio.AppMag`` /
``openslide.mpp-x`` (default 40x), set ``patch_size_level0 = patch_size *
mag0 / mag``, build a downsampled tissue mask with the chosen filter, keep
each grid cell whose tissue share is at least ``tissue_thresh`` and whose
patch lies inside the slide, and write the coord json, with an optional
overview PNG (red rectangles on the thumbnail), the mask PNG and patch PNGs.
The keep decision is one boolean array over the grid, as in the JAX
package. Host only: numpy, scipy and the torch resize, no ``cv2`` or PIL.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np

from murcl_tpu_torch.data.contract import save_coord_json
from murcl_tpu_torch.preprocess import cvcompat
from murcl_tpu_torch.preprocess import filters as _filters
from murcl_tpu_torch.preprocess.nvjpeg import DecoderUnavailable
from murcl_tpu_torch.preprocess.resample import resize_u8
from murcl_tpu_torch.preprocess.slide_io import as_rgb, get_three_points, open_slide, read_patch
from murcl_tpu_torch.utils.png import write_png


def infer_level0_magnification(slide) -> int:
    """``aperio.AppMag`` -> its value; else mpp-x ~0.25 -> 40x, ~0.5 -> 20x;
    else 40 (``create_patches.py:36-41``)."""
    props = slide.properties
    if "aperio.AppMag" in props:
        return int(float(props["aperio.AppMag"]))
    if "openslide.mpp-x" in props:
        return 40 if int(np.floor(float(props["openslide.mpp-x"]) * 10)) == 2 else 20
    return 40


def tiling(
    slide_filepath,
    magnification: int,
    patch_size: int,
    scale_factor: int = 32,
    tissue_thresh: float = 0.35,
    method: str = "rgb",
    overview_level: int = -1,
    coord_dir: Optional[Path] = None,
    overview_dir: Optional[Path] = None,
    mask_dir: Optional[Path] = None,
    patch_dir: Optional[Path] = None,
    filename: Optional[str] = None,
    device="cpu",
) -> Optional[dict]:
    """Tile one slide; write the coord json; return the coord dict.
    ``device`` decodes the slide's JPEG tiles (``open_slide``)."""
    slide = open_slide(str(slide_filepath), device=device)
    try:
        return _tile_slide(slide, slide_filepath, magnification, patch_size, scale_factor,
                           tissue_thresh, method, overview_level, coord_dir, overview_dir,
                           mask_dir, patch_dir, filename)
    finally:
        slide.close()


def _tile_slide(slide, slide_filepath, magnification, patch_size, scale_factor, tissue_thresh,
                method, overview_level, coord_dir, overview_dir, mask_dir, patch_dir,
                filename) -> Optional[dict]:
    mag0 = infer_level0_magnification(slide)
    if mag0 < magnification:
        print(f"{mag0}<{magnification}? magnification should <= level0_magnification.")
        return None
    patch_size_level0 = int(patch_size * (mag0 / magnification))

    thumbnail = None
    if overview_dir is not None:  # BGR, as OpenCV holds it
        thumbnail = np.ascontiguousarray(
            as_rgb(slide.get_thumbnail(slide.level_dimensions[overview_level]))[..., ::-1])

    if patch_dir is not None:
        patch_dir = Path(patch_dir) / filename
        patch_dir.mkdir(parents=True, exist_ok=True)

    mask_filepath = str(Path(mask_dir) / f"{filename}.png") if mask_dir is not None else None
    try:
        mask_fn = _filters.MASK_ALGORITHMS[method]
    except KeyError:
        raise ValueError(f"filter method is wrong, {method}. ")
    mask, bg_color = mask_fn(slide, mask_downsample=scale_factor, mask_filepath=mask_filepath)

    mask_h, mask_w = mask.shape
    mask_patch_size = int(((patch_size_level0 // scale_factor) * 2 + 1) // 2)
    num_step_x = int(mask_w // mask_patch_size)
    num_step_y = int(mask_h // mask_patch_size)

    # background share per grid cell: the grid-covered mask as cells
    s = mask_patch_size
    grid = mask[: num_step_y * s, : num_step_x * s]
    is_bg = np.all(grid[..., None] == bg_color, axis=2)  # the gray mask as BGR
    bg_frac = is_bg.reshape(num_step_y, s, num_step_x, s).mean(axis=(1, 3))

    # out of bounds at level 0 (create_patches.py:89): the bottom-right
    # corner has x >= w or y >= h
    w, h = slide.dimensions
    right = (np.arange(num_step_x) + 1) * patch_size_level0
    bottom = (np.arange(num_step_y) + 1) * patch_size_level0
    in_bounds = (bottom[:, None] < h) & (right[None, :] < w)
    keep = (bg_frac <= (1.0 - tissue_thresh)) & in_bounds

    coord_list = []
    for row, col in zip(*np.nonzero(keep)):
        top_left, _, _ = get_three_points(int(col), int(row), patch_size_level0)
        coord_list.append({"row": int(row), "col": int(col),
                           "x": top_left[0], "y": top_left[1]})
        if thumbnail is not None:
            scale = slide.level_downsamples[overview_level]
            tl, br, _ = get_three_points(int(col), int(row), patch_size_level0 / scale)
            cvcompat.rectangle(thumbnail, tl, br, (0, 0, 255), thickness=3)
        if patch_dir is not None:
            patch = read_patch(slide, top_left, (patch_size_level0, patch_size_level0))
            write_png(patch_dir / f"{row}_{col}.png",
                      resize_u8(patch, (patch_size, patch_size))[..., ::-1])

    if coord_dir is not None:
        save_coord_json(
            Path(coord_dir) / f"{filename}.json",
            slide_filepath=str(slide_filepath), magnification=magnification,
            magnification_level0=mag0, num_row=num_step_y, num_col=num_step_x,
            patch_size=patch_size, patch_size_level0=patch_size_level0,
            coords=coord_list,
        )
    if thumbnail is not None:
        write_png(Path(overview_dir) / f"{filename}.png", thumbnail)
    print(f"{filename} | mag0: {mag0} | (rows, cols): {num_step_y}, {num_step_x} | "
          f"patch_size: {patch_size} | num_patches: {len(coord_list)}")
    return {
        "slide_filepath": str(slide_filepath), "magnification": magnification,
        "magnification_level0": mag0, "num_row": num_step_y, "num_col": num_step_x,
        "patch_size": patch_size, "patch_size_level0": patch_size_level0,
        "num_patches": len(coord_list), "coords": coord_list,
    }


def run_tiling(args) -> None:
    """Batch CLI body (``create_patches.py:128-189``): per-slide try/except,
    idempotent skip when the coord json already exists."""
    save_dir = Path(args.save_dir)
    coord_dir = save_dir / "coord"
    coord_dir.mkdir(parents=True, exist_ok=True)
    overview_dir = mask_dir = patch_dir = None
    if args.overview:
        overview_dir = save_dir / "overview"
        overview_dir.mkdir(parents=True, exist_ok=True)
    if args.save_mask:
        mask_dir = save_dir / "mask"
        mask_dir.mkdir(parents=True, exist_ok=True)
    if args.save_patch:
        patch_dir = save_dir / "patch"
        patch_dir.mkdir(parents=True, exist_ok=True)

    from murcl_tpu_torch.drivers.murcl import resolve_device

    device = resolve_device(getattr(args, "device", "cpu"))
    slide_dir = Path(args.slide_dir)
    paths = sorted(slide_dir.rglob(f"*{args.wsi_format}"))
    print(f"tiling {len(paths)} slides from {slide_dir}")
    for p in paths:
        # --specify_filename keeps chars [l:r) of the stem as the save index
        # (create_patches.py:161-162)
        if args.specify_filename:
            filename = p.stem[int(args.filename_l):int(args.filename_r)]
        else:
            filename = p.stem
        if (coord_dir / f"{filename}.json").exists() and not args.exist_ok:
            print(f"{filename} skipped: coord exists")
            continue
        try:
            tiling(
                p, magnification=args.magnification, patch_size=args.patch_size,
                scale_factor=args.scale_factor, tissue_thresh=args.tissue_thresh,
                method=args.method, overview_level=args.overview_level,
                coord_dir=coord_dir, overview_dir=overview_dir,
                mask_dir=mask_dir, patch_dir=patch_dir, filename=filename,
                device=device,
            )
        except DecoderUnavailable:  # every JPEG slide would fail alike
            raise
        except Exception as e:  # per-slide resilience (create_patches.py:171-188)
            print(f"{filename} Error! {type(e).__name__}: {e}")
