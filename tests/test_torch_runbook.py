"""The port's one-command runbook (``murcl_tpu_torch/scripts/run_camelyon.sh``)
end to end on the CPU, with ``PIL``, ``cv2``, ``openslide``, ``pandas``,
``torchvision``, ``sklearn``, ``jax`` and ``murcl_tpu`` blocked in every
process it starts: eight small pyramidal ``.tif`` slides in two labels go
through tiling, extraction, k-means, the manifest, MuRCL stages 1-3,
RLMIL stages 1-3 and heatmaps (``DEVICE=cpu``, patch 32, ``FEAT_SIZE``
32, T 2, one epoch per stage and the trainers' own PPO epochs; four
slides per label, so that the manifest's default 0.6/0.15/0.25 split puts
both labels in every split; ``BATCH`` 40, so that MuRCL takes one step per
epoch over its four training slides repeated ten times). The first run
takes under 90 s of its processes' CPU time. A second run skips every step
that has its output (the manifest is rebuilt, to the same bytes)."""

import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from murcl_tpu_torch.data.synthetic import aperio_description, synthetic_slide, write_tiff

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("PIL", "cv2", "openslide", "pandas", "torchvision", "sklearn", "jax", "jaxlib",
           "flax", "optax", "murcl_tpu")


def _run(slides, labels, work, env):
    return subprocess.run(["sh", str(REPO / "murcl_tpu_torch" / "scripts" / "run_camelyon.sh"),
                           str(slides), str(labels), str(work), "cpu"],
                          capture_output=True, text=True, env=env, timeout=300)


def test_runbook_end_to_end_and_resume(tmp_path):
    slides = tmp_path / "slides"
    slides.mkdir()
    cases = [f"normal_{i}" for i in range(4)] + [f"tumor_{i}" for i in range(4)]
    for i, case in enumerate(cases):
        img = synthetic_slide(512, 768, seed=i)
        write_tiff(slides / f"{case}.tif", [img, np.ascontiguousarray(img[::4, ::4])], tile=128,
                   description=aperio_description(768, 512, 128, app_mag=20))
    labels = tmp_path / "labels.csv"
    labels.write_text("case_id,label\n" + "".join(f"{c},{int(c.startswith('tumor'))}\n"
                                                  for c in cases))
    block = tmp_path / "block"
    block.mkdir()
    (block / "sitecustomize.py").write_text(
        "import sys\nfor _m in %r:\n    sys.modules[_m] = None\n" % (BLOCKED,))
    env = dict(os.environ, PYTHONPATH=f"{block}{os.pathsep}{REPO}",
               PATH=f"{Path(sys.executable).parent}{os.pathsep}{os.environ.get('PATH', '')}",
               PATCH="32", FEAT_SIZE="32", T="2", PRE_EPOCHS="1", FT_EPOCHS="1", BATCH="40",
               K="10",
               # one intra-op thread per process: the tensors are tiny, and the
               # test suite's other workers share the cores
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1")
    work = tmp_path / "work"
    t0, before = time.time(), resource.getrusage(resource.RUSAGE_CHILDREN)
    first = _run(slides, labels, work, env)
    after = resource.getrusage(resource.RUSAGE_CHILDREN)
    wall = time.time() - t0
    cpu = (after.ru_utime - before.ru_utime) + (after.ru_stime - before.ru_stime)
    assert first.returncode == 0, first.stdout[-3000:] + first.stderr[-3000:]
    print(f"first run: {wall:.1f} s wall, {cpu:.1f} s of CPU")
    # the runbook's own cost: its processes' CPU time, which the suite's other
    # workers do not inflate as they do the wall time
    assert "DONE" in first.stdout and cpu < 90, (cpu, wall)
    assert sorted(p.stem for p in (work / "patches" / "coord").glob("*.json")) == cases
    assert len(list((work / "features" / "resnet18" / "k-means-10").glob("*.npz"))) == 8
    heatmaps = sorted(p.stem for p in (work / "heatmaps").glob("*.png"))
    assert heatmaps == cases
    for stage in (1, 2, 3):
        assert list((work / "runs" / "pretrain").rglob(f"stage_{stage}/model_best.pth.tar"))
        assert list((work / "runs" / "finetune").rglob(f"stage_{stage}/final_res.csv"))
    manifest = (work / "manifest" / "camelyon16_10.csv").read_bytes()

    second = _run(slides, labels, work, env)
    assert second.returncode == 0, second.stdout[-3000:] + second.stderr[-3000:]
    out = second.stdout
    assert out.count("skipped: coord exists") == 8
    assert out.count("skipped: npz exists") == 8
    assert out.count("exists!") == 8  # k-means
    assert all(f"pretrain stage {s} done, skip" in out for s in (1, 2, 3))
    assert all(f"finetune stage {s} done, skip" in out for s in (1, 2, 3))
    assert out.count("skipped: heatmap exists") == 8
    assert (work / "manifest" / "camelyon16_10.csv").read_bytes() == manifest
