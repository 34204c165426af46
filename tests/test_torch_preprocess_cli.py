"""The three preprocessing entry points of the port, end to end on the CPU,
in a subprocess where ``cv2``, ``PIL``, ``openslide``, ``torchvision``,
``sklearn``, ``jax`` (with ``jaxlib``, ``flax``, ``optax``) and
``murcl_tpu`` cannot be imported: four synthetic slides
(``synthetic_slide``, 768 x 1024 at 40x) written as ``.svs`` files by
``write_tiff`` (pyramids of levels 1 and 4 with an Aperio description; the
four differ in layout and codec: Aperio's extra IFDs with deflate, LZW with
Predictor 2 in BigTIFF, PackBits, stripped deflate) go through
``create_patches --device cpu`` (20x, patch 32: each patch read at 64 px
and resized), ``extract_features --device cpu`` (ResNet18, random weights)
and ``features_clustering --device cpu`` (K 10); the output loads through
``WSIWithCluster`` and trains one port MuRCL stage-1 epoch (CLAM_SB,
feat_size 32, T 3).
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BLOCKED = ("cv2", "PIL", "openslide", "torchvision", "sklearn", "jax", "jaxlib", "flax",
           "optax", "murcl_tpu")

SCRIPT = r'''
import json, math, sys
from pathlib import Path
BLOCKED = {blocked!r}
for name in BLOCKED:
    sys.modules[name] = None

import numpy as np

from murcl_tpu_torch import create_patches, extract_features, features_clustering
from murcl_tpu_torch.data import contract
from murcl_tpu_torch.data.datasets import WSIWithCluster
from murcl_tpu_torch.data.synthetic import aperio_description, synthetic_slide, write_tiff
from murcl_tpu_torch.drivers.murcl import default_args, run
from murcl_tpu_torch.utils.general import dump_json

root = Path(sys.argv[1])
slide_dir = root / "slides"
slide_dir.mkdir()
layouts = [dict(svs_extras=True), dict(compression="lzw", predictor=2, bigtiff=True),
           dict(compression="packbits"), dict(stripped=True)]
for i, layout in enumerate(layouts):
    img = synthetic_slide(768, 1024, seed=i)
    write_tiff(slide_dir / f"slide_{{i}}.svs", [img, np.ascontiguousarray(img[::4, ::4])],
               tile=128, description=aperio_description(1024, 768, 128, 40), **layout)

create_patches.main(["--slide_dir", str(slide_dir), "--save_dir", str(root / "patches"),
                     "--patch_size", "32", "--scale_factor", "8", "--overview", "--save_mask",
                     "--device", "cpu"])
records = extract_features.main(["--patch_dir", str(root / "patches"), "--device", "cpu",
                                 "--batch_size", "64", "--num_workers", "2"])
feat_dir = root / "patches" / "features" / "resnet18"
features_clustering.main(["--feat_dir", str(feat_dir), "--device", "cpu"])

rows = [{{"case_id": r["case_id"], "features_filepath": str(feat_dir / (r["case_id"] + ".npz")),
         "label": i % 2,
         "clusters_filepath": str(feat_dir / "k-means-10" / (r["case_id"] + ".npz")),
         "clusters_json_filepath": str(feat_dir / "k-means-10" / (r["case_id"] + ".json"))}}
        for i, r in enumerate(records)]
contract.save_manifest(root / "slides_10.csv", rows)
ids = [r["case_id"] for r in rows]
dump_json({{"train": ids, "valid": ids[:2], "test": ids[2:]}}, root / "split.json")
ds = WSIWithCluster(root / "slides_10.csv")
items = [ds[i] for i in range(len(ds))]
out = run(default_args(data_csv=str(root / "slides_10.csv"),
                       data_split_json=str(root / "split.json"), device="cpu", epochs=1,
                       ppo_epochs=1, batch_size=2, data_repeat=1, feat_size=32, T=3,
                       arch="CLAM_SB", train_stage=1, base_save_dir=str(root / "results")))
bad = sorted(m for m, v in sys.modules.items() if v is not None and m.split(".")[0] in BLOCKED)
print(json.dumps({{"records": records, "num_clusters": ds.num_clusters,
                  "items": [[list(f.shape), sorted(i for c in cl for i in c) == list(range(len(f))),
                             int(lab)] for f, cl, lab, _ in items],
                  "loss": out["best_loss"], "finite": math.isfinite(out["best_loss"]),
                  "save_dir": str(out["save_dir"]), "imported": bad}}))
'''


def test_cli_chain_without_cv2_pil_torchvision_sklearn_jax(tmp_path):
    proc = subprocess.run([sys.executable, "-c", SCRIPT.format(blocked=BLOCKED), str(tmp_path)],
                          cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["imported"] == []
    assert "WARNING: pretrained resnet18 weights unavailable" in proc.stdout
    patches = tmp_path / "patches"
    assert sorted(p.name for p in (patches / "coord").iterdir()) == [
        f"slide_{i}.json" for i in range(4)]
    assert len(list((patches / "overview").iterdir())) == len(list((patches / "mask").iterdir())) == 4
    assert [r["case_id"] for r in res["records"]] == [f"slide_{i}" for i in range(4)]
    for rec, (shape, covered, label) in zip(res["records"], res["items"]):
        coord = json.loads((patches / "coord" / f"{rec['case_id']}.json").read_text())
        assert coord["patch_size_level0"] == 64 and coord["num_patches"] == rec["num_patches"] > 10
        assert shape == [rec["num_patches"], 512] and covered
    assert res["num_clusters"] == 10
    assert res["finite"] and (Path(res["save_dir"]) / "model_best.pth.tar").exists()
