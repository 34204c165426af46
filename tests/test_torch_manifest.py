"""``python -m murcl_tpu_torch.build_manifest`` against
``scripts/build_manifest.py`` (pandas, here), on the same inputs.

Each case runs both in a subprocess and compares the exit code, the
manifest CSV's bytes, the split JSON's bytes, standard output and standard
error: three labels with skipped slides (a missing feature npz, a missing
cluster json), two labels at another seed and ``--frac``, an empty split's
warning, and the two exit-2 cases (a labels CSV without ``case_id,label``;
no slide with all three artifacts). The port runs with pandas blocked.

The one difference kept on purpose: a numeric-looking ``case_id`` such as
``001`` is the integer 1 to pandas (the script looks for ``1.npz`` and
skips the slide) and the string ``001`` to the port.
"""

import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = ("import sys; sys.modules['pandas'] = None; "
        "from murcl_tpu_torch.build_manifest import main; sys.exit(main(sys.argv[1:]))")


def _tree(root: Path, cases, missing=()):
    """Feature and cluster files for ``cases``, except the ``missing``
    ``(case, suffix)`` pairs."""
    feat, clus = root / "features", root / "features" / "k-means-10"
    clus.mkdir(parents=True, exist_ok=True)
    for cid in cases:
        for path in (feat / f"{cid}.npz", clus / f"{cid}.npz", clus / f"{cid}.json"):
            where = "feat" if path.parent == feat else "clus"
            if (cid, where + path.suffix) not in missing:
                path.write_bytes(b"x")
    return feat, clus


def _run(cmd, feat, clus, labels, out, *extra):
    argv = ["--feat_dir", str(feat), "--cluster_dir", str(clus), "--labels_csv", str(labels),
            "--out_dir", str(out), *extra]
    proc = subprocess.run([sys.executable, *cmd, *argv], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    files = {p.name: p.read_bytes() for p in sorted(out.glob("*"))} if out.exists() else {}
    return proc.returncode, proc.stdout.replace(str(out), "<out>"), proc.stderr, files


def _both(tmp_path, labels_text, cases, missing=(), extra=()):
    feat, clus = _tree(tmp_path, cases, missing)
    labels = tmp_path / "labels.csv"
    labels.write_text(labels_text)
    script = _run([str(REPO / "scripts" / "build_manifest.py")], feat, clus, labels,
                  tmp_path / "script", *extra)
    port = _run(["-c", PORT], feat, clus, labels, tmp_path / "port", *extra)
    return script, port


def _same(script, port):
    s_rc, s_out, s_err, s_files = script
    p_rc, p_out, p_err, p_files = port
    assert p_rc == s_rc, (p_err, s_err)
    assert p_err == s_err
    assert p_out == s_out
    assert p_files == s_files  # the manifest names the shared feature dirs


CASES = [f"normal_{i:03d}" for i in range(7)] + [f"tumor_{i:03d}" for i in range(6)] \
    + [f"test_{i:03d}" for i in range(5)]


def _labels(cases, label_of):
    return "case_id,label\n" + "".join(f"{c},{label_of(c)}\n" for c in cases)


def test_three_labels_with_skipped_slides(tmp_path):
    label_of = {"normal": 0, "tumor": 1, "test": 2}
    text = _labels(CASES, lambda c: label_of[c.split("_")[0]])
    script, port = _both(tmp_path, text, CASES,
                         missing={("tumor_002", "feat.npz"), ("test_004", "clus.json")})
    assert script[0] == 0 and "skip tumor_002: missing tumor_002.npz" in script[2]
    _same(script, port)


@pytest.mark.parametrize("extra", [("--seed", "7", "--frac", "0.5,0.25,0.25",
                                    "--dataset", "c16", "--num_clusters", "4"),
                                   ("--frac", "0.8,0.1,0.1")])
def test_two_labels_other_settings(tmp_path, extra):
    cases = CASES[:9]
    text = _labels(cases, lambda c: int(c.startswith("tumor")))
    script, port = _both(tmp_path, text, cases, extra=extra)
    assert script[0] == 0
    _same(script, port)


def test_empty_split_warns(tmp_path):
    cases = CASES[:2]
    script, port = _both(tmp_path, _labels(cases, lambda c: 0), cases)
    assert "WARNING: test split is empty" in script[2]
    _same(script, port)


@pytest.mark.parametrize("text", ["slide,label\na,0\n", "case_id,grade\na,0\n"])
def test_missing_columns_exit_2(tmp_path, text):
    script, port = _both(tmp_path, text, ["a"])
    assert script[0] == 2 and "needs case_id,label columns" in script[2]
    _same(script, port)


def test_no_complete_slide_exit_2(tmp_path):
    script, port = _both(tmp_path, _labels(["a", "b"], lambda c: 0), ["a", "b"],
                         missing={("a", "feat.npz"), ("b", "clus.npz")})
    assert script[0] == 2 and "no slide has all three artifacts" in script[2]
    _same(script, port)


def test_numeric_case_id_kept_as_written(tmp_path):
    """pandas reads a column of ``001``-style ids as integers (1, 2, 10) and
    finds no files for them; the port keeps ``001`` and finds its files."""
    cases = ["001", "002", "010"]
    script, port = _both(tmp_path, _labels(cases, lambda c: int(c) % 2), cases)
    assert script[0] == 2 and "skip 1: missing 1.npz, 1.npz, 1.json" in script[2]
    assert port[0] == 0 and '"slides": 3' in port[1]
    manifest = port[3]["camelyon16_10.csv"].decode()
    assert [line.split(",")[0] for line in manifest.splitlines()[1:]] == cases
