"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: top-level import names compared
whole (``murcl_tpu_torch`` is not ``murcl_tpu``)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "murcl_tpu"}


def top_names(path: Path) -> set:
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


MODULES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_import(path):
    assert not top_names(path) & FORBIDDEN, path


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "murcl_tpu_torch" not in top_names(path), path


def test_names_compared_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import murcl_tpu_torch.ops\nfrom murcl_tpu_torch import models\n")
    assert top_names(f) == {"murcl_tpu_torch"}
    assert not top_names(f) & FORBIDDEN
    f.write_text("from murcl_tpu.ops import select\n")
    assert top_names(f) & FORBIDDEN == {"murcl_tpu"}
