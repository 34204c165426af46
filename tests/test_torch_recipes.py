"""The port's run recipes (``murcl_tpu_torch/runs/*.sh``) against the JAX
package's (``runs/*.sh``): each command passes the same flags with the same
values, in the same order, to the port's CLI in place of the script, and
the port's parser accepts every one of them."""

import re
import shlex
from pathlib import Path

import pytest

from murcl_tpu_torch import train_MuRCL, train_RLMIL

REPO = Path(__file__).resolve().parents[1]
PARSERS = {"train_MuRCL": train_MuRCL.parse_args, "train_RLMIL": train_RLMIL.parse_args}


def _commands(path: Path):
    """``(cli, argv)`` of each python command, continuation lines joined."""
    text = path.read_text().replace("\\\n", " ")
    out = []
    for line in text.splitlines():
        words = shlex.split(line.strip())
        if not words or words[0] != "python":
            continue
        if words[1] == "-m":
            cli, argv = words[2].split(".")[-1], words[3:]
        else:
            cli, argv = Path(words[1]).stem, words[2:]
        out.append((cli, argv))
    return out


@pytest.mark.parametrize("name", ["pretrain", "finetune", "linear", "scratch"])
def test_recipe_matches_jax_and_parses(name):
    ours = _commands(REPO / "murcl_tpu_torch" / "runs" / f"{name}.sh")
    theirs = _commands(REPO / "runs" / f"{name}.sh")
    assert len(ours) == len(theirs) == 2
    assert ours == theirs
    for cli, argv in ours:
        for stage in ("1", "2"):
            args = PARSERS[cli]([a.replace("${STAGE}", stage) for a in argv])
            assert args.train_stage in (1, 2, 3) and str(args.device) == "0"
    text = (REPO / "murcl_tpu_torch" / "runs" / f"{name}.sh").read_text()
    assert "python -m murcl_tpu_torch." in text and not re.search(r"\.\./train_", text)
