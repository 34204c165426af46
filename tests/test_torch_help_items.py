"""The port's pointers into ``ROADMAP.md`` and its help strings: the port
has every option of the JAX package (``--dp_devices``, the last, ROADMAP
item 14, is ported), so no "not ported yet" message and no "ROADMAP queue 1,
item N" pointer is left in ``murcl_tpu_torch``, nor a "slice N" one; both
CLIs' ``--dp_devices`` help says what the option does."""

import re
from pathlib import Path

import pytest

from murcl_tpu_torch import train_MuRCL, train_RLMIL

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "murcl_tpu_torch"


def test_help_strings_name_the_drivers_items(capsys):
    """Both CLIs' ``--dp_devices`` help describes data-parallel training and
    its batch rule, and names no ROADMAP item."""
    for cli in (train_MuRCL, train_RLMIL):
        with pytest.raises(SystemExit):
            cli.parse_args(["--help"])
        text = " ".join(capsys.readouterr().out.split())
        text = text[text.index("--dp_devices DP_DEVICES"):]
        assert "data-parallel" in text and "torch.distributed" in text, text
        assert "multiple of N" in text and "gloo" in text, text
        assert "ROADMAP" not in text and "not ported" not in text, text


def test_every_item_named_exists_and_no_slice_is_left():
    """No "not ported yet", no "ROADMAP queue 1, item N" and no "slice N"
    pointer in the port; ROADMAP's Queue 1 no longer lists item 14."""
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert "not ported yet" not in text, path
        assert not re.search(r"ROADMAP queue 1, item \d+", text), path
        assert not re.search(r"ROADMAP[^\n]*slice \d", text), path
        assert not re.search(r"\bslice [0-9]+\)", text), path
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    assert "14" not in set(re.findall(r"\*\*Item (\d+)", queue1))
