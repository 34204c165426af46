"""The port's pointers into ``ROADMAP.md``: every "ROADMAP queue 1, item N"
in a help string or docstring of ``murcl_tpu_torch`` names the item the
drivers raise with for that option, each item named exists in
``ROADMAP.md``'s Queue 1, and no "slice N" pointer is left."""

import re
from pathlib import Path

import pytest

from murcl_tpu_torch.drivers import murcl, rlmil
from murcl_tpu_torch.drivers.murcl import default_args as murcl_defaults
from murcl_tpu_torch.drivers.rlmil import default_args as rlmil_defaults

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "murcl_tpu_torch"
# each still-unported option and the args that switch it on
OPTIONS = {"--dp_devices": {"dp_devices": 2}}


def _raised_items():
    """Option -> the item number both drivers raise with."""
    items = {}
    for option, overrides in OPTIONS.items():
        found = set()
        for module, defaults in ((murcl, murcl_defaults), (rlmil, rlmil_defaults)):
            with pytest.raises(NotImplementedError) as err:
                module._reject_unported(defaults(**overrides))
            found |= set(re.findall(r"ROADMAP queue 1, item (\d+)", str(err.value)))
        assert len(found) == 1, (option, found)
        items[option] = found.pop()
    return items


def test_help_strings_name_the_drivers_items():
    items = _raised_items()
    seen = 0
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        for m in re.finditer(r"add_argument\('(--\w+)'[^)]*?ROADMAP queue 1, item (\d+)", text,
                             re.S):
            option, item = m.groups()
            assert items.get(option) == item, (path.name, option, item, items)
            seen += 1
    assert seen >= 2  # both CLIs' --dp_devices


def test_every_item_named_exists_and_no_slice_is_left():
    roadmap = (REPO / "ROADMAP.md").read_text()
    queue1 = roadmap[roadmap.index("### Queue 1"):roadmap.index("### Queue 2")]
    listed = set(re.findall(r"\*\*Item (\d+)", queue1))
    named = set()
    for path in PORT.rglob("*.py"):
        text = path.read_text()
        assert not re.search(r"ROADMAP[^\n]*slice \d", text), path
        assert not re.search(r"\bslice [0-9]+\)", text), path
        named |= set(re.findall(r"ROADMAP queue 1, item (\d+)", text))
    assert named and named <= listed, (named, listed)
    assert set(_raised_items().values()) <= listed
