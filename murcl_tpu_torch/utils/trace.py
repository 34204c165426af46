"""Spans and a counter of host waits inside the port's steps, on the
profiler's clock.

:func:`span` is a ``torch.profiler.record_function`` while a profiler
records (``--profile N``, the step scripts, the benchmark's traced run) and
one shared null context otherwise, so an untraced step pays one test a span
and there is no flag. A span's events share the profiler's clock with the
card's, so a kernel, or a gap in the card's work, can be put down to the
innermost span open when it was launched or began.

:func:`step` opens ``murcl.step`` around an engine's step. While a profiler
records and the step's device is CUDA, it also runs the step under torch's
sync debug mode ``"warn"``, which flags every blocking copy, ``.item()`` and
stream sync that goes through c10; it records those warnings and prints none,
and counts each under the innermost open span and the first frame inside
``murcl_tpu_torch`` (the first frame outside torch where the package has
none), as ``file:line`` from the repository's root. A device-to-device copy
does not block the host and is not counted. :func:`host_waits` reads the
counts, :func:`reset_host_waits` clears them.

The spans, each with the layer it times:

==================  ================================================  ==========
``murcl.step``      an engine's ``train_step`` / ``eval_step``        engine
``murcl.draws``     the host's random draws and their moves to the    engine
                    card
``murcl.select``    ``select_feats``: the ranks and K1/K5             selection
``murcl.mixup``     K6 (``mixup_rows``) and ``mixup_ref``             mixup
``murcl.aggregator`` the aggregator's forward                         aggregator
``murcl.head``      ``FullLayer``'s forward                           GRU head
``murcl.loss``      NT-Xent or CE, the similarities and rewards       loss, K4
``murcl.optimizer`` ``engine.optim.step``                             optimizer
``murcl.policy``    ``act``, its noise draw included                  policy
``murcl.ppo_update`` ``PPO.update``                                   policy
==================  ================================================  ==========

Backward kernels have no spans: an autograd node's sequence number ties them
to the forward span that made it.
"""

from __future__ import annotations

import collections
import contextlib
import os
import sys
import threading
import warnings
from typing import Dict, Tuple

import torch
import torch.autograd.profiler as _profiler

# the message of c10's sync debug mode (c10/cuda/CUDAFunctions.cpp)
SYNC_WARNING = "called a synchronizing CUDA operation"
# whether this build of torch can flag syncs (a CPU-only build cannot)
SYNC_DEBUG = hasattr(torch._C, "_cuda_set_sync_debug_mode")

_NULL = contextlib.nullcontext()
_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ROOT = os.path.dirname(_PACKAGE)
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))
_SKIP = (os.path.abspath(__file__), os.path.abspath(warnings.__file__))
_open = threading.local()
_waits: collections.Counter = collections.Counter()


def _names() -> list:
    names = getattr(_open, "names", None)
    if names is None:
        names = _open.names = []
    return names


class _Span(_profiler.record_function):
    """A ``record_function`` that keeps its name on this thread's stack of
    open spans while it is open."""

    def __enter__(self):
        super().__enter__()
        _names().append(self.name)
        return self

    def __exit__(self, *exc):
        _names().pop()
        return super().__exit__(*exc)


def span(name: str):
    """``record_function(name)`` while a profiler records, else a shared
    null context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Span(name)


def _counts_waits(device) -> bool:
    """Whether a step on ``device`` counts its host waits."""
    return SYNC_DEBUG and torch.device(device).type == "cuda"


def _site() -> str:
    """``file:line`` of the first frame inside the package, else of the
    first frame outside torch, above the warning being shown."""
    outside = None
    f = sys._getframe(2)
    while f is not None:
        path = f.f_code.co_filename
        if path not in _SKIP:
            if path.startswith(_PACKAGE + os.sep):
                return f"{os.path.relpath(path, _ROOT)}:{f.f_lineno}"
            if outside is None and not path.startswith(_TORCH + os.sep):
                outside = f
        f = f.f_back
    if outside is None:
        return "?"
    path = outside.f_code.co_filename
    if path.startswith(_ROOT + os.sep):
        path = os.path.relpath(path, _ROOT)
    return f"{path}:{outside.f_lineno}"


class _Tally:
    """Counts the sync debug mode's warnings raised inside it by span and
    site, and shows every other warning as before. Sets the mode to
    ``"warn"`` where this build of torch has it, and restores it."""

    def __enter__(self):
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.filterwarnings("always", message=SYNC_WARNING)
        self._show = warnings.showwarning
        warnings.showwarning = self._shown
        if SYNC_DEBUG:
            self._mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if SYNC_DEBUG:
            torch.cuda.set_sync_debug_mode(self._mode)
        self._catch.__exit__(*exc)
        return False

    def _shown(self, message, category, filename, lineno, file=None, line=None):
        if not str(message).startswith(SYNC_WARNING):
            return self._show(message, category, filename, lineno, file, line)
        names = _names()
        _waits[(names[-1] if names else "(no span)", _site())] += 1


class _Step(_Span):
    """``murcl.step``, counting the step's host waits on a CUDA device."""

    def __init__(self, device):
        super().__init__("murcl.step")
        self._tally = _Tally() if _counts_waits(device) else None

    def __enter__(self):
        super().__enter__()
        if self._tally is not None:
            self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        if self._tally is not None:
            self._tally.__exit__(*exc)
        return super().__exit__(*exc)


def step(device):
    """The ``murcl.step`` span of a step on ``device`` (with the host-wait
    counter on a CUDA device) while a profiler records, else a shared null
    context."""
    if not _profiler._is_profiler_enabled:
        return _NULL
    return _Step(device)


def host_waits() -> Dict[Tuple[str, str], int]:
    """``{(span, "file:line"): count}`` of the host waits counted since the
    process started or :func:`reset_host_waits`."""
    return dict(_waits)


def reset_host_waits() -> None:
    _waits.clear()
