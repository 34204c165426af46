"""Experiment utilities: seeds, run-dir management, json IO, loggers, trackers.

Counterpart of ``murcl_tpu/utils/general.py`` (``init_seeds``,
``increment_path``, ``load_json``/``dump_json``, ``CSVWriter``,
``AverageMeter``, ``BestVariable``, ``EarlyStop``) without yaml.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import random
import re
from pathlib import Path

import numpy as np
import torch


def init_seeds(seed: int = 0) -> None:
    """Seed python, numpy and torch's default generator (model init draws)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def increment_path(path, exist_ok: bool = True, sep: str = "") -> str:
    """Increment a run path: ``runs/exp -> runs/exp{sep}2, runs/exp{sep}3, ...``."""
    path = Path(path)
    if (path.exists() and exist_ok) or (not path.exists()):
        return str(path)
    dirs = glob.glob(f"{path}{sep}*")
    matches = [re.search(rf"%s{sep}(\d+)" % re.escape(path.stem), d) for d in dirs]
    i = [int(m.groups()[0]) for m in matches if m]
    n = max(i) + 1 if i else 2
    return f"{path}{sep}{n}"


def dump_json(data, filename) -> None:
    with open(filename, "w", encoding="utf-8") as fp:
        json.dump(data, fp)


def load_json(filename):
    with open(filename, "r", encoding="utf-8") as fp:
        return json.load(fp)


class EarlyStop:
    """Stop after ``max_num_accordance`` consecutive updates with an unchanged value."""

    def __init__(self, max_num_accordance: int = 5):
        self.max_num_accordance = max_num_accordance
        self.base_variable = ()
        self.num_accordance = 0

    def update(self, variable) -> None:
        if variable == self.base_variable:
            self.num_accordance += 1
        else:
            self.num_accordance = 1
            self.base_variable = variable

    def is_stop(self) -> bool:
        return self.num_accordance >= self.max_num_accordance


class CSVWriter:
    """Append-per-row CSV logger (one file handle open per write, crash-safe)."""

    def __init__(self, filename, header=None, sep: str = ",", append: bool = False):
        self.filename = filename
        self.sep = sep
        if Path(self.filename).exists() and not append:
            os.remove(self.filename)
        if header is not None:
            self.write_row(header)

    def write_row(self, row) -> None:
        with open(self.filename, "a+", newline="") as fp:
            csv.writer(fp, delimiter=self.sep).writerow(row)


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1) -> None:
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class BestVariable:
    """Track the best (max or min) value seen and the epoch it occurred."""

    def __init__(self, order: str = "max"):
        if order not in ("max", "min"):
            raise ValueError(f"order must be 'max' or 'min', got {order!r}")
        self.order = order
        self.reset()

    def reset(self) -> None:
        self.best = float("-inf") if self.order == "max" else float("inf")
        self.epoch = 0

    def compare(self, val, epoch=None, inplace: bool = False) -> bool:
        flag = val > self.best if self.order == "max" else val < self.best
        if flag and inplace:
            self.best = val
            if epoch is not None:
                self.epoch = epoch
        return flag
