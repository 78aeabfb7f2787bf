"""Metrics and logging (port of ``nlbac_tpu/train/logging.py``): the
``EpochLogger`` writing a tab-separated ``progress.txt`` (``%.6g``, one
flush per row) with an aligned stdout table, the ``config.json``
snapshot, and wall-clock phase timers.

The native C++ TSV writer and the wandb/TensorBoard sinks are not ported
yet (ROADMAP.md); the Python writer here writes the same format.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np

from nlbac_tpu_torch.utils.serialization import convert_json


def colorize(string: str, color: str, bold: bool = False) -> str:
    """ANSI colorizer."""
    colors = {"gray": 30, "red": 31, "green": 32, "yellow": 33, "blue": 34,
              "magenta": 35, "cyan": 36, "white": 37}
    attr = [str(colors.get(color, 37))]
    if bold:
        attr.append("1")
    return f"\x1b[{';'.join(attr)}m{string}\x1b[0m"


class EpochLogger:
    """Tab-separated progress writer with per-epoch statistics.

    ``store`` accumulates values within an epoch; ``log_tabular`` takes
    their mean; ``dump_tabular`` writes one row to ``progress.txt``,
    flushes it, and prints an aligned table."""

    def __init__(self, output_dir: Optional[str] = None,
                 quiet: bool = False):
        self.output_dir = output_dir
        self.quiet = quiet
        self._file = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            self._file = open(os.path.join(output_dir, "progress.txt"), "w")
        self._epoch_store: Dict[str, list] = {}
        self._row: Dict[str, float] = {}
        self._headers = None

    def save_config(self, config: Any) -> None:
        """Best-effort JSON snapshot of the run config."""
        if self.output_dir is None:
            return
        blob = json.dumps(convert_json(config), indent=2, sort_keys=True,
                          default=str)
        with open(os.path.join(self.output_dir, "config.json"), "w") as f:
            f.write(blob)

    def store(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self._epoch_store.setdefault(k, []).append(float(v))

    def log_tabular(self, key: str, value: Optional[float] = None) -> None:
        """Put ``value`` in this row's ``key`` column, or the mean of the
        values stored under ``key`` this epoch (nan if none)."""
        if value is not None:
            self._row[key] = float(value)
            return
        vals = self._epoch_store.pop(key, [])
        self._row[key] = float(np.mean(vals)) if vals else float("nan")

    def dump_tabular(self) -> None:
        keys = list(self._row.keys())
        if self._file is not None:
            if self._headers is None:
                self._headers = keys
                self._file.write("\t".join(keys) + "\n")
            self._file.write(
                "\t".join(f"{self._row.get(k, float('nan')):.6g}"
                          for k in self._headers) + "\n")
            self._file.flush()
        if not self.quiet:
            width = max((len(k) for k in keys), default=8) + 2
            print("-" * (width + 17))
            for k in keys:
                print(f"| {k:<{width}}| {self._row[k]:<13.6g}|")
            print("-" * (width + 17))
        self._row = {}
        self._epoch_store = {}

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


class StepTimer:
    """Wall-clock phase timers (per-phase totals + counts)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextmanager
    def time(self, phase: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[phase] = self.totals.get(phase, 0.0) + dt
            self.counts[phase] = self.counts.get(phase, 0) + 1

    def summary(self) -> Dict[str, str]:
        """Per-phase 'total (mean x N)' strings."""
        out = {}
        for k, tot in self.totals.items():
            n = self.counts[k]
            if n > 1:
                out[f"time/{k}"] = f"{tot:.1f}s ({tot / n:.3f}s x {n})"
            else:
                out[f"time/{k}"] = f"{tot:.1f}s"
        return out
