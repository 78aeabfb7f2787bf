"""Metrics and logging (port of ``nlbac_tpu/train/logging.py``): the
``EpochLogger`` writing a tab-separated ``progress.txt`` (``%.6g``, one
flush per row; through the native C++ writer of ``runtime_native`` when it
builds, else in Python, byte for byte the same) with an aligned stdout
table, the ``config.json`` snapshot, the ``MetricsSink`` (wandb and
TensorBoard when installed) and wall-clock phase timers.
"""

from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from typing import Any, Dict, Optional

import numpy as np

from nlbac_tpu_torch import runtime_native
from nlbac_tpu_torch.utils.serialization import convert_json


def colorize(string: str, color: str, bold: bool = False) -> str:
    """ANSI colorizer."""
    colors = {"gray": 30, "red": 31, "green": 32, "yellow": 33, "blue": 34,
              "magenta": 35, "cyan": 36, "white": 37}
    attr = [str(colors.get(color, 37))]
    if bold:
        attr.append("1")
    return f"\x1b[{';'.join(attr)}m{string}\x1b[0m"


def warn_short(i_episode: int, count: float) -> None:
    """One warning line for an episode in which adaptive NODE
    integrations ran out of trial steps before dt."""
    if count > 0:
        print(colorize(f"warning: episode {i_episode}: {count:.0f} NODE "
                       "integrations ended short of dt (raise "
                       "--node_adaptive_scan_steps)", "red"))


class EpochLogger:
    """Tab-separated progress writer with per-epoch statistics.

    ``store`` accumulates values within an epoch; ``log_tabular`` takes
    their mean; ``dump_tabular`` writes one row to ``progress.txt``,
    flushes it, and prints an aligned table."""

    def __init__(self, output_dir: Optional[str] = None,
                 quiet: bool = False, native: bool = True):
        """``native``: write through the native writer when its library
        builds (in Python otherwise); False always writes in Python."""
        self.output_dir = output_dir
        self.quiet = quiet
        self._file = None
        self._native = None
        if output_dir is not None:
            os.makedirs(output_dir, exist_ok=True)
            path = os.path.join(output_dir, "progress.txt")
            if native and runtime_native.native_available():
                self._native = runtime_native.NativeTsvWriter(path)
            else:
                self._file = open(path, "w")
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
        if self._native is not None:
            if self._headers is None:
                self._headers = keys
                self._native.header(keys)
            self._native.row([self._row.get(k, float("nan"))
                              for k in self._headers])
            self._native.flush()
        elif self._file is not None:
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

    @property
    def writer(self) -> Optional[str]:
        """'native' or 'python': what writes progress.txt (None without
        an output dir)."""
        if self._native is not None:
            return "native"
        return "python" if self._file is not None else None

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        if self._file is not None:
            self._file.close()


class MetricsSink:
    """Per-episode metric dicts to wandb and TensorBoard, and to an
    in-memory history. Either external channel that is not installed (or
    fails to start) prints one line and the run goes on with
    ``progress.txt``."""

    def __init__(self, logger: Optional[EpochLogger] = None,
                 use_wandb: bool = False, wandb_project: str = "",
                 wandb_config: Any = None,
                 tensorboard_dir: Optional[str] = None):
        self.logger = logger
        self.history = []
        self._wandb = None
        self._tb = None
        self._step = 0
        if use_wandb:
            try:
                import wandb
                self._wandb = wandb.init(project=wandb_project or "nlbac",
                                         config=wandb_config)
            except Exception as e:  # absent, or cannot start offline
                print(colorize(f"wandb unavailable ({e}); metrics go to "
                               "progress.txt only", "yellow"))
        if tensorboard_dir:
            try:
                from torch.utils.tensorboard import SummaryWriter
                self._tb = SummaryWriter(log_dir=tensorboard_dir)
            except Exception as e:  # the tensorboard package is absent
                print(colorize(f"tensorboard unavailable ({e}); metrics "
                               "go to progress.txt only", "yellow"))

    def log(self, metrics: Dict[str, float]) -> None:
        metrics = {k: float(v) for k, v in metrics.items()}
        self.history.append(metrics)
        if self._wandb is not None:
            self._wandb.log(metrics)
        if self._tb is not None:
            # one step per call (an episode), tags named as for wandb
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, self._step)
        self._step += 1

    def close(self) -> None:
        if self._wandb is not None:
            self._wandb.finish()
        if self._tb is not None:
            self._tb.close()
        if self.logger is not None:
            self.logger.close()


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
