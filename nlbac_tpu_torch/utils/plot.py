"""Plotter CLI over progress.txt trees (the port's copy of
``nlbac_tpu/utils/plot.py``, so the port plots its runs without importing
the JAX package): walk experiment directories, load every progress.txt
with its config.json, and plot a chosen column against an x-axis with
mean+/-std bands across seeds, one legend entry per experiment, on
matplotlib alone (imported when a plot is drawn).

Usage:
    python -m nlbac_tpu_torch.utils.plot LOGDIR [LOGDIR ...] \
        --value reward_train --xaxis Episode --out plot.png
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

import numpy as np


def load_progress(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        header = f.readline().strip().split("\t")
        rows = [line.strip().split("\t") for line in f if line.strip()]
    cols = {h: np.array([float(r[i]) if i < len(r) else np.nan
                         for r in rows])
            for i, h in enumerate(header)}
    return cols


def get_datasets(logdir: str) -> List[dict]:
    """Walk a directory tree collecting (progress, config, exp_name)."""
    datasets = []
    for root, _, files in os.walk(logdir):
        if "progress.txt" in files:
            exp_name = None
            cfg_path = os.path.join(root, "config.json")
            if os.path.exists(cfg_path):
                try:
                    with open(cfg_path) as f:
                        cfg = json.load(f)
                    exp_name = (cfg.get("run", {}) or {}).get("exp_name")
                except Exception:
                    pass
            datasets.append({
                "progress": load_progress(os.path.join(root,
                                                       "progress.txt")),
                "exp_name": exp_name or os.path.basename(root),
                "dir": root,
            })
    return datasets


def plot_data(datasets: List[dict], value: str = "reward_train",
              xaxis: str = "Episode", smooth: int = 1, ax=None):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 5))

    by_exp: Dict[str, List[dict]] = {}
    for d in datasets:
        by_exp.setdefault(d["exp_name"], []).append(d)

    for name, group in sorted(by_exp.items()):
        xs, ys = [], []
        for d in group:
            p = d["progress"]
            if value not in p or xaxis not in p:
                continue
            y = p[value]
            if smooth > 1:
                # edge-normalized moving average (the reference's
                # vendored plotter does exactly this, UNI/utils/plot.py):
                # a bare 'same' convolution implicitly pads with zeros,
                # biasing the first/last smooth//2 points toward 0
                k = np.ones(smooth)
                y = (np.convolve(y, k, mode="same")
                     / np.convolve(np.ones_like(y), k, mode="same"))
            xs.append(p[xaxis])
            ys.append(y)
        if not ys:
            continue
        n = min(len(y) for y in ys)
        y = np.stack([yy[:n] for yy in ys])
        x = xs[0][:n]
        mean, std = y.mean(0), y.std(0)
        line, = ax.plot(x, mean, label=f"{name} (n={len(ys)})")
        ax.fill_between(x, mean - std, mean + std, alpha=0.25,
                        color=line.get_color())
    ax.set_xlabel(xaxis)
    ax.set_ylabel(value)
    ax.legend()
    ax.grid(alpha=0.3)
    return ax


def make_plots(logdirs: List[str], value: str, xaxis: str, smooth: int,
               out: Optional[str]):
    datasets = []
    for d in logdirs:
        datasets += get_datasets(d)
    if not datasets:
        raise SystemExit(f"no progress.txt found under {logdirs}")
    ax = plot_data(datasets, value=value, xaxis=xaxis, smooth=smooth)
    out = out or "plot.png"
    ax.figure.savefig(out, dpi=120, bbox_inches="tight")
    print(f"wrote {out} ({len(datasets)} runs)")


def main(argv=None):
    p = argparse.ArgumentParser(description="plot progress.txt trees")
    p.add_argument("logdir", nargs="+")
    p.add_argument("--value", default="reward_train")
    p.add_argument("--xaxis", default="Episode")
    p.add_argument("--smooth", type=int, default=1)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    make_plots(args.logdir, args.value, args.xaxis, args.smooth, args.out)


if __name__ == "__main__":
    main()
