"""Run directories (the port's copy of ``nlbac_tpu/utils/output.py``):
each run gets ``<parent>/<env>-run<N>`` with N = 1 + the largest existing
run index, and per-seed experiment dirs
``<data_dir>/<exp_name>/<exp_name>_s<seed>``."""

from __future__ import annotations

import os
import re


def get_output_folder(parent_dir: str, env_name: str) -> str:
    """Auto-incremented run dir (<env>-run<N>), claimed by creating it with
    exist_ok=False, so two launches at once never share one."""
    os.makedirs(parent_dir, exist_ok=True)
    max_run = 0
    pattern = re.compile(rf"^{re.escape(env_name)}-run(\d+)$")
    for name in os.listdir(parent_dir):
        m = pattern.match(name)
        if m and os.path.isdir(os.path.join(parent_dir, name)):
            max_run = max(max_run, int(m.group(1)))
    for run in range(max_run + 1, max_run + 1000):
        path = os.path.join(parent_dir, f"{env_name}-run{run}")
        try:
            os.makedirs(path, exist_ok=False)
            return path
        except FileExistsError:
            continue
    raise RuntimeError(
        f"could not claim a run dir under {parent_dir} after 1000 tries")


def setup_logger_kwargs(exp_name: str, seed: int | None = None,
                        data_dir: str = "./") -> dict:
    subdir = exp_name if seed is None else f"{exp_name}_s{seed}"
    return {"output_dir": os.path.join(data_dir, exp_name, subdir)}
