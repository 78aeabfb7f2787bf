"""Hyperparameter grid search over the port's config tree (port of
``nlbac_tpu/utils/grid.py``): declare axes of values, take their cartesian
product, give each variant a name derived from its values, and run them.

Grid keys address nested config fields with dots:
    g = ExperimentGrid("uni-sweep", base="unicycle")
    g.add("constraint.gamma_b", [20.0, 50.0])
    g.add("sac.batch_size", [128, 256])
    for name, cfg in g.variant_configs(): ...

``run_all`` trains every variant in this process through the port's
``train/cli.py::train``, on the GPU unless ``device="cpu"`` is passed.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

from nlbac_tpu_torch.config import NLBACConfig, get_config


def _replace_path(cfg, path: str, value):
    parts = path.split(".")
    if len(parts) == 1:
        return dataclasses.replace(cfg, **{parts[0]: value})
    head, rest = parts[0], ".".join(parts[1:])
    sub = getattr(cfg, head)
    return dataclasses.replace(cfg, **{head: _replace_path(sub, rest,
                                                           value)})


def _shorthand(path: str) -> str:
    return "".join(p[:3] for p in path.split(".")[-1].split("_"))


class ExperimentGrid:
    def __init__(self, name: str, base: str | NLBACConfig = "unicycle"):
        self.name = name
        self.base = get_config(base) if isinstance(base, str) else base
        self.keys: List[str] = []
        self.vals: List[List[Any]] = []
        self.shorthands: List[Optional[str]] = []

    def add(self, key: str, vals, shorthand: Optional[str] = None
            ) -> "ExperimentGrid":
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        if key in self.keys:
            # a repeated axis would keep only its last value in variants()
            # while still multiplying the variant count
            raise ValueError(f"grid key {key!r} was already added")
        _replace_path(self.base, key, vals[0])  # the path must exist
        self.keys.append(key)
        self.vals.append(list(vals))
        self.shorthands.append(shorthand or _shorthand(key))
        return self

    def variants(self) -> List[Dict[str, Any]]:
        return [dict(zip(self.keys, combo))
                for combo in itertools.product(*self.vals)]

    def variant_name(self, variant: Dict[str, Any]) -> str:
        parts = [self.name]
        for key, vals, sh in zip(self.keys, self.vals, self.shorthands):
            if len(vals) == 1:  # constant axes don't decorate the name
                continue
            parts.append(f"{sh}{variant[key]}")
        return "_".join(str(p) for p in parts)

    def variant_configs(self) -> Iterator[Tuple[str, NLBACConfig]]:
        for variant in self.variants():
            cfg = self.base
            for key, val in variant.items():
                cfg = _replace_path(cfg, key, val)
            yield self.variant_name(variant), cfg

    def run_all(self, run_fn: Optional[Callable] = None,
                output_dir: str = "grid_output", device="cuda",
                **train_kwargs):
        """Run every variant in this process: through ``run_fn(cfg,
        output_dir=..., **train_kwargs)`` when given, else the port's
        ``train`` on ``device``. Returns {variant name: result}."""
        from nlbac_tpu_torch.train.cli import train
        results = {}
        for name, cfg in self.variant_configs():
            out = os.path.join(output_dir, name)
            print(f"=== grid variant {name} -> {out}")
            if run_fn is not None:
                results[name] = run_fn(cfg, output_dir=out, **train_kwargs)
            else:
                results[name] = train(cfg, output_dir=out, quiet=True,
                                      device=device, **train_kwargs)
        return results

    def print_table(self) -> str:
        lines = [f"ExperimentGrid [{self.name}]", "=" * 40]
        for key, vals in zip(self.keys, self.vals):
            lines.append(f"{key:<40} {vals}")
        lines.append(f"variants: {len(self.variants())}")
        s = "\n".join(lines)
        print(s)
        return s
