"""Minimal functional MLP with Xavier-uniform init (port of
``nlbac_tpu/nn/mlp.py``).

Params are ``{"w": [(in, out) tensors], "b": [(out,) tensors]}``, the JAX
package's layout, so a layer is ``x @ w + b``."""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence

import torch


def xavier_uniform(gen: torch.Generator, shape, gain: float = 1.0,
                   device=None, dtype=torch.float32) -> torch.Tensor:
    """U(-a, a) with a = gain * sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[0], shape[1]
    a = gain * math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(tuple(shape), generator=gen, device=device, dtype=dtype)
    return u * (2.0 * a) - a


def mlp_init(gen: torch.Generator, sizes: Sequence[int], device=None,
             dtype=torch.float32):
    """Initialize an MLP with layer widths ``sizes`` = [in, h1, ..., out]."""
    n = len(sizes) - 1
    ws = [xavier_uniform(gen, (sizes[i], sizes[i + 1]), device=device,
                         dtype=dtype) for i in range(n)]
    bs = [torch.zeros((sizes[i + 1],), device=device, dtype=dtype)
          for i in range(n)]
    return {"w": ws, "b": bs}


def mlp_apply(params, x: torch.Tensor, *,
              activation: Callable = torch.relu,
              final_activation: Optional[Callable] = None,
              compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """ReLU between layers, linear (or ``final_activation``) output."""
    ws, bs = params["w"], params["b"]
    orig_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    n = len(ws)
    for i in range(n):
        w, b = ws[i], bs[i]
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        x = x @ w + b
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    if compute_dtype is not None:
        x = x.to(orig_dtype)
    return x


def mlp_sizes(in_dim: int, hidden: int, depth: int, out_dim: int) -> List[int]:
    """[in, hidden * depth, out] layer-width helper."""
    return [in_dim] + [hidden] * depth + [out_dim]
