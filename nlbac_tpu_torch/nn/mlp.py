"""Minimal functional MLP with Xavier-uniform init (port of
``nlbac_tpu/nn/mlp.py``).

Params are ``{"w": [(in, out) tensors], "b": [(out,) tensors]}``, the JAX
package's layout, so a layer is ``x @ w + b``.

Under tensor parallelism (``parallel/tp.py``) a rank holds a shard of a
layer's weight, marked by a ``tp_shard`` attribute (a ``TPShard``):
split along the output (a column layer) or the input (a row layer).
``mlp_apply`` reads the mark and writes Megatron's collectives: the f
operator before a column layer (the identity forward, the sum of the
input's gradient backward), the g operator after a row layer (the sum
of the partial products forward, the identity backward; the row layer's
bias, held whole, is added after it) and, where a net ends on a column
layer, the gather of its output columns. Unmarked layers are whole.

Stacked over seeds (the lockstep seed runner, ``parallel/lockstep.py``),
a layer's weight is (S, in, out) and its bias (S, out), and x is (S, B,
in): each layer is one ``torch.baddbmm`` for every seed (in a
``compute_dtype`` such as bf16, a ``torch.bmm`` and the bias added after
it, so that each seed's layer rounds as its one-seed layer does).
Stacked layers take no tp mark."""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence

import torch


class TPShard(NamedTuple):
    """How a tensor-parallel rank holds a layer tensor: the dimension of
    the whole tensor it is cut along (a weight's 1 for a column layer, 0
    for a row layer; a column layer's bias 0) and the tp group's
    collectives (``parallel.mesh.Comm``)."""

    dim: int
    comm: Any


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
    """ReLU between layers, linear (or ``final_activation``) output. Layers
    marked ``tp_shard`` run tensor-parallel, and stacked layers over a
    seed axis as batched products (see the module's note)."""
    ws, bs = params["w"], params["b"]
    orig_dtype = x.dtype
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    n = len(ws)
    split = None  # the column layer whose output columns x holds
    for i in range(n):
        w, b = ws[i], bs[i]
        shard = getattr(w, "tp_shard", None)
        if compute_dtype is not None:
            w, b = w.to(compute_dtype), b.to(compute_dtype)
        if w.dim() == 3:
            if shard is not None:
                raise ValueError("a layer stacked over seeds cannot be a "
                                 "tensor-parallel shard")
            # in a low-precision compute dtype the product is rounded
            # before the bias is added, as one seed's ``x @ w + b`` rounds
            x = (torch.baddbmm(b.unsqueeze(-2), x, w) if compute_dtype is None
                 else torch.bmm(x, w) + b.unsqueeze(-2))
        elif shard is None:
            if split is not None:
                x, split = split.comm.gather(x), None
            x = x @ w + b
        elif shard.dim == 1:
            x = shard.comm.sum_bwd(x) @ w + b
            split = shard
        else:
            x = shard.comm.sum_fwd(x @ w) + b
            split = None
        if i < n - 1:
            x = activation(x)
        elif final_activation is not None:
            x = final_activation(x)
    if split is not None:
        x = split.comm.gather(x)
    if compute_dtype is not None:
        x = x.to(orig_dtype)
    return x


def mlp_sizes(in_dim: int, hidden: int, depth: int, out_dim: int) -> List[int]:
    """[in, hidden * depth, out] layer-width helper."""
    return [in_dim] + [hidden] * depth + [out_dim]
