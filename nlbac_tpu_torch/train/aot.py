"""The episode runner's start-up path (port of ``nlbac_tpu/train/aot.py``).

The JAX package's module keeps the lowering of its fused episode program
between processes: ``jax.export`` serializes it under a key made from the
config, the code's hash and any runtime-registered extension's source,
and a later process deserializes it instead of lowering again. The port
lowers nothing: its episode is a Python loop of eager PyTorch calls. Its
compiled artifacts are the kernel libraries in ``nlbac_tpu_torch/_build/``,
each named by the hash of its source (``ops/node_kernel.py::build``), and
that name is the staleness guard JAX's key gives its program: an edited
source gets a new library.

So ``cached_episode_runner`` loads, building where it is missing, every
kernel library that the config's episode launches, then returns
``make_episode_runner(...)``: the first episode never pays an ``nvcc``
build. A failed build or load raises. JAX's falls back to a plain jit,
but here the fallback would be the plain version on the card, which the
port never takes silently.

Not ported, for want of a serialized program to key: ``_cache_key``,
``_code_hash``, ``_extension_hash`` and ``register_export_types``.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence

import torch

from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.nn import DEFAULT_SQUASH, uses_euler_kernel
from nlbac_tpu_torch.ops import node_kernel
from nlbac_tpu_torch.train.driver import make_episode_runner


# kernel -> the function that builds (where needed) and loads its library
_LOADERS = {"node_euler": node_kernel.load}


def episode_kernels(cfg: NLBACConfig, device) -> List[str]:
    """The kernels an episode of ``cfg`` on ``device`` launches: K1 on the
    card when the NODE steps through it; none on the CPU."""
    if torch.device(device).type == "cuda" and uses_euler_kernel(cfg.node):
        return ["node_euler"]
    return []


def cached_episode_runner(cfg: NLBACConfig, example_args: Sequence[Any],
                          cache_dir: str | None = None,
                          env_override=None,
                          squash: str = DEFAULT_SQUASH) -> Callable:
    """``make_episode_runner(cfg, ...)`` on the device of ``example_args``
    (the episode runner's arguments: ``(ts, rl_replay, node_replay, gen,
    i_episode, total_steps)``), with every kernel library of its episode
    loaded first. ``cache_dir`` is refused: the libraries live in
    ``_build/`` under their sources' hashes, and no program is cached
    elsewhere. ``squash`` is the policy's tanh (``make_agent``'s)."""
    if cache_dir is not None:
        raise ValueError(
            "cached_episode_runner keeps no cache directory: the kernel "
            "libraries are built into nlbac_tpu_torch/_build/, named by "
            "their sources' hashes")
    device = example_args[1].data.device
    for name in episode_kernels(cfg, device):
        _LOADERS[name]()
    return make_episode_runner(cfg, device, env_override=env_override,
                               squash=squash)
