"""The port's start-up path (``nlbac_tpu_torch.train.aot``) on the CPU: the
runner ``cached_episode_runner`` returns runs episodes bit for bit as
``make_episode_runner``'s (as JAX's ``tests/test_aot.py`` holds its cached
program to the plain jit); it loads the kernel libraries of exactly the
configs whose episode launches K1 on the card, raises when one cannot be
built, and refuses a cache directory."""

import dataclasses

import pytest
import torch

from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.ops import node_kernel
from nlbac_tpu_torch.parallel import state_arrays
from nlbac_tpu_torch.train import aot
from nlbac_tpu_torch.train.driver import (
    create_replays,
    episode_to_host,
    make_episode_runner,
)


def tiny_cfg():
    cfg = tconfig.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=12),
        sac=dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=8,
                                updates_per_step=1, start_steps=4),
        node=dataclasses.replace(cfg.node, hidden_dim=8, f_hidden_layers=1,
                                 g_hidden_layers=1, max_batch=8,
                                 update_interval=2),
        replay=tconfig.ReplayConfig(capacity=64, node_capacity=64))


def fresh(cfg):
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(cfg, "cpu")
    return ts, rl, node, gen


def test_cached_runner_matches_make_episode_runner():
    """Two episodes through each runner from the same seed: the metrics,
    the whole state and both replays are equal bit for bit."""
    cfg = tiny_cfg()
    out = []
    for cached in (False, True):
        ts, rl, node, gen = fresh(cfg)
        run = (aot.cached_episode_runner(cfg, (ts, rl, node, gen, 0, 0))
               if cached else make_episode_runner(cfg, "cpu"))
        total, metrics = 0, []
        for ep in range(2):
            ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
            metrics.append(episode_to_host(m))
        out.append((metrics, state_arrays(ts), rl.data, node.data, total))
    (m0, s0, rl0, node0, t0), (m1, s1, rl1, node1, t1) = out
    assert m0 == m1 and t0 == t1 and s0["updates"] == s1["updates"] > 0
    for key in s0:
        if key != "updates":
            flat0 = [a for x in s0[key]
                     for a in (x if isinstance(x, tuple) else (x,))]
            flat1 = [a for x in s1[key]
                     for a in (x if isinstance(x, tuple) else (x,))]
            assert all((a == b).all() for a, b in zip(flat0, flat1)), key
    assert torch.equal(rl0, rl1) and torch.equal(node0, node1)


def test_kernels_loaded_and_a_failed_build_raises(monkeypatch):
    """K1's library is loaded for a card run whose NODE steps through it
    (the float32 control-affine Euler step), for no other config and
    never on the CPU; a build that fails raises (no fallback); a cache
    directory is refused."""
    cfg = tiny_cfg()
    node = cfg.node
    assert aot.episode_kernels(cfg, "cuda") == ["node_euler"]
    assert aot.episode_kernels(cfg, "cpu") == []
    for other in (dataclasses.replace(node, compute_dtype="bfloat16"),
                  dataclasses.replace(node, solver="dopri5"),
                  tconfig.get_config("cars").node):
        assert aot.episode_kernels(
            dataclasses.replace(cfg, node=other), "cuda") == []

    def failed_build(verbose=False):
        raise RuntimeError("nvcc failed (1)")

    monkeypatch.setattr(node_kernel, "_lib", None)
    monkeypatch.setattr(node_kernel, "build", failed_build)
    monkeypatch.setattr(aot, "episode_kernels",
                        lambda cfg, device: ["node_euler"])
    args = (None, *fresh(cfg)[1:3], None, 0, 0)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        aot.cached_episode_runner(cfg, args)
    with pytest.raises(ValueError, match="no cache directory"):
        aot.cached_episode_runner(cfg, args, cache_dir="/nonexistent")
