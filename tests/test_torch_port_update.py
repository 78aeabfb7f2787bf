"""The port as a whole against the JAX package, on the CPU: config presets,
the weights carried across by ``interop``, one ``_update_core`` with the
same state, batches and Gaussian draws, a short episode, and the port's
isolation from JAX.

Tolerance of the update comparison: metrics rtol 1e-5 / atol 1e-6;
parameters, Adam moments and the Lagrangian state rtol 1e-4 / atol 1e-6.
Both sides run float32 on the CPU and differ only in summation order; the
widest gap seen is 2e-7 absolute, on first-moment entries near zero (where
the relative gap is large and meaningless, hence the absolute floor).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.ops import node_kernel

REPO = Path(__file__).resolve().parent.parent
BATCH, NODE_BATCH = 6, 8


def tiny_cfg(mod, **node_kw):
    cfg = mod.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH),
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, max_batch=NODE_BATCH,
                                 **node_kw),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def make_batch(rng, n):
    f = np.float32
    return {
        "obs": rng.normal(size=(n, 7)).astype(f),
        "action": rng.uniform([-3.5, -12], [3.5, 12], size=(n, 2)).astype(f),
        "reward": rng.normal(size=n).astype(f),
        "constraint": np.abs(rng.normal(size=n)).astype(f),
        "lyap_t": rng.normal(size=(n, 2)).astype(f),
        "lyap_t1": rng.normal(size=(n, 2)).astype(f),
        "barrier_signal": np.zeros(n, f),
        "next_obs": rng.normal(size=(n, 7)).astype(f),
        "mask": (rng.uniform(size=n) > 0.2).astype(f),
        "t": rng.uniform(size=n).astype(f),
        "next_t": rng.uniform(size=n).astype(f),
    }


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_with_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


@pytest.mark.parametrize("name", sorted(jconfig.PRESETS))
def test_config_presets_match_reference(name):
    assert tconfig.get_config(name).to_dict() == \
        jconfig.get_config(name).to_dict()


def test_interop_round_trip_is_exact():
    cfg_j = tiny_cfg(jconfig)
    ts = as_numpy(create_train_state(cfg_j, jax.random.PRNGKey(0)))
    port = from_reference(ts, tiny_cfg(tconfig), "cpu")
    assert port.updates == 0 and port.node["f"]["w"][0].requires_grad
    back = to_reference(port, ts)
    assert jax.tree.structure(back) == jax.tree.structure(ts)
    for (pa, a), (pb, b) in zip(leaves_with_paths(ts),
                                leaves_with_paths(back)):
        assert pa == pb and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b, err_msg=pa)


@pytest.fixture(scope="module")
def jax_update():
    cfg = tiny_cfg(jconfig)
    return cfg, jax.jit(make_agent(cfg).update_from_batch)


@pytest.mark.parametrize("node_fit", [True, False])
def test_update_core_matches_reference(jax_update, node_fit):
    """One update from the same state: fit gated on (update 0: NODE fit,
    multiplier ascent and the stale alpha_init all fire) and off (update 1
    after a first reference update: no fit, no ascent, Adam count 1)."""
    cfg_j, update = jax_update
    rng = np.random.default_rng(0)
    ts = create_train_state(cfg_j, jax.random.PRNGKey(0))
    if not node_fit:
        ts, _ = update(ts, make_batch(rng, BATCH),
                       make_batch(rng, NODE_BATCH), jax.random.PRNGKey(3),
                       jnp.int32(0))
    batch, node_batch = make_batch(rng, BATCH), make_batch(rng, NODE_BATCH)
    key = jax.random.PRNGKey(7)
    ts_j, m_j = update(ts, batch, node_batch, key, jnp.int32(0))

    # The reference draws from split(key, 8): [2] the TD-target sample,
    # [3] the policy-loss sample, [5] the backup-loss sample.
    keys = jax.random.split(key, 8)
    noise = {name: torch.tensor(np.asarray(
        jax.random.normal(keys[i], (BATCH, 2), jnp.float32)))
        for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    ref = as_numpy(ts)
    port = from_reference(ref, tiny_cfg(tconfig), "cpu")
    agent = t_make_agent(tiny_cfg(tconfig), "cpu")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tnb = {k: torch.tensor(v) for k, v in node_batch.items()}
    drawn = []
    port, m_t = agent.update_core(port, tb,
                                  lambda: drawn.append(1) or tnb,
                                  None, 0, noise=noise)
    assert drawn == ([1] if node_fit else [])
    assert (float(m_j["node_loss"]) > 0) == node_fit

    assert set(m_t) == set(m_j) == set(METRIC_NAMES)
    for k in METRIC_NAMES:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    expect = as_numpy(ts_j)
    got = to_reference(port, expect)
    assert int(got.updates) == int(expect.updates) == ref.updates + 1
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=pa)


def test_episode_smoke_on_cpu():
    """The port's run_episode on a tiny config: updates start after the
    batch fills, the NODE fit runs, every metric stays finite."""
    from nlbac_tpu_torch.agent import create_train_state as t_create
    from nlbac_tpu_torch.train import create_replays, make_episode_runner

    cfg = tiny_cfg(tconfig, update_interval=5)
    cfg = dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, max_episode_steps=40),
        sac=dataclasses.replace(cfg.sac, start_steps=20))
    gen = torch.Generator().manual_seed(0)
    ts = t_create(cfg, gen, "cpu")
    rl, node = create_replays(cfg, "cpu")
    run = make_episode_runner(cfg, "cpu")
    node_kernel.reset_launch_counts()
    ts, rl, node, m, total = run(ts, rl, node, gen, 0, 0)
    assert m.steps == total == 40 and rl.size == node.size == 40
    # updates run once the RL buffer holds more than a batch (step 8 on)
    assert m.updates_done == 2 * (40 - BATCH - 1) == ts.updates
    assert all(np.isfinite(float(v)) for v in m.train.values())
    assert float(m.train["node_loss"]) > 0  # update 65 is a fit (65 % 5)
    assert float(m.train["constraint_loss"]) >= 0
    assert np.isfinite(float(m.reward))
    # the CPU path never launches the CUDA kernel
    assert node_kernel.launch_counts["node_euler"] == 0
    if not torch.cuda.is_available():  # the default device is the GPU
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_episode_runner(cfg)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import nlbac_tpu_torch, nlbac_tpu_torch.interop\n"
        "import nlbac_tpu_torch.train, nlbac_tpu_torch.ops.node_kernel\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'optax',"
        " 'nlbac_tpu') or m.startswith(('jax.', 'nlbac_tpu.')))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
