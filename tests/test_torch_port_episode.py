"""A whole episode, port against JAX, on the CPU: JAX's jitted
``run_episode`` (``nlbac_tpu/train/driver.py``) against the port's
``make_episode_runner`` over one 40-step unicycle episode at the tiny
widths of ``test_torch_port_update.py``, with the backup controller
engaging.

JAX's episode runs unchanged from a key. Its draws are re-derived outside
its loop from the same key splits and fed to the port's runner through
its ``agent=`` hook: per env step ``split(key, 4)`` gives the update key,
the action key and the step key; each of the step's ``updates_per_step``
updates takes ``split(ks[i], 3)``: the RL batch's indices (``randint``
over the ring's size at that step), the NODE batch's and the core key,
whose ``split(., 8)`` gives the standard-normal draws (as
``test_torch_port_gates.py`` does); ``select_action``'s ``split(kact,
3)`` gives the policy's and the backup policy's normal draws and the
warm-up's uniform one. The unicycle's reset draws nothing on either side.

The supervisor is the ``trap`` machine with thresholds far from any value
the episode reaches: every window counts as trapped (``trap_threshold``
1e6) and the escape distance is never reached (1e6), so from step 12 the
backup controller engages after 3 checks and hands back after 6 steps,
three times in the episode. The policy acts from step 10
(``start_steps``), so the backup's ``where`` picks the backup policy's
sample on those steps, and they miss the RL ring. The squash is ``xla``,
the JAX CPU tanh.

Compared: both replays row by row (every step's obs, action, reward,
mask and times; the RL ring without the backup steps), the RL ring's
size, the episode's metrics and the final state (every parameter, target,
Adam moment and the Lagrangian state). Tolerance: rtol 1e-4 / atol 1e-5,
the atol times the compared array's largest entry where that is over 1
(as ``test_torch_port_gates.py``'s saturated case: the actions reach 11.9,
the obs 2.7, the reward 4.9); the discrete flags (steps, backup steps,
updates, ring sizes, the goal flag) exactly equal. The worst gap is 0.39
of that tolerance (the obs, late in the episode). It grows with the
episode, 0.98 at 60 steps: the two libraries' float32 summation orders in
every update move the policy's actions by about 1e-5, which the heading
integrates; the same episode with every network's initial weights one ulp
up moves the port by a tenth as much, since it perturbs once.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state
from nlbac_tpu.train.driver import create_replays, make_episode_runner
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.envs import get_env as t_get_env
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.nn import ActionSpec, gaussian_policy_sample
from nlbac_tpu_torch.replay import unpack_rows
from nlbac_tpu_torch.train import create_replays as t_create_replays
from nlbac_tpu_torch.train import make_episode_runner as t_make_runner
from test_torch_port_update import BATCH, NODE_BATCH, leaves_with_paths

STEPS, START_STEPS, SQUASH = 40, 10, "xla"
RTOL, ATOL = 1e-4, 1e-5


def assert_close(got, want, err_msg):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=RTOL,
                               atol=ATOL * scale, err_msg=err_msg)


def episode_cfg(mod):
    cfg = mod.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=STEPS),
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH,
                                start_steps=START_STEPS),
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, max_batch=NODE_BATCH),
        supervisor=dataclasses.replace(
            cfg.supervisor, enable_after_episodes=0, window=4, min_steps=12,
            trap_threshold=1e6, trap_count=3, backup_max_steps=6,
            escape_distance_sq=1e6),
        replay=mod.ReplayConfig(capacity=128, node_capacity=128))


def t(x):
    return torch.tensor(np.asarray(x))


class JaxDrawsAgent:
    """The port's agent with JAX's draws of an episode from ``key``: its
    updates take JAX's batch indices and normal draws (``update_core`` with
    injected ``noise``), its actions JAX's normal and uniform draws."""

    def __init__(self, cfg, key):
        self.agent = t_make_agent(cfg, "cpu", squash=SQUASH)
        self.squash, self.cfg = SQUASH, cfg
        env = t_get_env(cfg.env.name)
        self.spec = ActionSpec.from_bounds(env.SPEC.action_low,
                                           env.SPEC.action_high, "cpu")
        self.low = torch.tensor(env.SPEC.action_low, dtype=torch.float32)
        self.high = torch.tensor(env.SPEC.action_high, dtype=torch.float32)
        key, _ = jax.random.split(key)  # the reset's key
        self.step_keys = []
        for _ in range(STEPS):
            key, kupd, kact, _ = jax.random.split(key, 4)
            self.step_keys.append((kupd, kact))
        self.step, self.in_block = 0, 0
        self.warmups, self.backups = [], []

    def update(self, ts, rl_replay, node_replay, gen, i_episode):
        n_u, per_step = self.cfg.action_dim, self.cfg.sac.updates_per_step
        kupd = self.step_keys[self.step][0]
        keys = jax.random.split(jax.random.split(kupd, per_step)[
            self.in_block], 3)
        self.in_block += 1

        def rows(replay, k, n):
            idx = jax.random.randint(k, (n,), 0, max(replay.size, 1))
            return unpack_rows(replay.layout, replay.data[t(idx).long()])

        core = jax.random.split(keys[2], 8)
        noise = {name: t(jax.random.normal(core[i], (BATCH, n_u),
                                           jnp.float32))
                 for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
        return self.agent.update_core(
            ts, rows(rl_replay, keys[0], BATCH),
            lambda *_: rows(node_replay, keys[1], NODE_BATCH), None,
            i_episode, noise=noise)

    def select_action(self, ts, obs, gen, warmup, use_backup):
        k1, k2, k3 = jax.random.split(self.step_keys[self.step][1], 3)
        self.step, self.in_block = self.step + 1, 0
        self.warmups.append(warmup)
        self.backups.append(bool(use_backup))
        if warmup:
            u = t(jax.random.uniform(k3, (self.cfg.action_dim,)))
            return self.low + u * (self.high - self.low)
        shape = (1, self.cfg.action_dim)
        with torch.no_grad():
            a, _, _ = gaussian_policy_sample(
                ts.policy, obs[None, :], self.spec,
                noise=t(jax.random.normal(k1, shape)), squash=SQUASH)
            a_bak, _, _ = gaussian_policy_sample(
                ts.backup_policy, obs[None, :], self.spec,
                noise=t(jax.random.normal(k2, shape)), squash=SQUASH)
            return torch.where(use_backup, a_bak, a)[0]


def rings(replay, size):
    return {name: np.asarray(v)
            for name, v in unpack_rows(replay.layout,
                                       t(replay.data[:size])).items()}


@pytest.fixture(scope="module")
def episodes():
    cfg_j, cfg_t = episode_cfg(jconfig), episode_cfg(tconfig)
    key = jax.random.PRNGKey(5)
    ts0 = create_train_state(cfg_j, jax.random.PRNGKey(0))
    rl_j, node_j = create_replays(cfg_j)
    run_j = jax.jit(make_episode_runner(cfg_j))
    jax_out = jax.tree.map(np.asarray, run_j(ts0, rl_j, node_j, key,
                                             jnp.int32(0), jnp.int32(0)))

    agent = JaxDrawsAgent(cfg_t, key)
    port = from_reference(jax.tree.map(np.asarray, ts0), cfg_t, "cpu")
    rl_t, node_t = t_create_replays(cfg_t, "cpu")
    run_t = t_make_runner(cfg_t, "cpu", agent=agent, squash=SQUASH)
    port_out = run_t(port, rl_t, node_t, None, 0, 0)
    return jax_out, port_out, agent


def test_episode_engages_the_backup_controller(episodes):
    (_, rl_j, node_j, m_j, total_j), (_, rl_t, node_t, m_t, total_t), \
        agent = episodes
    assert m_t.steps == int(m_j.steps) == int(total_j) == total_t == STEPS
    assert agent.step == STEPS
    # the backup controller engages several times, each a run of steps
    # after the policy has started acting
    on = np.array(agent.backups)
    starts = np.flatnonzero(on[1:] & ~on[:-1]) + 1
    assert len(starts) >= 2 and starts[0] >= START_STEPS, starts
    assert not any(w for w, b in zip(agent.warmups, on) if b)
    assert int(m_t.backup_steps) == int(m_j.backup_steps) == on.sum()
    assert m_t.updates_done == int(m_j.updates_done)
    assert m_t.updates_done > 0
    # the RL ring misses the backup steps, the NODE ring holds every step
    assert rl_t.size == int(rl_j.size) == STEPS - on.sum()
    assert node_t.size == int(node_j.size) == STEPS


def test_episode_replays_match_jax(episodes):
    (_, rl_j, node_j, _, _), (_, rl_t, node_t, _, _), agent = episodes
    node_rows_j = rings(node_j, STEPS)
    node_rows_t = rings(node_t, STEPS)
    for name in node_rows_j:
        assert_close(node_rows_t[name], node_rows_j[name],
                     f"NODE ring {name}")
    kept = ~np.array(agent.backups)
    rl_rows_j = rings(rl_j, int(rl_j.size))
    rl_rows_t = rings(rl_t, rl_t.size)
    for name in rl_rows_j:
        assert_close(rl_rows_t[name], rl_rows_j[name], f"RL ring {name}")
        # the RL ring is the NODE ring without the backup steps
        np.testing.assert_array_equal(rl_rows_t[name],
                                      node_rows_t[name][kept])


def test_episode_metrics_and_state_match_jax(episodes):
    (ts_j, _, _, m_j, _), (ts_t, _, _, m_t, _), _ = episodes
    assert bool(m_t.goal_met) == bool(m_j.goal_met)
    for name in ("reward", "num_violations", "safety_cost", "reached",
                 "viol_breakdown", "cost_breakdown"):
        assert_close(getattr(m_t, name), getattr(m_j, name), name)
    for name, v in m_j.train.items():
        assert_close(float(m_t.train[name]), float(v), name)
    got = to_reference(ts_t, ts_j)
    assert int(got.updates) == int(ts_j.updates) == m_t.updates_done
    for (pa, a), (pb, b) in zip(leaves_with_paths(ts_j),
                                leaves_with_paths(got)):
        assert pa == pb
        assert_close(b, a, pa)
