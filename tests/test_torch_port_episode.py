"""A whole episode, port against JAX, on the CPU: JAX's jitted
``run_episode`` (``nlbac_tpu/train/driver.py``) against the port's
``make_episode_runner`` over one 40-step episode at the tiny widths of
``test_torch_port_update.py``, with the backup controller engaging, for
``unicycle`` and for ``nbc_unicycle`` (the learned barrier: its TD, its
target and the barrier terms of the policy loss).

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
the JAX CPU tanh. The nbc_unicycle preset runs no supervisor and so
trains no backup policy (``use_backup`` False); JAX's
``make_episode_runner`` refuses a supervisor without one, so its case
turns ``use_backup`` on: the
learned barrier's primary terms run as the preset's do, and its backup
branch runs beside them. Its updates also take the resample draws
(``split(core, 8)[4]`` for the primary terms, ``[6]`` for the backup's).

Compared: both replays row by row (every step's obs, action, reward,
mask and times, and nbc_unicycle's barrier signal; the RL ring without
the backup steps), the RL ring's size, the episode's metrics (the
training columns, ``barrier_td_loss`` among them) and the final state
(every parameter, target, Adam moment and the Lagrangian state; in the
nbc_unicycle case the barrier net, its target and their Adam moments,
which its updates move from their initial values). Tolerance, unicycle:
rtol 1e-4 / atol 1e-5, the atol times the compared array's largest entry
where that is over 1 (as ``test_torch_port_gates.py``'s saturated case:
the actions reach 11.9, the obs 2.7, the reward 4.9); the discrete flags
(steps, backup steps, updates, ring sizes, the goal flag) exactly equal.
The worst gap is 0.39 of that tolerance (the obs, late in the episode).
It grows with the episode, 0.98 at 60 steps: the two libraries' float32
summation orders in every update move the policy's actions by about 1e-5,
which the heading integrates; the same episode with every network's
initial weights one ulp up moves the port by a tenth as much, since it
perturbs once.

nbc_unicycle: rtol 1e-3 / atol 1e-4 (scaled as above), the flags exactly
equal; the worst gap is 0.22 of it (the actions; the barrier's leaves
0.015), 2.2 times the unicycle case's tolerance. The gap is not a
difference of the update: every one of the episode's 66 updates, run by
JAX's ``update_from_batch`` from the port's state, rows and key, leaves
the port's within 0.14 of the unicycle case's tolerance (both cases; the
last test). At update 46 (step 30) the update itself jumps: JAX's own
update from JAX's state and from the port's, which differ by 0.08 of the
unicycle tolerance, leave the backup policy's Adam moment 8 times that
tolerance apart; the moment then decays. Without the supervisor (the
preset's own settings) the same happens at update 39 (step 26), where one
hidden ReLU unit's pre-activation lies within float32 noise of 0 for one
of the 6 rows, on either side in the two runs, and the policy's Adam
moments move by over 500 times the tolerance; so the whole-episode
comparison runs with the supervisor, as in the unicycle case, and the
update-by-update comparison holds each update tightly.

The update-by-update comparison also runs nbc_unicycle at the preset's
own settings, the ones its band trains (no supervisor, ``use_backup``
False; the whole-episode comparisons leave this case out, for the kink
above): each of its 66 updates within 0.14 of the unicycle case's
tolerance (the policy's Adam moment), the barrier's leaves within 0.0051.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
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
# each case's (rtol, atol) for the whole episode; every update against
# JAX's from the same state at UPDATE_TOL, in these cases and in
# nbc_unicycle at the preset's own settings (OWN: no supervisor, no backup
# policy), which the whole episode's comparison leaves out
TOL = {"unicycle": (1e-4, 1e-5), "nbc_unicycle": (1e-3, 1e-4)}
UPDATE_TOL = TOL["unicycle"]
OWN = "nbc_unicycle_unsupervised"


def assert_close(got, want, err_msg, tol=UPDATE_TOL):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol[0],
                               atol=tol[1] * scale, err_msg=err_msg)


def episode_cfg(mod, case):
    cfg = mod.get_config("nbc_unicycle" if case == OWN else case)
    if case == "nbc_unicycle":
        cfg = dataclasses.replace(
            cfg, constraint=dataclasses.replace(cfg.constraint,
                                                use_backup=True),
            supervisor=mod.get_config("unicycle").supervisor)
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

    def __init__(self, cfg, key, template):
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
        # each update's (state in, RL rows, NODE rows, core key, episode,
        # state out), the states as JAX pytrees (``to_reference`` on
        # ``template``)
        self.template, self.updates = template, []

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
        if self.cfg.constraint.kind == "learned_barrier":
            noise.update({name: t(jax.random.normal(
                core[i], (BATCH, n_u), jnp.float32))[None]
                for name, i in (("resample", 4), ("backup_resample", 6))})
        batch = rows(rl_replay, keys[0], BATCH)
        node_batch = rows(node_replay, keys[1], NODE_BATCH)
        state_in = self.as_jax(ts)
        out = self.agent.update_core(ts, batch, lambda *_: node_batch, None,
                                     i_episode, noise=noise)
        self.updates.append((state_in, batch, node_batch, keys[2],
                             i_episode, self.as_jax(out[0])))
        return out

    def as_jax(self, ts):
        return jax.tree.map(np.array, to_reference(ts, self.template))

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


KEY = 5


@functools.cache
def port_episode(case):
    """The port's episode of ``case`` with JAX's draws, its agent (which
    holds every update) and the initial state as a JAX pytree."""
    cfg_t = episode_cfg(tconfig, case)
    ts0 = create_train_state(episode_cfg(jconfig, case),
                             jax.random.PRNGKey(0))
    agent = JaxDrawsAgent(cfg_t, jax.random.PRNGKey(KEY), ts0)
    port = from_reference(jax.tree.map(np.asarray, ts0), cfg_t, "cpu")
    rl_t, node_t = t_create_replays(cfg_t, "cpu")
    run_t = t_make_runner(cfg_t, "cpu", agent=agent, squash=SQUASH)
    return run_t(port, rl_t, node_t, None, 0, 0), agent, ts0


@pytest.fixture(scope="module", params=sorted(TOL, reverse=True))
def episodes(request):
    cfg_j = episode_cfg(jconfig, request.param)
    port_out, agent, ts0 = port_episode(request.param)
    rl_j, node_j = create_replays(cfg_j)
    run_j = jax.jit(make_episode_runner(cfg_j))
    jax_out = jax.tree.map(np.asarray, run_j(
        ts0, rl_j, node_j, jax.random.PRNGKey(KEY), jnp.int32(0),
        jnp.int32(0)))
    return jax_out, port_out, agent, ts0, request.param


def test_episode_engages_the_backup_controller(episodes):
    (_, rl_j, node_j, m_j, total_j), (_, rl_t, node_t, m_t, total_t), \
        agent, _, _ = episodes
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
    (_, rl_j, node_j, _, _), (_, rl_t, node_t, _, _), agent, _, preset = \
        episodes
    tol = TOL[preset]
    node_rows_j = rings(node_j, STEPS)
    node_rows_t = rings(node_t, STEPS)
    for name in node_rows_j:
        assert_close(node_rows_t[name], node_rows_j[name],
                     f"NODE ring {name}", tol)
    kept = ~np.array(agent.backups)
    rl_rows_j = rings(rl_j, int(rl_j.size))
    rl_rows_t = rings(rl_t, rl_t.size)
    for name in rl_rows_j:
        assert_close(rl_rows_t[name], rl_rows_j[name], f"RL ring {name}",
                     tol)
        # the RL ring is the NODE ring without the backup steps
        np.testing.assert_array_equal(rl_rows_t[name],
                                      node_rows_t[name][kept])


def test_episode_metrics_and_state_match_jax(episodes):
    (ts_j, _, _, m_j, _), (ts_t, _, _, m_t, _), agent, ts0, preset = \
        episodes
    tol = TOL[preset]
    assert bool(m_t.goal_met) == bool(m_j.goal_met)
    for name in ("reward", "num_violations", "safety_cost", "reached",
                 "viol_breakdown", "cost_breakdown"):
        assert_close(getattr(m_t, name), getattr(m_j, name), name, tol)
    for name, v in m_j.train.items():
        assert_close(float(m_t.train[name]), float(v), name, tol)
    got = to_reference(ts_t, ts_j)
    assert int(got.updates) == int(ts_j.updates) == m_t.updates_done
    for (pa, a), (pb, b) in zip(leaves_with_paths(ts_j),
                                leaves_with_paths(got)):
        assert pa == pb
        assert_close(b, a, pa, tol)
    if preset != "nbc_unicycle":
        return
    # nbc_unicycle: the barrier net, its target and their Adam moments
    # trained (so the comparison above holds them), barrier_td_loss > 0
    assert float(m_t.train["barrier_td_loss"]) > 0
    init = dict(leaves_with_paths(ts0))
    for part in (".barrier[", ".barrier_target[", ".opt['barrier']"):
        leaves = [(p, a) for p, a in leaves_with_paths(ts_j)
                  if p.startswith(part)]
        assert leaves and all(not np.array_equal(a, init[p])
                              for p, a in leaves), part


@pytest.mark.parametrize("case", (*sorted(TOL, reverse=True), OWN))
def test_episode_updates_match_jax_from_the_same_state(case):
    """Every update of the port's episode against JAX's
    ``update_from_batch`` from the same state, rows and core key, at the
    unicycle case's tolerance: what the whole episode's comparison holds
    update by update, where a ReLU crossed under float32 noise cannot
    reach; and so for nbc_unicycle at the preset's own settings (OWN), as
    its band trains it."""
    (_, _, _, m_t, _), agent, _ = port_episode(case)
    update = jax.jit(make_agent(episode_cfg(jconfig, case)
                                ).update_from_batch)
    assert m_t.updates_done > 0
    assert len(agent.updates) == m_t.updates_done
    for i, (state, batch, node_batch, key, i_episode, want) in enumerate(
            agent.updates):
        got, _ = update(state, {k: v.numpy() for k, v in batch.items()},
                        {k: v.numpy() for k, v in node_batch.items()}, key,
                        jnp.int32(i_episode))
        for (pa, a), (pb, b) in zip(leaves_with_paths(got),
                                    leaves_with_paths(want)):
            assert pa == pb
            assert_close(b, a, f"update {i}: {pa}")
