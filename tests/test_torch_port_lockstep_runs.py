"""The lockstep seed runner (``nlbac_tpu_torch.parallel.lockstep``) over
every preset, on the CPU, against the port's own one-seed path:

(c) the runner against each seed's standalone ``make_episode_runner``
    run (generator ``base + i``) over 3 episodes, for ``cars``,
    ``pvtol``, ``nbc_unicycle``, ``nbc_pvtol`` and ``quadrotor`` (its
    kill penalty, the mix spawn curriculum and both pre-tanh
    regularizers), for the quadrotor under each curriculum mode, and for
    the unicycle with a bf16 NODE and with a two-step Euler NODE (the
    plain field, no K1);
(e) ``tests/test_parallel.py``'s assertions on JAX's runner, on the
    port's runner for each of those presets.

What the runner still refuses is tested in
``test_torch_port_lockstep.py`` (f).

Each preset runs at tiny widths with its intervals cut so that every gate
switches inside the run: the NODE fit every 5th update (none in the last
episode where the preset has a ``fit_episode_limit``), the ascent every
3rd, PVTOL's backup branch every 4th (with its separate rho), and the
supervisor from the second episode. The policy acts from the second
episode.

The curriculum modes run 2 episodes (a one-episode anneal), which reach
every branch of each mode, without the constraint's balance ratio
(``use_ratio``; the preset runs above keep it). The ratio divides the
CBF columns' mean by the CLF column's, and when a seed's CLF mean comes
near 0 it multiplies float32 rounding: from base seed 2, seed 1's policy
moments leave the tolerance below with the ratio, as they do in its
standalone run with the NODE's weights one ulp up, and stay far inside
it without; the other seeds and every other part of the state stay far
inside it either way.

Tolerances: as ``test_torch_port_lockstep.py``'s (c): steps, updates and
replay sizes equal; rewards, the last update's metrics, replay rows and
the whole state within rtol 1e-4 / atol 1e-5 (float32 rounding of the
batched products, carried through 3 episodes of training). The bf16 NODE
is held at the same tolerance: a stacked bf16 layer rounds its product
before adding the bias, as one seed's layer does (``nn/mlp.py``); with
the bias fused into the product its NODE left the tolerance.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.envs import quadrotor as t_quad
from nlbac_tpu_torch.ops import node_kernel as nk
from test_torch_port_lockstep import (
    S,
    check_seed_against_standalone,
    run_lockstep,
)

EPISODES, STEPS = 3, 24
PRESETS = ("cars", "pvtol", "nbc_unicycle", "nbc_pvtol", "quadrotor")
# the quadrotor's lockstep runs take its kill penalty (the preset's),
# a spawn curriculum and both pre-tanh regularizers
QUAD_SAC = dict(pretanh_reg=0.05, probe_pretanh_reg=0.2)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as the dopri5 tests run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def preset_cfg(preset, curriculum="mix", curriculum_episodes=2,
               **node_kw):
    """``preset`` at tiny widths, its gates cut to switch within the
    run."""
    cfg = tconfig.get_config(preset)
    env = dataclasses.replace(cfg.env, max_episode_steps=STEPS)
    sac = dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=8,
                              start_steps=STEPS)
    if preset == "quadrotor":
        env = dataclasses.replace(env, spawn_curriculum_episodes=(
                                      curriculum_episodes),
                                  spawn_curriculum_mode=curriculum,
                                  kill_attitude=1.0)
        sac = dataclasses.replace(sac, **QUAD_SAC)
    limit = cfg.node.fit_episode_limit
    node = dataclasses.replace(
        cfg.node, hidden_dim=12, f_hidden_layers=2, g_hidden_layers=2,
        mlp_hidden_layers=2, max_batch=16, update_interval=5,
        fit_episode_limit=None if limit is None else EPISODES - 2,
        **node_kw)
    constraint = dataclasses.replace(
        cfg.constraint, lambda_update_interval=3,
        backup_update_interval=min(cfg.constraint.backup_update_interval,
                                   4))
    supervisor = dataclasses.replace(
        cfg.supervisor, enable_after_episodes=1, min_steps=4, window=4,
        trap_count=2, trap_threshold=0.5, cars_backup_max_steps=6,
        cars_min_backup_steps=2, rush_backup_max_steps=5)
    return dataclasses.replace(
        cfg, env=env, sac=sac, node=node, constraint=constraint,
        supervisor=supervisor,
        replay=tconfig.ReplayConfig(capacity=40, node_capacity=50))


def check_runner(cfg, base, episodes=EPISODES):
    """S seeds in lockstep over ``episodes`` episodes, each against its
    standalone run; returns the per-episode host metrics."""
    results, ts, rl, node, gens, total = run_lockstep(cfg, base, episodes)
    assert min(ts.updates) > 0
    for i in range(S):
        check_seed_against_standalone(cfg, i, base, results, ts, rl, node,
                                      gens, total)
    return results


@pytest.mark.parametrize("preset", PRESETS)
def test_runner_matches_standalone_runs(preset):
    """Each preset's seeds over 3 episodes against their standalone runs;
    K1 launches on the CPU none (its plain version)."""
    nk.reset_launch_counts()
    check_runner(preset_cfg(preset), 5)
    assert nk.launch_counts["node_euler"] == 0


@pytest.mark.parametrize("mode", ["anneal", "mix", "mix_early"])
def test_quadrotor_curriculum_modes_match_standalone_runs(mode):
    """Each curriculum mode over a one-episode anneal and 2 episodes:
    the anneal's spawn (anneal, mix), the ground start (mix_early's
    episode 0) and the mixture's draw (mix and mix_early's episode 1),
    each seed's draws from its own generator, as its standalone run's."""
    cfg = preset_cfg("quadrotor", curriculum=mode, curriculum_episodes=1)
    cfg = dataclasses.replace(cfg, constraint=dataclasses.replace(
        cfg.constraint, use_ratio=False))
    check_runner(cfg, 2, episodes=2)


def test_quadrotor_seeds_spawn_from_their_own_draws(monkeypatch):
    """Under the mix curriculum each seed resets through
    ``reset_curriculum`` with the run's kwargs and its own generator, and
    the seeds' spawns differ."""
    calls = []
    real = t_quad.reset_curriculum

    def spy(device, i_episode, **kwargs):
        calls.append((i_episode, kwargs["gen"], kwargs["mode"],
                      kwargs["curriculum_episodes"]))
        return real(device, i_episode, **kwargs)

    monkeypatch.setattr(t_quad, "reset_curriculum", spy)
    cfg = preset_cfg("quadrotor")
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, S, "cpu")
    ts, rl, node, gens, total = init_fn(0)
    ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, 1, total)
    assert [c[0] for c in calls] == [1] * S
    assert [c[1] for c in calls] == gens
    assert {(c[2], c[3]) for c in calls} == {("mix", 2)}


@pytest.mark.parametrize("node_kw", [dict(compute_dtype="bfloat16"),
                                     dict(solver_steps=2)],
                         ids=["bf16_node", "two_euler_steps"])
def test_plain_field_nodes_match_standalone_runs(node_kw):
    """The unicycle with a NODE off K1's path (a bf16 field, two Euler
    steps): the plain field on stacked weights, each seed against its
    standalone run, no K1 launch."""
    nk.reset_launch_counts()
    check_runner(preset_cfg("unicycle", **node_kw), 7)
    assert nk.launch_counts["node_euler"] == 0


@pytest.mark.parametrize("preset", PRESETS)
def test_runner_meets_the_jax_runner_assertions(preset):
    """``tests/test_parallel.py``'s checks of JAX's runner: rewards shaped
    (S,), different seeds give different rewards, total == steps."""
    cfg = preset_cfg(preset)
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, S, "cpu")
    ts, rl, node, gens, total = init_fn(0)
    ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, 0, total)
    assert m.reward.shape == (S,)
    assert len(np.unique(np.round(m.reward.numpy(), 4))) > 1
    assert total == m.steps
