"""Perf levers kept out of every product path (port of
``nlbac_tpu/experimental.py``).

Each function reproduces a perf experiment of the JAX package. None is
reachable from the config, the CLI or the checkpoints: the default
builders in ``agent/update.py`` and ``train/driver.py`` run the
reference's path. Do not wire one into a product path without a fresh
interleaved A/B on the card showing a win of more than 5% (the JAX
package's own rule).

- **Stored stacked twin-Q** (``stack_twin_q_state``): both Q-nets' layer
  weights as one leaf per layer with a leading k=2 axis, one batched
  product per layer in place of two MLP applies (``nn.critics``).
- **Decoupled policy/TD updates** (``make_decoupled_agent``): the policy
  losses read the critic, Lyapunov net, barrier and NODE as they were
  before the update stepped them, so the TD and policy steps share no
  data dependency.
- **Fused multi-update RL gather** (``fused_gather_update_step``): one
  (updates_per_step * B)-row replay gather per env step in place of one
  per update.

The JAX package's own A/Bs of them (its ``experimental.py``: 0.970x,
0.978x and noise) ran where the episode is one fused XLA loop. The port
is bound by its Python stream of small launches instead, so
``chip_smoke.py`` times each lever's update block against the default
block in one interleaved call (the median of 30 blocks of 2 unicycle
updates at full width). On one NVIDIA H100 80GB HBM3 at 700 W the
stacked, decoupled and fused blocks took 0.994, 1.019 and 0.975 times the
default block's 36.28 ms, and 1.030, 1.153 and 1.040 times its 37.51 ms
in an earlier call: the spread between calls is wider than any gap, and
none comes near a 5% win.

The fused gather's batches are those of the default path given the same
index draws. The port draws them from one sequential ``torch.Generator``,
where the default path's update 0 draws its noise between update 0's and
update 1's indices, so the fused draw reorders the stream and whole
trajectories differ from the default path's (JAX's split keys keep them
bit-identical); ``ROADMAP.md`` Queue 3 lists it.
"""

from __future__ import annotations

import dataclasses

import torch

from nlbac_tpu_torch.agent.state import (
    TrainState,
    learning_rates,
    make_optimizer,
    trainable,
)
from nlbac_tpu_torch.agent.update import make_agent
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.nn import SeedAdam, twin_q_stack
from nlbac_tpu_torch.replay import buffer as replay_buffer
from nlbac_tpu_torch.train.driver import make_episode_runner
from nlbac_tpu_torch.tree import tree_leaves


def stack_twin_q_state(cfg: NLBACConfig, ts: TrainState) -> TrainState:
    """A TrainState with the twin-Q params (and target) in the stored
    stacked layout; the values are those of the plain layout
    (``twin_q_stack`` stacks the same leaves). The critic's Adam is made
    anew over the new leaves, so call this on a fresh state (as the A/B
    does), not mid-run. ``twin_q_apply`` dispatches on the layout; the
    weight files hold the reference's ``{'q1','q2'}`` layout
    (``train.checkpoint.save_model_weights``).

    A state stacked over seeds (``agent.state.stack_states``) takes the
    layout seed by seed, as ``jax.vmap`` of the reference's function
    does: its critic's leaves become (S, 2, in, out) and (S, 2, out), and
    its critic's ``SeedAdam`` is made anew (zero moments, every seed at
    step 0)."""
    with torch.no_grad():
        critic = trainable(twin_q_stack(ts.critic))
        critic_target = twin_q_stack(ts.critic_target)
    if ts.seeds is None:
        opt = make_optimizer(cfg, "critic", critic)
    else:
        opt = SeedAdam(tree_leaves(critic), learning_rates(cfg)["critic"])
    return dataclasses.replace(ts, critic=critic,
                               critic_target=critic_target,
                               opt={**ts.opt, "critic": opt})


def make_decoupled_agent(cfg: NLBACConfig, device="cuda",
                         env_override=None):
    """An agent whose policy and backup-policy losses read the function
    approximators from before the update (one-update-stale critics, a
    standard SAC variation; the reference steps the critic, then takes the
    policy loss at the new critic: UNI/sac_cbf_clf/sac_cbf_clf.py
    update_parameters)."""
    return make_agent(cfg, device, env_override=env_override,
                      _decoupled_updates=True)


def make_decoupled_episode_runner(cfg: NLBACConfig, device="cuda",
                                  env_override=None):
    """An episode runner whose update block uses the decoupled agent."""
    return make_episode_runner(
        cfg, device, env_override=env_override,
        agent=make_decoupled_agent(cfg, device, env_override=env_override))


def fused_gather_update_step(cfg: NLBACConfig):
    """An ``_update_step`` hook for ``make_episode_runner``: draw every
    update's RL rows in ONE gather per env step (the buffer is not
    written between the unrolled updates), then feed each update its
    slice through ``agent.update_presampled``. For a run of one (a
    data-parallel agent takes its rank's rows, not a whole batch)."""
    scfg = cfg.sac
    if scfg.updates_per_step <= 1:
        raise ValueError("fused gather needs updates_per_step > 1 "
                         "(there is nothing to fuse)")

    def update_step(agent, c, gen, i_episode):
        B, n = scfg.batch_size, scfg.updates_per_step
        rows = c.rl_replay.data[
            replay_buffer.sample_indices(c.rl_replay, gen, n * B)]
        ts, shorts = c.ts, 0
        for i in range(n):
            batch = replay_buffer.unpack_rows(c.rl_replay.layout,
                                              rows[i * B:(i + 1) * B])
            ts, train_m = agent.update_presampled(ts, batch, c.node_replay,
                                                  gen, i_episode)
            shorts = shorts + train_m["short_integrations"]
        return ts, {**train_m, "short_integrations": shorts}

    return update_step
