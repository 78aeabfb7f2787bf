"""Host-loop training mode (port of ``nlbac_tpu/train/host_loop.py``): the
data plane on the host, the updates on the device.

For host-side environments (``envs/host_adapter.HostEnvAdapter``, or a
preset behind ``envs/host_shim.as_host_env``): the env steps on the host,
the RL replay is the native ring of ``runtime_native.HostReplay``
(memcpy pushes, xorshift sampling, seeded from the run's seed), and the
NODE replay lives on the device, so the 32768-row fit batch is gathered
there, inside the fit-due branch of ``update_presampled``.

Each env step, in this order:

1. push the previous transition's NODE row into the device replay (none
   on an episode's first step);
2. run the previous step's supervisor ``post_step``, then this step's
   ``pre_action``;
3. once the RL ring holds more than a batch, ``updates_per_step`` x
   ``update_presampled`` on rows sampled from the ring on the host;
4. ``select_action``;
5. one blocking read of the action and the backup flag, then the env
   step on the host and the pushes: a transition skips the RL ring while
   the backup controller acts, but its NODE row always goes to the device
   replay (at the next step, or in the flush at the episode's end).

The obs, the previous NODE row and the sampled (U, B, width) RL rows go to
the device together in one non-blocking copy from pinned memory; the
action fetch is the step's only blocking read. The final step's
``post_step`` is dropped: the next episode starts a fresh supervisor.

Random streams are torch Generators, not the JAX package's ``fold_in``
keys, so a run matches the JAX host loop statistically, episode by
episode, not draw for draw.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from nlbac_tpu_torch import replay as replay_lib
from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.constraints import uses_barrier
from nlbac_tpu_torch.envs.base import StepOut
from nlbac_tpu_torch.nn import DEFAULT_SQUASH
from nlbac_tpu_torch.runtime_native import HostReplay
from nlbac_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    host_checkpoint_arrays,
    restore_host_checkpoint,
    save_model_weights,
)
from nlbac_tpu_torch.train.logging import warn_short
from nlbac_tpu_torch.train.supervisor import (
    init_supervisor,
    post_step,
    pre_action,
)

LOSS_KEYS = ("qf1_loss", "qf2_loss", "lf_loss", "policy_loss", "alpha_loss",
             "alpha", "node_loss", "rho", "lam_max")


class HostRings:
    """The native RL ring and the packed-record layout (the layout of the
    device replays, ``replay.make_layout``). The NODE replay is on the
    device; ``train_host_env`` publishes it as ``node_replay``."""

    def __init__(self, cfg: NLBACConfig, spec, seed: int = 0):
        self.layout = replay_lib.make_layout(spec.obs_dim, spec.action_dim,
                                             spec.lyap_dim)
        self.width = sum(w for _, _, w in self.layout)
        self.rl = HostReplay(cfg.replay.capacity, self.width, seed=seed)
        self.node_replay = None

    def pack(self, record: dict) -> np.ndarray:
        return np.concatenate([np.asarray(record[name], np.float32)
                               .reshape(w) for name, _, w in self.layout])


def train_host_env(cfg: NLBACConfig, adapter, episodes: Optional[int] = None,
                   seed: Optional[int] = None, logger=None,
                   quiet: bool = True, on_episode_end=None, sink=None,
                   weights_dir: Optional[str] = None,
                   checkpoint_path: Optional[str] = None,
                   resume_path: Optional[str] = None, device="cuda",
                   squash: str = DEFAULT_SQUASH) -> tuple:
    """Train against a ``HostEnvAdapter``; returns ``(ts,
    per_episode_rows)``.

    - ``weights_dir``: the reference-layout weight files, written at the
      ``episodes // save_every_fraction`` cadence and at the last episode;
    - ``checkpoint_path``: the full state (``host_checkpoint_arrays``'
      archive: the train state, the native ring with its sampler state,
      the device NODE replay, both generators, the counters), written on
      a background thread at the same cadence; ``resume_path`` restores
      one and continues bit for bit (an env without a generator of its
      own has its resets replayed instead, as the JAX package does);
    - ``sink``: a ``MetricsSink`` given the reference's per-episode dict;
    - ``on_episode_end(i_episode, ts, row)``: called after each episode;
    - ``squash``: the policy's tanh (``make_agent``'s), recorded beside
      the weights and in the checkpoint.
    """
    if cfg.supervisor.kind != "none" and not cfg.constraint.use_backup:
        raise ValueError(
            f"supervisor.kind={cfg.supervisor.kind!r} requires "
            "constraint.use_backup=True: the backup controller it would "
            "engage is never trained or sampled")
    scfg, ncfg, sup_cfg = cfg.sac, cfg.node, cfg.supervisor
    if scfg.updates_per_step < 1:
        raise ValueError(
            f"updates_per_step must be >= 1 (got {scfg.updates_per_step})")
    device = resolve_device(device)
    agent = make_agent(cfg, device, env_override=adapter, squash=squash)
    seed = cfg.run.seed if seed is None else seed
    episodes = cfg.run.max_episodes if episodes is None else episodes
    max_steps = cfg.env.max_episode_steps
    dt = cfg.env.dt
    U, B = scfg.updates_per_step, scfg.batch_size
    spec = adapter.SPEC
    obs_dim, lyap_dim = spec.obs_dim, spec.lyap_dim
    loss_keys = LOSS_KEYS + (("barrier_td_loss",)
                             if uses_barrier(cfg.constraint.kind) else ())

    gen = torch.Generator(device).manual_seed(seed)
    ts = create_train_state(cfg, gen, device)
    rings = HostRings(cfg, spec, seed=seed)
    node_replay = replay_lib.create(cfg.replay.node_capacity, obs_dim,
                                    spec.action_dim, lyap_dim, device)
    env_gen = getattr(adapter.env, "generator", None)
    # the step's host-to-device rows: [obs | reached of the previous
    # step], the previous NODE row, then the U * B sampled RL rows
    stage = torch.zeros((2 + U * B, rings.width), dtype=torch.float32,
                        pin_memory=device.type == "cuda")
    stage_np = stage.numpy()

    def to_device(n_rows):
        if device.type == "cpu":
            return stage[:n_rows].clone()
        # the previous step's copy has finished: its action fetch waited
        # for the stream
        return stage[:n_rows].to(device, non_blocking=True)

    total_steps = start_episode = 0
    if resume_path is not None:
        total_steps, ep0 = restore_host_checkpoint(
            resume_path, ts, rings.rl, node_replay, gen, env_gen, squash)
        start_episode = ep0 + 1
        if env_gen is None:
            # each completed episode consumed one reset
            for _ in range(start_episode):
                adapter.host_reset()
    ckpt_writer = AsyncCheckpointer() if checkpoint_path is not None \
        else None
    save_every = max(1, episodes // cfg.run.save_every_fraction)
    history: List[dict] = []
    try:
        for i_episode in range(start_episode, episodes):
            t_ep = time.perf_counter()
            shorts = torch.zeros((), dtype=torch.int64, device=device)
            obs = np.array(adapter.host_reset(), np.float32)
            ep_reward = ep_viol = ep_cost = ep_reached = 0.0
            ep_steps = ep_backup_steps = 0
            goal_met = done = False
            last_train = None
            sup = init_supervisor(sup_cfg, device)
            # the previous step's (reached, ep_steps, packed NODE row)
            prev = None
            start_backup = i_episode >= sup_cfg.enable_after_episodes
            while not done:
                train = rings.rl.size > B
                stage_np[0, :obs_dim] = obs
                if prev is not None:
                    stage_np[0, obs_dim], _, stage_np[1] = prev
                if train:
                    rings.rl.sample(U * B, out=stage_np[2:])
                rows = to_device(2 + U * B if train else 2)

                # 1. the previous transition's NODE row
                if prev is not None:
                    replay_lib.push_row(node_replay, rows[1])
                # 2. the supervisor: the previous step's post_step, then
                # this step's pre_action
                if prev is not None and sup_cfg.kind != "none":
                    rec = replay_lib.unpack_rows(rings.layout, rows[1])
                    zero = torch.zeros((), device=device)
                    out_prev = StepOut(
                        obs=rec["next_obs"], reward=zero, constraint=zero,
                        lyap_t=torch.zeros_like(rec["lyap_t"]),
                        lyap_t1=rec["lyap_t1"], barrier_signal=zero,
                        done=zero.bool(), goal_met=zero.bool(),
                        reached=rows[0, obs_dim], num_violations=zero,
                        safety_cost=zero, viol_breakdown=zero.expand(4),
                        cost_breakdown=zero.expand(4))
                    sup = post_step(sup_cfg, sup, rec["obs"], out_prev,
                                    prev[1], start_backup)
                use_backup_d, sup = pre_action(sup_cfg, sup, start_backup)
                # 3. the updates, gated as len(memory) > batch_size
                if train:
                    for j in range(U):
                        batch = replay_lib.unpack_rows(
                            rings.layout, rows[2 + j * B:2 + (j + 1) * B])
                        ts, last_train = agent.update_presampled(
                            ts, batch, node_replay, gen, i_episode)
                        shorts = shorts + last_train["short_integrations"]
                # 4. the action
                action_d = agent.select_action(
                    ts, rows[0, :obs_dim], gen,
                    total_steps < scfg.start_steps, use_backup_d)
                # the step's one blocking read: the action and the flag
                fetched = torch.cat([action_d.detach(),
                                     use_backup_d.reshape(1).float()]
                                    ).cpu().numpy()
                action, use_backup = fetched[:-1], bool(fetched[-1])

                (next_obs, reward, constraint, lyap_t, lyap_t1, barrier,
                 done_env, gm, reached, viol, cost) = \
                    adapter.host_step(action)
                ep_steps += 1
                total_steps += 1
                at_limit = ep_steps >= max_steps
                done = bool(done_env) or at_limit
                mask = 1.0 if at_limit else float(not bool(done_env))
                t = (ep_steps - 1) * dt
                rec = {"obs": obs, "action": action, "reward": reward,
                       "constraint": constraint, "lyap_t": lyap_t,
                       "lyap_t1": lyap_t1, "barrier_signal": barrier,
                       "next_obs": next_obs, "mask": mask, "t": t,
                       "next_t": t + dt}
                if not use_backup:
                    rings.rl.push(rings.pack(rec))
                if ncfg.reference_time_labels:  # the NODE row one dt later
                    node_row = rings.pack(dict(rec, t=t + dt,
                                               next_t=t + dt + dt))
                else:
                    node_row = rings.pack(rec)
                prev = (float(reached), ep_steps, node_row)
                ep_backup_steps += int(use_backup)
                ep_reward += float(reward)
                ep_viol += float(viol)
                ep_cost += float(cost)
                ep_reached += float(reached)
                goal_met = goal_met or bool(gm)
                obs = np.array(next_obs, np.float32)  # no alias of the env's

            # the final pending NODE row
            replay_lib.push_row(node_replay,
                                torch.from_numpy(prev[2]).to(device))
            rings.node_replay = node_replay

            row = {"Episode": i_episode, "episode_steps": ep_steps,
                   "reward_train": ep_reward, "cost_train": ep_viol,
                   "safety_cost_train": ep_cost,
                   "goal_met": float(goal_met), "reached": ep_reached,
                   "updates": ts.updates, "backup_steps": ep_backup_steps}
            # every loss column from the first row on (0 before the first
            # update), read with the short-integration count in one go;
            # the JAX package's columns come in sorted order after an
            # update (its dict fetch sorts them), in loss_keys' before
            values = [shorts.float()]
            if last_train is not None:
                values += [last_train[k].float() for k in sorted(loss_keys)]
            values = torch.stack(values).tolist()
            if last_train is not None:
                row.update(zip(sorted(loss_keys), values[1:]))
            else:
                row.update((k, 0.0) for k in loss_keys)
            warn_short(i_episode, values[0])
            history.append(dict(row, wall_s=time.perf_counter() - t_ep))
            if logger is not None:
                logger.store(**row)
                for k in row:
                    logger.log_tabular(k)
                logger.dump_tabular()
            elif not quiet:
                print(f"host ep {i_episode}: reward {ep_reward:.2f} "
                      f"steps {ep_steps} updates {ts.updates}")
            if sink is not None:
                wb = {"Episode Reward": ep_reward,
                      "Episode Length": ep_steps,
                      "Episode Safety Cost": ep_cost,
                      "Episode Number of Safety Violations": ep_viol,
                      "Cumulated Number of steps": total_steps}
                if cfg.env.name == "cars":
                    wb["Episode Number of reaching destination"] = \
                        ep_reached
                sink.log(wb)
            if (i_episode % save_every == 0
                    or i_episode == episodes - 1):
                if weights_dir is not None:
                    save_model_weights(weights_dir, ts,
                                       include_barrier=uses_barrier(
                                           cfg.constraint.kind),
                                       squash=squash)
                if ckpt_writer is not None:
                    ckpt_writer.save(checkpoint_path, host_checkpoint_arrays(
                        ts, rings.rl, node_replay, gen, env_gen, total_steps,
                        i_episode, squash))
            if on_episode_end is not None:
                on_episode_end(i_episode, ts, row)
    finally:
        if ckpt_writer is not None:
            ckpt_writer.wait()
    return ts, history
