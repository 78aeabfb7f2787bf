"""The lockstep seed runner (port of ``nlbac_tpu/parallel/mesh.py:95-136``,
``make_seed_parallel_runner``).

JAX's runner is ``jax.vmap`` of the episode program over a seed axis:
every seed's episode runs in one XLA program, the batched ``while_loop``
runs until every seed is done and freezes a finished seed's carry by a
select, and every ``lax.cond`` becomes a select on a per-seed predicate.
Here the seed axis is written out. One process on one card holds N seeds
stacked (``agent.state.stack_states``, ``replay.SeedReplay``), and one
Python episode loop, ``train/driver.py``'s step for step, issues each
launch once for every seed: a layer is one batched product, the
control-affine NODE's Euler step one seed-batched K1 launch (each of
PVTOL's three chained calls, the learned barrier's one call, the fit),
the env step one ``torch.func.vmap`` of the env's one-seed step.

- All seeds share ``i_episode``; each keeps its own step total, update
  counter, replay cursors and sizes, supervisor, multipliers and Adam
  state.
- The loop runs while any seed runs. A finished seed makes no update, no
  push and no draw, and its state, rings, generator and metrics stay as
  they were at its last step.
- Every gate is decided per seed on the host: the update gate (``size >
  batch_size``), the warm-up (``total < start_steps``), and inside the
  update the fit, the ascent, the backup branch and the target update
  (``agent/update.py``'s note). The running seeds share the episode's
  step count, so the time limit and the supervisor's ring slot stay host
  integers.
- A step reads the device once, for every seed's ``done`` and backup
  flag together.
- Each seed resets from its own generator, through ``reset_curriculum``
  where the run has a spawn curriculum (``train/driver.py``'s
  ``curriculum_kwargs``), and steps with the run's kill terms
  (``build_step_kwargs``).
- Seed i is made as ``parallel/seeds.py::_new_seed`` makes seed
  ``base_seed + i`` (its own ``torch.Generator``), and each draw site
  draws seed i's share from seed i's generator with the one-seed shape,
  so seed i follows its standalone run (``--n_seeds``' seed i, or
  ``train()`` with that seed) up to float32 rounding: a batched product
  need not round as the one-seed product does. JAX derives its seeds'
  keys with ``split(PRNGKey(base_seed), n)`` instead; threefry and
  Philox never match anyway (ROADMAP.md Queue 3).

It trains every preset, and envs registered with their builders, under
every NODE solver: K1 where ``nn.uses_euler_kernel`` routes the field to
it, the plain field on stacked weights otherwise (the ``mlp`` field of
cars and the quadrotor, a bf16 or multi-step Euler NODE), and under
``--node_solver dopri5`` (either ``adaptive_impl``) the adaptive solver
with each seed's own step control: its own error norm, step, accept
decisions and trial count, the adjoint's backward solve included, as
``jax.vmap`` gives each seed its own solve (``ode.solve_adaptive``'s
``seed_axis``). A registered constraint builder that declares
``SEED_AXIS`` takes every seed in one call; one that does not is called
once per seed on that seed's slices (``agent/update.py``'s
``seed_terms``; K1 then launches once per seed and call). The critic may
be in either twin-Q layout (``nn.critics``; ``experimental.
stack_twin_q_state`` takes a stacked state seed by seed). A seed-stacked
state in a dp gang or under the decoupled agent raises, by decision, as
JAX's runner has neither. The runner has no ``--host_loop`` form.

Several devices. JAX's runner places the seed axis of every leaf on the
mesh's ``seed`` axis: D devices hold contiguous blocks of S/D seeds, and
S must divide evenly. Given a list of D > 1 devices, this runner shards
the seeds the same way: shard d holds seeds d*S/D ... (d+1)*S/D - 1 and
runs this module's one-device lockstep of them (from base seed
``base_seed + d*S/D``, so seed i still draws from ``base_seed + i``) in
its own spawned worker process on ``device[d]`` (``seeds._serve``'s
workers: every host stream feeds a card of its own, where one process
feeding D cards in turn would give each 1/D of one stream). Nothing
couples the seeds, so a seed's run does not depend on its shard: each
shard equals the one-device runner of its seed block. Devices may
repeat (two shards on one card). The difference from the one-device
form: the states stay in the workers, so ``init_fn`` and ``run_fn``
hand back host values (``ShardedSeedRunner``), and ``fetch`` copies a
seed's state out; an env or builder registered at run time is
registered again in each worker (``setup``). The runner takes a flat
list of devices, not a mesh of more than one axis: JAX's ``(seed, dp)``
mesh replicates each seed block over the dp devices and computes it on
each of them again, which gains nothing.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.multiprocessing as mp
from torch.utils._pytree import tree_flatten, tree_unflatten

from nlbac_tpu_torch import replay as replay_lib
from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.agent.state import stack_states, unstack_state
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import DEFAULT_SQUASH
from nlbac_tpu_torch.ops import node_kernel
from nlbac_tpu_torch.parallel.seeds import (
    _cores,
    _Process,
    close_workers,
    state_arrays,
)
from nlbac_tpu_torch.train.checkpoint import save_model_weights
from nlbac_tpu_torch.train.aot import _LOADERS, episode_kernels
from nlbac_tpu_torch.train.driver import (
    EpisodeMetrics,
    _f32,
    build_step_kwargs,
    create_replays,
    curriculum_kwargs,
)
from nlbac_tpu_torch.train.supervisor import (
    init_supervisor,
    post_step,
    pre_action,
)
from nlbac_tpu_torch.tree import SeedMasks, where_seeds


def _reset_seeds(env, device, gens, max_steps, i_episode, curriculum):
    """Each seed's reset from its own generator (``reset_curriculum`` with
    ``curriculum``'s kwargs where the run has one, as the one-seed driver
    resets), stacked: the state's tensors on a leading seed axis, its host
    values (the step count) shared."""
    if curriculum is None:
        pairs = [env.reset(device, gen=g, max_episode_steps=max_steps)
                 for g in gens]
    else:
        pairs = [env.reset_curriculum(device, i_episode, gen=g,
                                      max_episode_steps=max_steps,
                                      **curriculum) for g in gens]
    flats = [tree_flatten(st) for st, _ in pairs]
    spec = flats[0][1]
    leaves = []
    for vals in zip(*(f[0] for f in flats)):
        if isinstance(vals[0], torch.Tensor):
            leaves.append(torch.stack(vals))
        elif any(v != vals[0] for v in vals):
            raise ValueError(f"the seeds' env states differ in a host "
                             f"value: {vals}")
        else:
            leaves.append(vals[0])
    return tree_unflatten(leaves, spec), torch.stack([o for _, o in pairs])


def _seed_step(env, **kwargs):
    """``env.step`` over a leading seed axis: ``torch.func.vmap`` over the
    state's tensors and the action, the host values (the step count)
    passed through as the one-seed step sets them."""
    def step(state, action):
        leaves, spec = tree_flatten(state)
        is_tensor = [isinstance(v, torch.Tensor) for v in leaves]
        host = [v for v, t in zip(leaves, is_tensor) if not t]
        new_host, new_spec, new_is_tensor = [], [], []

        def one(tensors, a):
            it, hs = iter(tensors), iter(host)
            st = tree_unflatten([next(it) if t else next(hs)
                                 for t in is_tensor], spec)
            new_st, out = env.step(st, a, **kwargs)
            vals, sp = tree_flatten(new_st)
            # the one traced call's host values and structure
            new_spec[:] = [sp]
            new_is_tensor[:] = [isinstance(v, torch.Tensor) for v in vals]
            new_host[:] = [v for v in vals if not isinstance(v, torch.Tensor)]
            return [v for v in vals if isinstance(v, torch.Tensor)], out

        tensors, out = torch.func.vmap(one)(
            [v for v, t in zip(leaves, is_tensor) if t], action)
        it, hs = iter(tensors), iter(new_host)
        new_state = tree_unflatten([next(it) if t else next(hs)
                                    for t in new_is_tensor], new_spec[0])
        return new_state, out
    return step


def make_seed_parallel_runner(cfg: NLBACConfig, n_seeds: int,
                              device="cuda", prepare=None, setup=None,
                              squash: str = DEFAULT_SQUASH):
    """Build ``(init_fn, run_fn)`` for N-seed lockstep training (the
    module's note).

    On one device (a device, or a list of one):

    ``init_fn(base_seed) -> (ts, rl, node, gens, total)``: the state
    stacked over seeds, both ``SeedReplay`` rings, the seeds' generators
    (seed i ``torch.Generator(device).manual_seed(base_seed + i)``) and
    the per-seed step totals (a host list).

    ``run_fn(ts, rl, node, gens, i_episode, total) -> (ts, rl, node, gens,
    metrics, total)`` runs one episode of every seed: ``metrics`` is an
    ``EpisodeMetrics`` whose tensors carry a leading seed axis (the last
    update's ``train`` metrics per seed) and whose ``steps`` and
    ``updates_done`` are per-seed host lists; ``total`` is a host list.
    ``unstack_state(cfg, ts, i)`` gives seed i's state.

    On a list of D > 1 devices, ``n_seeds`` a multiple of D, the seeds
    run in D shards, each in a worker process: ``(runner.init, runner)``
    of a ``ShardedSeedRunner``.

    ``prepare(cfg, ts) -> ts``, where given, is applied to the stacked
    state ``init_fn`` makes (for example
    ``experimental.stack_twin_q_state``). ``setup()``, where given, is
    called before anything else, in every worker of a sharded run: where
    an env or a constraint builder registered at run time is registered
    (a registry holds what its own process registered). A sharded run
    pickles both to its workers, so they must be module-level
    functions. ``squash`` is every seed's policy tanh (``make_agent``'s),
    in every shard."""
    if isinstance(device, (list, tuple)):
        if len(device) > 1:
            runner = ShardedSeedRunner(cfg, n_seeds, device, prepare, setup,
                                       squash)
            return runner.init, runner
        device = device[0]
    if setup is not None:
        setup()
    if n_seeds < 1:
        raise ValueError(f"n_seeds must be at least 1, got {n_seeds}")
    device = resolve_device(device)
    env = get_env(cfg.env.name)
    agent = make_agent(cfg, device, squash=squash)
    scfg = cfg.sac
    dt = cfg.env.dt
    max_steps = cfg.env.max_episode_steps
    barrier_B = cfg.env.barrier_B if cfg.env.barrier_signals else 0.0
    barrier_b = cfg.env.barrier_b if cfg.env.barrier_signals else 0.0
    curriculum = curriculum_kwargs(cfg, env)
    env_step = _seed_step(env, barrier_B=barrier_B, barrier_b=barrier_b,
                          max_episode_steps=max_steps,
                          **build_step_kwargs(cfg, env))
    if cfg.supervisor.kind != "none" and not cfg.constraint.use_backup:
        raise ValueError(
            f"supervisor.kind={cfg.supervisor.kind!r} requires "
            "constraint.use_backup=True: the backup controller it would "
            "engage is never trained or sampled")
    # as cached_episode_runner: every kernel library the episode launches
    # is loaded (built where missing) before the first episode
    for name in episode_kernels(cfg, device):
        _LOADERS[name]()
    seed_mask = SeedMasks(device)

    def select(on, new, old):
        return new if all(on) else where_seeds(seed_mask(on), new, old)

    def init_fn(base_seed: int):
        gens, states = [], []
        for i in range(n_seeds):
            gen = torch.Generator(device).manual_seed(base_seed + i)
            gens.append(gen)
            states.append(create_train_state(cfg, gen, device))
        ts = stack_states(cfg, states)
        del states
        if prepare is not None:
            ts = prepare(cfg, ts)
        rings = [create_replays(cfg, device) for _ in range(n_seeds)]
        rl = replay_lib.stack_replays([r[0] for r in rings])
        node = replay_lib.stack_replays([r[1] for r in rings])
        return ts, rl, node, gens, [0] * n_seeds

    def run_fn(ts, rl, node, gens, i_episode: int, total):
        if ts.seeds != n_seeds or len(gens) != n_seeds:
            raise ValueError(f"run_fn takes the {n_seeds} seeds of "
                             f"init_fn, got {ts.seeds}")
        env_state, obs = _reset_seeds(env, device, gens, max_steps,
                                      i_episode, curriculum)
        start_backup = i_episode >= cfg.supervisor.enable_after_episodes
        sup = init_supervisor(cfg.supervisor, device, seeds=n_seeds)
        zeros = torch.zeros((n_seeds,), device=device)
        acc = {k: zeros for k in ("reward", "num_violations", "safety_cost",
                                  "reached")}
        viol = torch.zeros((n_seeds, 4), device=device)
        cost = torch.zeros((n_seeds, 4), device=device)
        goal_met = torch.zeros((n_seeds,), dtype=torch.bool, device=device)
        backup_steps = torch.zeros((n_seeds,), dtype=torch.int32,
                                   device=device)
        train_m = {k: zeros for k in METRIC_NAMES}
        shorts = torch.zeros((n_seeds,), dtype=torch.int64, device=device)
        total = list(total)
        steps = [0] * n_seeds
        updates_done = [0] * n_seeds
        running = [True] * n_seeds
        episode_steps = 0
        while any(running):
            # --- 1. gradient updates, for the seeds whose ring holds more
            # than a batch ------------------------------------------------
            upd = [r and n > scfg.batch_size
                   for r, n in zip(running, rl.size)]
            if any(upd):
                for _ in range(scfg.updates_per_step):
                    ts, m = agent.update(ts, rl, node, gens, i_episode,
                                         seeds=upd)
                    train_m = {k: select(upd, m[k], train_m[k])
                               for k in METRIC_NAMES}
                    shorts = shorts + select(
                        upd, m["short_integrations"],
                        torch.zeros_like(shorts))
                updates_done = [d + scfg.updates_per_step * int(o)
                                for d, o in zip(updates_done, upd)]

            # --- 2. action selection (+ supervisor timer bumps) -----------
            use_backup, sup = pre_action(cfg.supervisor, sup, start_backup)
            warmup = [t < scfg.start_steps for t in total]
            action = agent.select_action(ts, obs, gens, warmup, use_backup,
                                         seeds=running)

            # --- 3. env step (every seed; a finished seed's is unused) -----
            env_state, out = env_step(env_state, action)
            episode_steps += 1
            for i, r in enumerate(running):
                if r:
                    steps[i] = episode_steps
                    total[i] += 1
            if episode_steps == max_steps:
                mask = 1.0
            else:
                mask = 1.0 - out.done.to(torch.float32)

            # --- 4. the supervisor and the running seeds' accumulators -----
            sup = post_step(cfg.supervisor, sup, obs, out, episode_steps,
                            start_backup)
            run = seed_mask(running)
            acc = {k: acc[k] + torch.where(run, getattr(out, k), 0.0)
                   for k in acc}
            viol = viol + torch.where(run[:, None], out.viol_breakdown, 0.0)
            cost = cost + torch.where(run[:, None], out.cost_breakdown, 0.0)
            goal_met = goal_met | (out.goal_met & run)
            backup_steps = backup_steps + (use_backup & run).to(torch.int32)

            # --- 5. replay pushes (after the step's one device read) --------
            done, backup_on = torch.stack([out.done, use_backup]).tolist()
            t = _f32(np.float32(episode_steps - 1) * np.float32(dt))
            next_t = _f32(np.float32(t) + np.float32(dt))
            rec = replay_lib.record_from_step(obs, action, out, mask, t,
                                              next_t)
            rows = replay_lib.pack_record(rl.layout, rec, device, n_seeds)
            replay_lib.push_seed_rows(
                rl, rows, [r and not b for r, b in zip(running, backup_on)])
            if cfg.node.reference_time_labels:
                node_rec = replay_lib.record_from_step(
                    obs, action, out, mask, next_t,
                    _f32(np.float32(t) + np.float32(2.0 * dt)))
                rows = replay_lib.pack_record(node.layout, node_rec, device,
                                              n_seeds)
            replay_lib.push_seed_rows(node, rows, running)
            obs = out.obs
            running = [r and not d for r, d in zip(running, done)]

        metrics = EpisodeMetrics(
            reward=acc["reward"], steps=steps,
            num_violations=acc["num_violations"],
            safety_cost=acc["safety_cost"], reached=acc["reached"],
            goal_met=goal_met, viol_breakdown=viol, cost_breakdown=cost,
            backup_steps=backup_steps, updates_done=updates_done,
            train=train_m, short_integrations=shorts)
        return ts, rl, node, gens, metrics, total

    return init_fn, run_fn


class _Shard:
    """One shard of a sharded run, held in a worker process
    (``seeds._serve``): the one-device lockstep of ``n_seeds`` seeds from
    ``base_seed``."""

    def __init__(self, cfg, n_seeds, base_seed, prepare, setup, squash):
        self.cfg, self.n_seeds, self.base_seed = cfg, n_seeds, base_seed
        self.prepare, self.setup, self.squash = prepare, setup, squash

    def start(self, dev) -> float:
        """Make the runner and the seeds; the seconds it took."""
        t0 = time.perf_counter()
        init_fn, self.run = make_seed_parallel_runner(
            self.cfg, self.n_seeds, dev, self.prepare, self.setup,
            self.squash)
        self.carry = init_fn(self.base_seed)
        return time.perf_counter() - t0

    def episode(self, i_episode: int):
        """One episode of the shard's seeds: each seed's host metrics
        (``episode_to_host_seeds``, with its ``updates`` and the shard's
        K1 launches in the episode, ``kernel_launches``) and the step
        totals."""
        node_kernel.reset_launch_counts()  # the worker's own counts
        ts, rl, node, gens, total = self.carry
        ts, rl, node, gens, m, total = self.run(ts, rl, node, gens,
                                                i_episode, total)
        self.carry = (ts, rl, node, gens, total)
        launches = node_kernel.launch_counts["node_euler"]
        host = episode_to_host_seeds(m)
        for h, updates in zip(host, ts.updates):
            h["updates"], h["kernel_launches"] = updates, launches
        return host, total

    def save(self, j, path, include_barrier) -> None:
        save_model_weights(path, unstack_state(self.cfg, self.carry[0], j),
                           include_barrier, self.squash)

    def state(self, j):
        return seed_on_host(self.cfg, self.carry, j)


def seed_on_host(cfg: NLBACConfig, carry, i: int):
    """Seed i of the one-device runner's ``(ts, rl, node, gens, total)`` on
    the host, as ``ShardedSeedRunner.fetch`` gives it."""
    ts, rl, node, gens, total = carry

    def ring(r):  # its valid rows (those before its size) only
        return (r.data[i, :r.size[i]].cpu().numpy(), r.position[i],
                r.size[i], r.total[i])

    return (state_arrays(unstack_state(cfg, ts, i)), ring(rl), ring(node),
            total[i], gens[i].get_state().numpy())


class ShardedSeedRunner:
    """The lockstep over D > 1 devices (the module's note): shard d, in a
    spawned worker process on ``devices[d]``, holds seeds d*S/D ...
    (d+1)*S/D - 1.

    ``init(base_seed) -> total`` starts every worker (all at once) and
    makes every shard's seeds (seed i from ``base_seed + i``); ``total``
    is the per-seed step totals, a host list. ``runner(i_episode) ->
    (metrics, total)`` runs one episode of every seed: ``metrics`` is
    each seed's host metrics in seed order (``episode_to_host_seeds``'
    form, with ``updates`` and its shard's K1 launches in the episode,
    ``kernel_launches``). ``fetch(i)`` copies seed i's state out,
    ``save_weights(i, path, include_barrier)`` writes its weight files as
    ``train()`` does, ``close()`` ends the workers. A worker that fails
    ends every worker and raises its traceback in the parent."""

    def __init__(self, cfg: NLBACConfig, n_seeds: int, devices,
                 prepare=None, setup=None, squash: str = DEFAULT_SQUASH):
        n_dev = len(devices)
        if n_seeds < 1 or n_seeds % n_dev:
            raise ValueError(
                f"{n_seeds} seeds do not split evenly over {n_dev} "
                f"devices (each device holds a block of n_seeds / "
                f"{n_dev} seeds)")
        self.cfg, self.n_seeds = cfg, n_seeds
        self.prepare, self.setup, self.squash = prepare, setup, squash
        self.devices = [torch.device(d) for d in devices]
        self.per_shard = n_seeds // n_dev
        # the seeds of each shard, as JAX's NamedSharding places them
        self.shards = [list(range(d * self.per_shard,
                                  (d + 1) * self.per_shard))
                       for d in range(n_dev)]
        self.start_seconds = None  # each worker's, from init
        self._procs = []

    def _wait(self, replies):
        try:
            return [r.result() for r in replies]
        except BaseException:
            self.close()
            raise

    def init(self, base_seed: int):
        self.close()
        ctx = mp.get_context("spawn")
        threads = max(1, _cores() // len(self.devices))
        for dev, seeds in zip(self.devices, self.shards):
            shard = _Shard(self.cfg, self.per_shard, base_seed + seeds[0],
                           self.prepare, self.setup, self.squash)
            self._procs.append(_Process(ctx, shard, dev, threads))
        self.start_seconds = self._wait([p.pending[0] for p in self._procs])
        return [0] * self.n_seeds

    def _workers(self):
        if not self._procs:
            raise RuntimeError("the sharded runner has no workers (init "
                               "was not called, or it was closed)")
        return self._procs

    def _shard(self, i: int):
        """Seed i's worker and its index in that shard."""
        if not 0 <= i < self.n_seeds:
            raise IndexError(f"seed {i} of {self.n_seeds}")
        return self._workers()[i // self.per_shard], i % self.per_shard

    def __call__(self, i_episode: int):
        replies = self._wait([p.request("episode", i_episode)
                              for p in self._workers()])
        metrics = [h for host, _ in replies for h in host]
        total = [t for _, tot in replies for t in tot]
        return metrics, total

    def fetch(self, i: int):
        """Seed i's ``(state_arrays(ts), rl ring, node ring, total,
        generator state)`` on the host, each ring ``(rows, position,
        size, pushes)`` with its valid rows (the first ``size``) and the
        generator's state a numpy array."""
        proc, j = self._shard(i)
        return self._wait([proc.request("state", j)])[0]

    def save_weights(self, i: int, path, include_barrier: bool) -> None:
        proc, j = self._shard(i)
        self._wait([proc.request("save", j, path, include_barrier)])

    def close(self) -> None:
        close_workers(self._procs)
        self._procs = []


def episode_to_host_seeds(m: EpisodeMetrics) -> list:
    """Each seed's episode metrics as Python numbers (one device read), in
    ``train.driver.episode_to_host``'s form."""
    scalars = ("reward", "num_violations", "safety_cost", "reached",
               "goal_met", "backup_steps", "short_integrations")
    flat = torch.cat(
        [torch.stack([getattr(m, k).to(torch.float32) for k in scalars], 1),
         m.viol_breakdown, m.cost_breakdown,
         torch.stack([m.train[k].to(torch.float32) for k in METRIC_NAMES],
                     1)], dim=1).tolist()
    out = []
    for i, row in enumerate(flat):
        host = dict(zip(scalars, row))
        host["viol_breakdown"] = row[len(scalars):len(scalars) + 4]
        host["cost_breakdown"] = row[len(scalars) + 4:len(scalars) + 8]
        host["train"] = dict(zip(METRIC_NAMES, row[len(scalars) + 8:]))
        host["steps"] = m.steps[i]
        host["updates_done"] = m.updates_done[i]
        out.append(host)
    return out
