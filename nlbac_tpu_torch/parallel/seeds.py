"""Seed-parallel training, ``--n_seeds`` (port of
``nlbac_tpu/parallel/mesh.py:139-273``, ``make_async_seed_runner``).

N independent seeds, seed i on device ``i % n_devices``, each drawing
from a generator seeded ``base_seed + i`` exactly as a single-seed
``train()`` does, so that it reproduces its standalone run. The episode
loop reads the device once a step and its Python holds the host, so the
seeds run in worker processes (spawned), at most one per CPU core, each
holding the seeds ``i % n_workers == w`` and running them one after
another; the states stay in the workers. (One host thread and CUDA
stream per seed in one process would share one interpreter lock, which
the Python of every step holds.)

With ``dp``/``tp`` each seed trains on a group of ranks (``grids``), the
group's seeds one after another.

A worker (``_serve``) holds an object it starts and asks by request
name: here a worker's seeds (``_Seeds``), in ``parallel/lockstep.py`` a
lockstep shard.
"""

from __future__ import annotations

import os
import traceback
from collections import deque
from concurrent.futures import Future
from typing import List, Optional, Sequence

import torch
import torch.multiprocessing as mp

from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.agent.state import OPT_GROUPS
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.interop import TARGETS, TRAINED
from nlbac_tpu_torch.nn import DEFAULT_SQUASH
from nlbac_tpu_torch.ops import node_kernel
from nlbac_tpu_torch.parallel.runners import make_parallel_runner
from nlbac_tpu_torch.parallel.tp import gather_state_tp
from nlbac_tpu_torch.train.aot import cached_episode_runner
from nlbac_tpu_torch.train.checkpoint import save_model_weights
from nlbac_tpu_torch.train.driver import create_replays, episode_to_host
from nlbac_tpu_torch.tree import tree_leaves


def _new_seed(cfg: NLBACConfig, seed: int, device) -> list:
    """``[ts, rl_replay, node_replay, gen, total_steps]`` of ``seed``, made
    as a single-seed ``train()`` makes them."""
    gen = torch.Generator(device).manual_seed(seed)
    ts = create_train_state(cfg, gen, device)
    rl, node = create_replays(cfg, device)
    return [ts, rl, node, gen, 0]


def _run_episode(run, st: list, i_episode: int) -> dict:
    """One episode of a seed's state ``st`` (in place); its metrics as host
    numbers, with the update count and the K1 launches made in it
    (``kernel_launches``, as the kernel's wrapper counted them; a worker
    or a rank runs one episode at a time)."""
    before = node_kernel.launch_counts["node_euler"]
    ts, rl, node, gen, total = st
    ts, rl, node, m, total = run(ts, rl, node, gen, i_episode, total)
    st[0], st[1], st[2], st[4] = ts, rl, node, total
    host = episode_to_host(m)
    host["updates"] = ts.updates
    host["kernel_launches"] = node_kernel.launch_counts["node_euler"] - before
    return host


def state_arrays(ts) -> dict:
    """Every parameter, target, Adam moment (per optimizer group, of the
    parameters that have them) and the Lagrangian state of a whole state,
    as numpy arrays in ``tree_leaves`` order, with the update count."""
    out = {name: [t.detach().cpu().numpy()
                  for t in tree_leaves(getattr(ts, name))]
           for name in TRAINED + TARGETS}
    for group, field in OPT_GROUPS.items():
        state = ts.opt[group].state
        out[f"adam/{group}"] = [
            (state[p]["exp_avg"].cpu().numpy(),
             state[p]["exp_avg_sq"].cpu().numpy())
            for p in tree_leaves(getattr(ts, field)) if p in state]
    out["lag"] = [t.cpu().numpy() for t in ts.lag]
    out["updates"] = ts.updates
    return out


def _done(value) -> Future:
    f = Future()
    f.set_result(value)
    return f


class SeedStepper:
    """``step_fn(states, i_episode, block=True) -> (states, futures)`` of
    ``make_async_seed_runner``: future i gives seed i's episode metrics
    (None for a seed of another group). ``save_weights(states, i, path,
    include_barrier)`` writes seed i's weight files as ``train()`` does,
    ``close()`` ends the workers."""

    def __call__(self, states, i_episode: int, block: bool = True):
        futures = self._episodes(states, i_episode)
        if block:
            for f in futures:
                if f is not None:
                    f.result()
        return states, futures

    def close(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Worker processes
# ---------------------------------------------------------------------------

class _Seeds:
    """A worker's seeds of ``--n_seeds`` (pairs ``(i, seed)``), made as a
    single-seed ``train()`` makes them and run one after another: what
    ``_serve`` holds and asks."""

    def __init__(self, cfg, seeds, squash):
        self.cfg, self.seeds, self.squash = cfg, seeds, squash

    def start(self, dev) -> None:
        self.states = {i: _new_seed(self.cfg, seed, dev)
                       for i, seed in self.seeds}
        ts, rl, node, gen, total = next(iter(self.states.values()))
        self.run = cached_episode_runner(self.cfg,
                                         (ts, rl, node, gen, 0, total),
                                         squash=self.squash)

    def episode(self, i_episode: int) -> dict:
        return {i: _run_episode(self.run, st, i_episode)
                for i, st in self.states.items()}

    def save(self, i, path, include_barrier) -> None:
        save_model_weights(path, self.states[i][0], include_barrier,
                           self.squash)

    def state(self, i):
        ts, rl, node, _, total = self.states[i]
        return (state_arrays(ts), rl.data.cpu().numpy(),
                node.data.cpu().numpy(), total)


def _serve(conn, holder, device: str, threads: int) -> None:
    """A worker process: starts ``holder`` on ``device`` (its seeds; the
    reply holds what ``holder.start`` returns), then answers the parent's
    requests in order: ``close``, or the name of one of ``holder``'s
    methods (``episode``, ``save``, ``state``) with its arguments."""
    try:
        torch.set_num_threads(threads)
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        conn.send(("ok", holder.start(dev)))
    except Exception:  # the worker's boundary: the parent raises it
        conn.send(("error", traceback.format_exc()))
        return
    while True:
        request, *args = conn.recv()
        if request == "close":
            conn.send(("ok", None))
            return
        try:
            conn.send(("ok", getattr(holder, request)(*args)))
        except Exception:  # the worker's boundary: the parent raises it
            conn.send(("error", traceback.format_exc()))


class _Reply:
    """A reply a worker owes, read from its pipe when asked for (replies
    come in the order of the requests)."""

    def __init__(self, worker):
        self._worker, self._ready, self._value = worker, False, None

    def result(self):
        while not self._ready:
            self._worker.read_one()
        return self._value


class _SeedReply:
    """Seed i's part of a worker's episode reply (a future's interface)."""

    def __init__(self, reply: _Reply, i: int):
        self._reply, self._i = reply, i

    def result(self):
        return self._reply.result()[self._i]


class _Process:
    """A spawned worker serving ``holder`` (``_serve``) on ``device``."""

    def __init__(self, ctx, holder, device, threads):
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_serve, daemon=True,
                                args=(child, holder, str(device), threads))
        self.proc.start()
        child.close()
        self.pending = deque([_Reply(self)])  # the start-up reply

    def request(self, *msg) -> _Reply:
        self.conn.send(msg)
        reply = _Reply(self)
        self.pending.append(reply)
        return reply

    def read_one(self) -> None:
        try:
            status, value = self.conn.recv()
        except EOFError:
            raise RuntimeError(f"seed worker {self.proc.pid} died "
                               f"(exit code {self.proc.exitcode})") from None
        reply = self.pending.popleft()
        if status != "ok":
            raise RuntimeError(f"seed worker failed:\n{value}")
        reply._ready, reply._value = True, value


class _ProcessStepper(SeedStepper):
    def __init__(self, cfg, devices, n_seeds, n_workers, squash):
        self._cfg, self._devices, self._squash = cfg, devices, squash
        self._n_seeds, self._n_workers = n_seeds, n_workers
        self._procs: List[_Process] = []

    def init(self, base_seed: int):
        ctx = mp.get_context("spawn")
        threads = max(1, _cores() // self._n_workers)
        for w in range(self._n_workers):
            seeds = [(i, base_seed + i)
                     for i in range(w, self._n_seeds, self._n_workers)]
            device = self._devices[w % len(self._devices)]
            self._procs.append(_Process(
                ctx, _Seeds(self._cfg, seeds, self._squash), device,
                threads))
        for p in self._procs:
            p.pending[0].result()
        return list(range(self._n_seeds))

    def _worker(self, i: int) -> _Process:
        return self._procs[i % self._n_workers]

    def _episodes(self, states, i_episode):
        replies = [p.request("episode", i_episode) for p in self._procs]
        return [_SeedReply(replies[i % self._n_workers], i) for i in states]

    def save_weights(self, states, i, path, include_barrier):
        self._worker(i).request("save", i, path, include_barrier).result()

    def fetch(self, i: int):
        """Seed i's ``(state_arrays(ts), rl replay rows, node replay rows,
        total_steps)`` on the host, for a check."""
        return self._worker(i).request("state", i).result()

    def close(self) -> None:
        close_workers(self._procs)
        self._procs = []


def close_workers(procs: Sequence[_Process]) -> None:
    """End the workers: a ``close`` request to each live one, then a join
    (killed after 30 s)."""
    for p in procs:
        if p.proc.is_alive():
            try:
                p.request("close").result()
            except (RuntimeError, OSError):
                pass
        p.proc.join(timeout=30)
        if p.proc.is_alive():
            p.proc.kill()


def _cores() -> int:
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


# ---------------------------------------------------------------------------
# Seeds over groups of dp x tp ranks
# ---------------------------------------------------------------------------

class _GroupStepper(SeedStepper):
    def __init__(self, cfg, n_seeds, grids, device, squash):
        self._cfg, self._n_seeds, self._squash = cfg, n_seeds, squash
        self._n_groups = len(grids)
        mine = [g for g, grid in enumerate(grids) if grid is not None]
        if len(mine) != 1:
            raise ValueError("this rank must belong to exactly one seed "
                             "group")
        self._group, self.grid = mine[0], grids[mine[0]]
        self._device = device
        self._place, self._run = make_parallel_runner(cfg, self.grid, device,
                                                      squash)

    def init(self, base_seed: int):
        return [list(self._place(tuple(
            _new_seed(self._cfg, base_seed + i, self._device))))
            if i % self._n_groups == self._group else None
            for i in range(self._n_seeds)]

    def _episodes(self, states, i_episode):
        return [None if st is None else
                _done(_run_episode(self._run, st, i_episode))
                for st in states]

    def save_weights(self, states, i, path, include_barrier):
        """A collective of seed i's group under tp; its first rank
        writes."""
        ts = states[i][0]
        if self.grid.tp > 1:
            ts = gather_state_tp(ts)
        if self.grid.is_root and path is not None:
            save_model_weights(path, ts, include_barrier, self._squash)


def _default_devices():
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [resolve_device("cuda")]


def make_async_seed_runner(cfg: NLBACConfig, devices=None,
                           n_seeds: Optional[int] = None, dp: int = 1,
                           tp: int = 1, grids: Optional[Sequence] = None,
                           squash: str = DEFAULT_SQUASH):
    """Seed-parallel training: ``(init_fn, step_fn)``.

    ``init_fn(base_seed)`` makes every seed's state, seed i from
    ``torch.Generator(device).manual_seed(base_seed + i)`` used as in a
    single-seed ``train()``, and returns the states: the seed indices
    (the states stay in the worker processes; ``step_fn.fetch(i)`` copies
    one out), or under dp/tp groups this rank's list of ``[ts,
    rl_replay, node_replay, gen, total_steps]`` (None for another group's
    seed). ``step_fn(states, i_episode, block=True)`` runs one episode of
    every seed and returns ``(states, futures)``: future i gives seed i's
    metrics as host numbers (``train.driver.episode_to_host``, plus
    ``updates`` and ``kernel_launches``). With ``block=False`` it returns
    as soon as the episodes are under way, so the caller can process the
    last episode's metrics meanwhile; a seed's next request waits for its
    current one.

    ``devices`` (default: every card; the CPU when named) take the seeds
    round robin. With ``dp``/``tp`` > 1, ``grids`` is ``make_grids``' list
    for this rank and ``devices`` its one device: seed i trains on group
    ``i % len(grids)``, this rank running its group's seeds one after
    another (the group's collectives go in one order on every rank).
    ``squash`` is every seed's policy tanh (``make_agent``'s)."""
    if dp > 1 or tp > 1:
        if not grids:
            raise ValueError("dp/tp seed groups need this rank's grids "
                             "(parallel.make_grids)")
        device = torch.device(devices[0]) if devices else \
            _default_devices()[0]
        n = len(grids) if n_seeds is None else n_seeds
        stepper = _GroupStepper(cfg, n, grids, device, squash)
        return stepper.init, stepper
    devices = [torch.device(d) for d in (devices or _default_devices())]
    n_seeds = len(devices) if n_seeds is None else n_seeds
    # at most a process per core, a multiple of the device count so that
    # seed i stays on device i % n_devices
    per = max(1, _cores() // len(devices)) * len(devices)
    stepper = _ProcessStepper(cfg, devices, n_seeds, min(n_seeds, per),
                              squash)
    return stepper.init, stepper
