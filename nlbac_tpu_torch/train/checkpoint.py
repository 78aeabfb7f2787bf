"""Checkpoints (port of ``nlbac_tpu/train/checkpoint.py``).

- ``save_model_weights`` / ``load_model_weights``: the reference's
  weights-only file layout (``actor.pkl``, ``critic.pkl`` as
  ``{'q1','q2'}`` whatever the state's twin-Q layout, ``lyapunov.pkl``,
  ``node_model.pkl``, and
  ``barrier.pkl`` for the learned-barrier family), each a pickle of
  numpy arrays in the JAX package's ``(in, out)`` layout, written
  atomically. The JAX package's ``load_model_weights`` and ``nlbac-eval``
  read them. The policy's squash (``make_agent(..., squash=...)``) is
  recorded beside them in ``squash.json``, which ``weights_squash`` reads
  (evaluation and export follow it; a directory without one was trained
  under ``torch.tanh``).
- ``checkpoint_arrays`` / ``restore_checkpoint``: the full training state
  in the port's own ``.npz`` (numpy arrays only, loaded with
  ``allow_pickle=False``): every parameter and target, every Adam state,
  the Lagrangian state, the host-side update counter, both replays with
  their host-side cursors and counts (the valid rows only), the
  ``torch.Generator`` state, ``total_steps`` and ``i_episode``. Restore
  writes into a state, replays and generator built from the config, and
  checks every array against them first (and the twin-Q layout, which
  the archive's ``extra`` records), so a resumed run continues bit for
  bit.
- ``host_checkpoint_arrays`` / ``restore_host_checkpoint``: the same for
  the host loop (``train/host_loop.py``), with the native RL ring's
  snapshot (its valid rows, cursor and sampler state) in place of the
  device RL replay and the host env's generator beside the trainer's.
  The archive's ``extra`` records ``mode`` (``fused`` or ``host_loop``),
  and each restore refuses the other mode's file; it records the policy's
  ``squash`` too (an older archive's is ``torch``), and each restore
  refuses a run of another squash.
- ``AsyncCheckpointer``: writes either mode's arrays as one archive on a
  background thread; the ``*_arrays`` functions take the host snapshot
  before they return. ``write_checkpoint`` writes them in the caller's
  thread.
"""

from __future__ import annotations

import io
import json
import os
import pickle
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from nlbac_tpu_torch.agent.state import OPT_GROUPS, TrainState
from nlbac_tpu_torch.constraints.common import LagrangianState
from nlbac_tpu_torch.interop import TARGETS, TRAINED, to_numpy
from nlbac_tpu_torch.nn import DEFAULT_SQUASH, twin_q_unstack
from nlbac_tpu_torch.replay import Replay
from nlbac_tpu_torch.tree import tree_leaves

FORMAT = "nlbac_tpu_torch.checkpoint/1"
WEIGHT_FILES = {"actor.pkl": "policy", "critic.pkl": "critic",
                "lyapunov.pkl": "lyap", "node_model.pkl": "node"}
BARRIER_FILE = "barrier.pkl"
SQUASH_FILE = "squash.json"
# the squash of an archive or weights directory that records none: every
# save records its squash, and those that did not were trained under
# torch.tanh
UNRECORDED_SQUASH = "torch"
REPLAYS = ("rl_replay", "node_replay")


def _write_atomic(path: str, blob: bytes) -> None:
    """Write ``blob`` to ``path`` through a temporary file and a rename, so
    an interrupted write never leaves a half-written file in its place."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def _weight_files(include_barrier: bool) -> dict:
    if include_barrier:
        return {**WEIGHT_FILES, BARRIER_FILE: "barrier"}
    return WEIGHT_FILES


def _weights(ts: TrainState, field: str):
    """A weight file's tree: the critic always in the reference's
    ``{'q1','q2'}`` layout (views of a stacked critic's leaves, see
    ``nlbac_tpu_torch.experimental.stack_twin_q_state``)."""
    tree = getattr(ts, field)
    return twin_q_unstack(tree) if field == "critic" else tree


def save_model_weights(output_dir: str, ts: TrainState,
                       include_barrier: bool = False,
                       squash: str = DEFAULT_SQUASH) -> None:
    """Weights-only files in the reference's layout; ``barrier.pkl`` too
    with ``include_barrier`` (the learned-barrier family); ``squash.json``,
    the policy's ``squash``."""
    os.makedirs(output_dir, exist_ok=True)
    for name, field in _weight_files(include_barrier).items():
        _write_atomic(os.path.join(output_dir, name),
                      pickle.dumps(to_numpy(_weights(ts, field))))
    _write_atomic(os.path.join(output_dir, SQUASH_FILE),
                  json.dumps({"squash": squash}).encode())


def weights_squash(output_dir: str) -> str:
    """The squash that the weights in ``output_dir`` were trained under
    (``torch`` where no record is beside them)."""
    record = os.path.join(output_dir, SQUASH_FILE)
    if not os.path.exists(record):
        return UNRECORDED_SQUASH
    with open(record) as f:
        return json.load(f)["squash"]


def _copy_leaves(what: str, dst, src) -> None:
    """Copy the arrays ``src`` into the tensors ``dst`` in place, after
    checking that their shapes match."""
    if len(dst) != len(src):
        raise ValueError(f"{what}: {len(src)} arrays, expected {len(dst)}")
    for i, (d, s) in enumerate(zip(dst, src)):
        if tuple(d.shape) != tuple(np.shape(s)):
            raise ValueError(f"{what}[{i}]: shape {np.shape(s)}, expected "
                             f"{tuple(d.shape)} (was the config changed "
                             "since saving?)")
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(torch.as_tensor(np.asarray(s, np.float32)))


def load_model_weights(output_dir: str, ts: TrainState,
                       include_barrier: bool = False) -> TrainState:
    """Load weights-only files (trusted paths only: they are pickles) into
    ``ts``'s policy, critic, Lyapunov and NODE parameters, in place; with
    ``include_barrier``, the barrier's too when ``barrier.pkl`` exists."""
    for name, field in _weight_files(include_barrier).items():
        path = os.path.join(output_dir, name)
        if name == BARRIER_FILE and not os.path.exists(path):
            continue
        with open(path, "rb") as f:
            tree = pickle.load(f)
        _copy_leaves(name, tree_leaves(_weights(ts, field)),
                     tree_leaves(tree))
    return ts


def _state_arrays(ts: TrainState) -> Dict[str, np.ndarray]:
    """Every parameter, target, Adam state and the Lagrangian state, as
    fresh host arrays."""
    arrays: Dict[str, np.ndarray] = {}
    for field in TRAINED + TARGETS:
        for i, leaf in enumerate(tree_leaves(getattr(ts, field))):
            arrays[f"ts.{field}.{i}"] = to_numpy(leaf)
    for group, field in OPT_GROUPS.items():
        state = ts.opt[group].state
        for i, p in enumerate(tree_leaves(getattr(ts, field))):
            st = state.get(p)
            arrays[f"opt.{group}.step.{i}"] = np.float32(
                float(st["step"]) if st else 0.0)
            for key in ("exp_avg", "exp_avg_sq"):
                arrays[f"opt.{group}.{key}.{i}"] = (
                    to_numpy(st[key]) if st
                    else np.zeros(p.shape, np.float32))
    for f in LagrangianState._fields:
        arrays[f"lag.{f}"] = to_numpy(getattr(ts.lag, f))
    return arrays


def _replay_arrays(name: str, rep: Replay) -> Dict[str, np.ndarray]:
    # rows at and past `size` are never written while size < capacity
    return {f"{name}.data": to_numpy(rep.data[:rep.size]),
            f"{name}.cursor": np.array([rep.position, rep.size, rep.total],
                                       np.int64)}


def _tail_arrays(ts: TrainState, gen: torch.Generator, total_steps: int,
                 i_episode: int, extra: dict) -> Dict[str, np.ndarray]:
    extra = {**extra, "twin_q": _twin_q_layout(ts)}
    return {"gen": gen.get_state().numpy(),
            "counters": np.array([ts.updates, total_steps, i_episode],
                                 np.int64),
            "format": np.frombuffer(FORMAT.encode(), np.uint8),
            "extra": np.frombuffer(json.dumps(extra).encode(), np.uint8)}


def checkpoint_arrays(ts: TrainState, rl_replay: Replay, node_replay: Replay,
                      gen: torch.Generator, total_steps: int,
                      i_episode: int, squash: str = DEFAULT_SQUASH
                      ) -> Dict[str, np.ndarray]:
    """The training state as numpy arrays, copied to new host memory;
    ``squash`` is the policy's, recorded in ``extra``."""
    arrays = _state_arrays(ts)
    for name, rep in zip(REPLAYS, (rl_replay, node_replay)):
        arrays.update(_replay_arrays(name, rep))
    arrays.update(_tail_arrays(ts, gen, total_steps, i_episode,
                               {"mode": "fused", "squash": squash}))
    return arrays


def _twin_q_layout(ts: TrainState) -> str:
    return "plain" if "q1" in ts.critic else "stacked"


def write_checkpoint(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``arrays`` as one ``.npz``, atomically."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _write_atomic(path, buf.getvalue())


class AsyncCheckpointer:
    """Writes checkpoint archives on a background thread, at most one at a
    time (a new ``save`` waits for the last). The caller passes arrays it
    has already copied to the host (``checkpoint_arrays``,
    ``host_checkpoint_arrays``: fresh buffers, filled before they return),
    so the writer never reads a parameter that the optimizers update in
    place. ``wait`` joins the write and re-raises its failure."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, path: str, arrays: Dict[str, np.ndarray]) -> None:
        self.wait()

        def write():
            try:
                write_checkpoint(path, arrays)
            except Exception as e:  # noqa: BLE001 - re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError(
                f"background checkpoint write failed: {err!r}") from err


def _restore_replay(name: str, z, rep: Replay) -> None:
    data = z[f"{name}.data"]
    position, size, total = (int(v) for v in z[f"{name}.cursor"])
    capacity, width = rep.data.shape
    if (data.ndim != 2 or data.shape[1] != width or data.shape[0] != size
            or not 0 <= size <= capacity or not 0 <= position < capacity
            or total < size or position != total % capacity):
        raise ValueError(
            f"checkpoint {name}: {data.shape} rows with cursor "
            f"(position {position}, size {size}, total {total}) do not fit "
            f"a ({capacity}, {width}) replay (was the config changed since "
            "saving?)")
    with torch.no_grad():
        rep.data.zero_()
        rep.data[:size].copy_(torch.from_numpy(data))
    rep.position, rep.size, rep.total = position, size, total


def _mode(z, path: str) -> str:
    if "format" not in z or bytes(z["format"]).decode() != FORMAT:
        raise ValueError(f"{path} is not a {FORMAT} checkpoint")
    return json.loads(bytes(z["extra"]).decode())["mode"]


def checkpoint_squash(z) -> str:
    """The policy's squash that an open archive ``z`` records (``torch``
    for an archive written before it was recorded)."""
    return json.loads(bytes(z["extra"]).decode()).get("squash",
                                                       UNRECORDED_SQUASH)


def _check_squash(z, path: str, squash: str) -> None:
    saved = checkpoint_squash(z)
    if saved != squash:
        raise ValueError(f"{path} was trained with --squash {saved}; "
                         f"resume it with --squash {saved}, not {squash}")


def _restore_state(z, ts: TrainState) -> None:
    # an archive written before the layout was recorded holds the plain one
    saved = json.loads(bytes(z["extra"]).decode()).get("twin_q", "plain")
    if saved != _twin_q_layout(ts):
        raise ValueError(
            f"the checkpoint holds the {saved} twin-Q layout and the state "
            f"the {_twin_q_layout(ts)} one (restore a stacked checkpoint "
            "into a state made by experimental.stack_twin_q_state)")
    for field in TRAINED + TARGETS:
        leaves = tree_leaves(getattr(ts, field))
        _copy_leaves(f"checkpoint ts.{field}", leaves,
                     [z[f"ts.{field}.{i}"] for i in range(len(leaves))])
    for group, field in OPT_GROUPS.items():
        params = tree_leaves(getattr(ts, field))
        opt = ts.opt[group]
        for i, p in enumerate(params):
            moments = [z[f"opt.{group}.{k}.{i}"]
                       for k in ("exp_avg", "exp_avg_sq")]
            for m in moments:
                if m.shape != tuple(p.shape):
                    raise ValueError(
                        f"checkpoint opt.{group}[{i}]: shape {m.shape}, "
                        f"expected {tuple(p.shape)}")
            opt.state[p] = {
                "step": torch.tensor(float(z[f"opt.{group}.step.{i}"]),
                                     dtype=torch.float32),
                "exp_avg": torch.tensor(moments[0], device=p.device),
                "exp_avg_sq": torch.tensor(moments[1], device=p.device),
            }
    lag = {}
    for f in LagrangianState._fields:
        want = getattr(ts.lag, f)
        got = z[f"lag.{f}"]
        if got.shape != tuple(want.shape):
            raise ValueError(f"checkpoint lag.{f}: shape {got.shape}, "
                             f"expected {tuple(want.shape)}")
        lag[f] = torch.tensor(got, device=want.device)
    ts.lag = LagrangianState(**lag)


def _restore_tail(z, ts: TrainState, gen: torch.Generator
                  ) -> Tuple[int, int]:
    gen.set_state(torch.from_numpy(z["gen"].copy()))
    updates, total_steps, i_episode = (int(v) for v in z["counters"])
    ts.updates = updates
    return total_steps, i_episode


def restore_checkpoint(path: str, ts: TrainState, rl_replay: Replay,
                       node_replay: Replay, gen: torch.Generator,
                       squash: str = DEFAULT_SQUASH) -> Tuple[int, int]:
    """Restore a checkpoint into ``ts``, the replays and ``gen`` (built
    from the run's config, which they are checked against) for a run
    under the policy's ``squash`` (the archive's must be the same);
    returns ``(total_steps, i_episode)``."""
    with np.load(path, allow_pickle=False) as z:
        if _mode(z, path) != "fused":
            raise ValueError(f"{path} is a host-loop checkpoint; resume it "
                             "with --host_loop")
        _check_squash(z, path, squash)
        _restore_state(z, ts)
        for name, rep in zip(REPLAYS, (rl_replay, node_replay)):
            _restore_replay(name, z, rep)
        return _restore_tail(z, ts, gen)


def host_checkpoint_arrays(ts: TrainState, ring, node_replay: Replay,
                           gen: torch.Generator,
                           env_gen: Optional[torch.Generator],
                           total_steps: int, i_episode: int,
                           squash: str = DEFAULT_SQUASH
                           ) -> Dict[str, np.ndarray]:
    """The host loop's training state as fresh host arrays: ``ring`` is
    the native RL ring (``runtime_native.HostReplay``; its valid rows,
    cursor and sampler state), ``env_gen`` the host env's generator (or
    None); ``squash`` as ``checkpoint_arrays``'."""
    arrays = _state_arrays(ts)
    data, meta = ring.snapshot()
    arrays["rl_ring.data"] = data[:int(meta[1])].copy()
    arrays["rl_ring.meta"] = meta
    arrays.update(_replay_arrays("node_replay", node_replay))
    if env_gen is not None:
        arrays["env_gen"] = env_gen.get_state().numpy()
    arrays.update(_tail_arrays(ts, gen, total_steps, i_episode,
                               {"mode": "host_loop", "squash": squash}))
    return arrays


def restore_host_checkpoint(path: str, ts: TrainState, ring,
                            node_replay: Replay, gen: torch.Generator,
                            env_gen: Optional[torch.Generator],
                            squash: str = DEFAULT_SQUASH) -> Tuple[int, int]:
    """Restore a host-loop checkpoint into ``ts``, the native ring (in
    place), the NODE replay and both generators, for a run under
    ``squash``; returns ``(total_steps, i_episode)``."""
    with np.load(path, allow_pickle=False) as z:
        if _mode(z, path) != "host_loop":
            raise ValueError(f"{path} is not a host-loop checkpoint; resume "
                             "it without --host_loop")
        _check_squash(z, path, squash)
        if ("env_gen" in z) != (env_gen is not None):
            raise ValueError(f"{path}: the host env's generator state is "
                             f"{'in' if 'env_gen' in z else 'not in'} the "
                             "checkpoint but the env "
                             f"{'has none' if env_gen is None else 'has one'}")
        _restore_state(z, ts)
        rows, meta = z["rl_ring.data"], z["rl_ring.meta"]
        if rows.ndim != 2 or rows.shape[1] != ring.record_size or \
                rows.shape[0] > ring.capacity:
            raise ValueError(f"checkpoint rl_ring: {rows.shape} rows do not "
                             f"fit a ({ring.capacity}, {ring.record_size}) "
                             "ring (was the config changed since saving?)")
        data = np.zeros((ring.capacity, ring.record_size), np.float32)
        data[:rows.shape[0]] = rows
        ring.restore(data, meta)
        _restore_replay("node_replay", z, node_replay)
        if env_gen is not None:
            env_gen.set_state(torch.from_numpy(z["env_gen"].copy()))
        return _restore_tail(z, ts, gen)
