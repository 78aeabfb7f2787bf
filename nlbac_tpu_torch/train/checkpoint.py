"""Checkpoints (port of ``nlbac_tpu/train/checkpoint.py``).

- ``save_model_weights`` / ``load_model_weights``: the reference's
  weights-only file layout (``actor.pkl``, ``critic.pkl`` as
  ``{'q1','q2'}``, ``lyapunov.pkl``, ``node_model.pkl``, and
  ``barrier.pkl`` for the learned-barrier family), each a pickle of
  numpy arrays in the JAX package's ``(in, out)`` layout, written
  atomically. The JAX package's ``load_model_weights`` and ``nlbac-eval``
  read them.
- ``save_checkpoint`` / ``restore_checkpoint``: the full training state in
  the port's own ``.npz`` (numpy arrays only, loaded with
  ``allow_pickle=False``): every parameter and target, every Adam state,
  the Lagrangian state, the host-side update counter, both replays with
  their host-side cursors and counts (the valid rows only), the
  ``torch.Generator`` state, ``total_steps`` and ``i_episode``. Restore
  writes into a state, replays and generator built from the config, and
  checks every array against them first, so a resumed run continues
  bit for bit.

The save is synchronous; an asynchronous writer is queued in ROADMAP.md.
"""

from __future__ import annotations

import io
import os
import pickle
from typing import Dict, Tuple

import numpy as np
import torch

from nlbac_tpu_torch.agent.state import OPT_GROUPS, TrainState
from nlbac_tpu_torch.constraints.common import LagrangianState
from nlbac_tpu_torch.interop import TARGETS, TRAINED, to_numpy
from nlbac_tpu_torch.replay import Replay
from nlbac_tpu_torch.tree import tree_leaves

FORMAT = "nlbac_tpu_torch.checkpoint/1"
WEIGHT_FILES = {"actor.pkl": "policy", "critic.pkl": "critic",
                "lyapunov.pkl": "lyap", "node_model.pkl": "node"}
BARRIER_FILE = "barrier.pkl"
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


def save_model_weights(output_dir: str, ts: TrainState,
                       include_barrier: bool = False) -> None:
    """Weights-only files in the reference's layout; ``barrier.pkl`` too
    with ``include_barrier`` (the learned-barrier family)."""
    os.makedirs(output_dir, exist_ok=True)
    for name, field in _weight_files(include_barrier).items():
        _write_atomic(os.path.join(output_dir, name),
                      pickle.dumps(to_numpy(getattr(ts, field))))


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
        _copy_leaves(name, tree_leaves(getattr(ts, field)),
                     tree_leaves(tree))
    return ts


def save_checkpoint(path: str, ts: TrainState, rl_replay: Replay,
                    node_replay: Replay, gen: torch.Generator,
                    total_steps: int, i_episode: int) -> None:
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
    for name, rep in zip(REPLAYS, (rl_replay, node_replay)):
        # rows at and past `size` are never written while size < capacity
        arrays[f"{name}.data"] = to_numpy(rep.data[:rep.size])
        arrays[f"{name}.cursor"] = np.array(
            [rep.position, rep.size, rep.total], np.int64)
    arrays["gen"] = gen.get_state().numpy()
    arrays["counters"] = np.array([ts.updates, total_steps, i_episode],
                                  np.int64)
    arrays["format"] = np.frombuffer(FORMAT.encode(), np.uint8)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    _write_atomic(path, buf.getvalue())


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


def restore_checkpoint(path: str, ts: TrainState, rl_replay: Replay,
                       node_replay: Replay, gen: torch.Generator
                       ) -> Tuple[int, int]:
    """Restore a checkpoint into ``ts``, the replays and ``gen`` (built
    from the run's config, which they are checked against); returns
    ``(total_steps, i_episode)``."""
    with np.load(path, allow_pickle=False) as z:
        if "format" not in z or bytes(z["format"]).decode() != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} checkpoint")
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
        for name, rep in zip(REPLAYS, (rl_replay, node_replay)):
            _restore_replay(name, z, rep)
        gen.set_state(torch.from_numpy(z["gen"].copy()))
        updates, total_steps, i_episode = (int(v) for v in z["counters"])
    ts.updates = updates
    return total_steps, i_episode
