"""On-device replay ring buffer (port of ``nlbac_tpu/replay/buffer.py``).

One preallocated (capacity, record_width) float32 tensor on the device
holds packed rows with the JAX package's byte layout (``make_layout``),
so a row means the same in both packages. The write cursor and counts are
host integers: the driver decides each push on the host after its one
per-step read of the device, so no counter needs a device round trip.
``push`` writes in place.

``SeedReplay`` stacks S rings on a leading seed axis, (S, capacity,
width), for the lockstep seed runner: each seed keeps its own host
cursor, size and total, a push writes the rows of the seeds it is given,
and a sample draws each seed's indices from that seed's generator over
its own valid range, as ``sample`` draws them for one ring.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

FIELD_ORDER = ("obs", "action", "reward", "constraint", "lyap_t",
               "lyap_t1", "barrier_signal", "next_obs", "mask", "t",
               "next_t")
# scalar fields come back squeezed to (...,); vector fields keep their
# trailing dim even at width 1
SCALAR_FIELDS = frozenset(("reward", "constraint", "barrier_signal",
                           "mask", "t", "next_t"))


def _field_widths(obs_dim: int, action_dim: int, lyap_dim: int) -> dict:
    return {
        "obs": obs_dim, "action": action_dim, "reward": 1,
        "constraint": 1, "lyap_t": lyap_dim, "lyap_t1": lyap_dim,
        "barrier_signal": 1, "next_obs": obs_dim, "mask": 1, "t": 1,
        "next_t": 1,
    }


def make_layout(obs_dim: int, action_dim: int, lyap_dim: int
                ) -> Tuple[Tuple[str, int, int], ...]:
    """Static (name, offset, width) triples for the packed row."""
    widths = _field_widths(obs_dim, action_dim, lyap_dim)
    layout = []
    off = 0
    for name in FIELD_ORDER:
        w = widths[name]
        layout.append((name, off, w))
        off += w
    return tuple(layout)


@dataclass
class Replay:
    data: torch.Tensor  # (capacity, record_width) f32, on the device
    position: int  # next write slot
    size: int  # valid records
    total: int  # pushes ever
    layout: Tuple[Tuple[str, int, int], ...]

    def field(self, name):
        for n, off, w in self.layout:
            if n == name:
                col = self.data[:, off:off + w]
                return col[:, 0] if name in SCALAR_FIELDS else col
        raise KeyError(name)


def create(capacity: int, obs_dim: int, action_dim: int, lyap_dim: int,
           device=None) -> Replay:
    layout = make_layout(obs_dim, action_dim, lyap_dim)
    width = sum(w for _, _, w in layout)
    return Replay(data=torch.zeros((capacity, width), dtype=torch.float32,
                                   device=device),
                  position=0, size=0, total=0, layout=layout)


def pack_record(layout, record: dict, device,
                seeds: Optional[int] = None) -> torch.Tensor:
    """A record as one packed row (record_width,); with ``seeds`` = S, a
    record whose tensors carry a leading seed axis as (S, record_width)
    rows."""
    lead = () if seeds is None else (seeds,)
    parts = []
    for name, _, w in layout:
        v = record[name]
        if isinstance(v, torch.Tensor):
            parts.append(v.to(dtype=torch.float32).reshape(lead + (w,)))
        else:  # a host number: a fill, with no host-to-device copy
            parts.append(torch.full(lead + (w,), float(v),
                                    dtype=torch.float32, device=device))
    return torch.cat(parts, dim=-1)


def unpack_rows(layout, rows: torch.Tensor) -> dict:
    """Unpack packed rows (..., record_width) into a field dict."""
    out = {}
    for name, off, w in layout:
        col = rows[..., off:off + w]
        out[name] = col[..., 0] if name in SCALAR_FIELDS else col
    return out


def push(replay: Replay, record: dict, do_push: bool = True) -> Replay:
    """Write one record at the cursor, in place; ``do_push=False`` skips it
    (the RL buffer while the backup controller is active)."""
    if not do_push:
        return replay
    return push_row(replay, pack_record(replay.layout, record,
                                        replay.data.device))


def push_row(replay: Replay, row: torch.Tensor) -> Replay:
    """Write one packed row (record_width,) at the cursor, in place."""
    replay.data[replay.position] = row
    capacity = replay.data.shape[0]
    replay.position = (replay.position + 1) % capacity
    replay.size = min(replay.size + 1, capacity)
    replay.total += 1
    return replay


def sample_indices(replay: Replay, gen: Optional[torch.Generator],
                   n: int) -> torch.Tensor:
    """``n`` uniform indices, with replacement, into the valid range
    [0, size), drawn from ``gen`` on the replay's device."""
    return torch.randint(0, max(replay.size, 1), (n,), generator=gen,
                         device=replay.data.device)


def sample(replay: Replay, gen: Optional[torch.Generator],
           batch_size: int, rows: Optional[slice] = None) -> dict:
    """Uniform sample of ``batch_size`` records, with replacement, from the
    whole valid range [0, size). ``rows`` keeps only those rows of the
    sample (a data-parallel rank's share): all ``batch_size`` indices are
    drawn all the same, so the generator's stream is the same on every
    rank and in a run of one."""
    idx = sample_indices(replay, gen, batch_size)
    if rows is not None:
        idx = idx[rows]
    return unpack_rows(replay.layout, replay.data[idx])


def record_from_step(obs, action, out, mask, t, next_t) -> dict:
    """Build a replay record from a StepOut transition."""
    return {
        "obs": obs, "action": action, "reward": out.reward,
        "constraint": out.constraint, "lyap_t": out.lyap_t,
        "lyap_t1": out.lyap_t1, "barrier_signal": out.barrier_signal,
        "next_obs": out.obs, "mask": mask, "t": t, "next_t": next_t,
    }


@dataclass
class SeedReplay:
    data: torch.Tensor  # (S, capacity, record_width) f32, on the device
    position: List[int]  # each seed's next write slot
    size: List[int]  # each seed's valid records
    total: List[int]  # each seed's pushes ever
    layout: Tuple[Tuple[str, int, int], ...]


def stack_replays(replays: Sequence[Replay]) -> SeedReplay:
    """One ``SeedReplay`` holding copies of the seeds' rings, in order."""
    return SeedReplay(data=torch.stack([r.data for r in replays]),
                      position=[r.position for r in replays],
                      size=[r.size for r in replays],
                      total=[r.total for r in replays],
                      layout=replays[0].layout)


def unstack_replay(replay: SeedReplay, i: int) -> Replay:
    """Seed i's ring as a plain ``Replay`` (a copy)."""
    return Replay(data=replay.data[i].clone(), position=replay.position[i],
                  size=replay.size[i], total=replay.total[i],
                  layout=replay.layout)


def push_seed_rows(replay: SeedReplay, rows: torch.Tensor,
                   on: Sequence[bool]) -> SeedReplay:
    """Write seed i's row of ``rows`` (S, record_width) at its cursor for
    every seed where ``on`` holds, in place. Seeds at one cursor that all
    push take one write."""
    seeds = [i for i, o in enumerate(on) if o]
    if not seeds:
        return replay
    capacity = replay.data.shape[1]
    if len(seeds) == len(on) and len(set(replay.position)) == 1:
        replay.data[:, replay.position[0]] = rows
    else:
        for i in seeds:
            replay.data[i, replay.position[i]] = rows[i]
    for i in seeds:
        replay.position[i] = (replay.position[i] + 1) % capacity
        replay.size[i] = min(replay.size[i] + 1, capacity)
        replay.total[i] += 1
    return replay


def sample_seeds(replay: SeedReplay, gens: Sequence[torch.Generator],
                 batch_size: int, on: Sequence[bool]) -> dict:
    """A uniform sample of ``batch_size`` records per seed, with
    replacement, from each seed's valid range, the indices drawn from the
    seed's generator (as ``sample_indices`` draws them) for the seeds
    where ``on`` holds; another seed draws nothing and its rows are its
    ring's first record. Fields carry a leading (S,) axis."""
    data = replay.data
    idx = torch.zeros((data.shape[0], batch_size), dtype=torch.int64,
                      device=data.device)
    for i, (gen, o) in enumerate(zip(gens, on)):
        if o:
            idx[i].random_(0, max(replay.size[i], 1), generator=gen)
    rows = torch.gather(data, 1, idx[..., None].expand(-1, -1,
                                                       data.shape[2]))
    return unpack_rows(replay.layout, rows)
