"""On-device replay ring buffer (port of ``nlbac_tpu/replay/buffer.py``).

One preallocated (capacity, record_width) float32 tensor on the device
holds packed rows with the JAX package's byte layout (``make_layout``),
so a row means the same in both packages. The write cursor and counts are
host integers: the driver decides each push on the host after its one
per-step read of the device, so no counter needs a device round trip.
``push`` writes in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

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


def _pack(layout, record: dict, device) -> torch.Tensor:
    parts = []
    for name, _, w in layout:
        v = record[name]
        if isinstance(v, torch.Tensor):
            parts.append(v.to(dtype=torch.float32).reshape(w))
        else:  # a host number: a fill, with no host-to-device copy
            parts.append(torch.full((w,), float(v), dtype=torch.float32,
                                    device=device))
    return torch.cat(parts)


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
    replay.data[replay.position] = _pack(replay.layout, record,
                                         replay.data.device)
    capacity = replay.data.shape[0]
    replay.position = (replay.position + 1) % capacity
    replay.size = min(replay.size + 1, capacity)
    replay.total += 1
    return replay


def sample(replay: Replay, gen: Optional[torch.Generator],
           batch_size: int) -> dict:
    """Uniform sample of ``batch_size`` records, with replacement, from the
    whole valid range [0, size)."""
    idx = torch.randint(0, max(replay.size, 1), (batch_size,), generator=gen,
                        device=replay.data.device)
    return unpack_rows(replay.layout, replay.data[idx])


def record_from_step(obs, action, out, mask, t, next_t) -> dict:
    """Build a replay record from a StepOut transition."""
    return {
        "obs": obs, "action": action, "reward": out.reward,
        "constraint": out.constraint, "lyap_t": out.lyap_t,
        "lyap_t1": out.lyap_t1, "barrier_signal": out.barrier_signal,
        "next_obs": out.obs, "mask": mask, "t": t, "next_t": next_t,
    }
