"""Backup-controller supervisor (port of ``nlbac_tpu/train/supervisor.py``,
the ``trap`` machine and ``none``).

``trap``: if the displacement over the last ``window`` positions stays
<= ``trap_threshold`` for ``trap_count`` consecutive checks, switch to the
backup controller; switch back after ``backup_max_steps`` backup steps or
once displaced >= ``escape_distance_sq`` from the switch anchor.

The flags and timers are device tensors, so the machine adds no device
read to the step; the ring's write slot and the step count are host
integers. The ``cars_gap`` and ``pvtol`` machines are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from nlbac_tpu_torch.config import SupervisorConfig
from nlbac_tpu_torch.envs.base import StepOut

PORTED_KINDS = ("trap", "none")


class SupervisorState(NamedTuple):
    positions: torch.Tensor  # (window, 2) ring of recent positions
    ptr: int  # next write slot
    use_backup: torch.Tensor  # bool
    use_backup_y: torch.Tensor  # bool (pvtol rush machine; stays False)
    backup_time: torch.Tensor  # i32
    backup_y_time: torch.Tensor  # i32
    violation_time: torch.Tensor  # i32
    violation_y_time: torch.Tensor  # i32
    anchor: torch.Tensor  # (2,) switch-time position


def init_supervisor(cfg: SupervisorConfig, device) -> SupervisorState:
    if cfg.kind not in PORTED_KINDS:
        raise NotImplementedError(f"supervisor kind {cfg.kind!r} is not "
                                  f"ported; ported: {PORTED_KINDS}")
    i32 = dict(dtype=torch.int32, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    return SupervisorState(
        positions=torch.zeros((cfg.window, 2), device=device), ptr=0,
        use_backup=false, use_backup_y=false.clone(),
        backup_time=torch.zeros((), **i32),
        backup_y_time=torch.zeros((), **i32),
        violation_time=torch.zeros((), **i32),
        violation_y_time=torch.zeros((), **i32),
        anchor=torch.zeros((2,), device=device))


def backup_active(sup: SupervisorState, start: bool) -> torch.Tensor:
    """Whether the NEXT action comes from the backup controller."""
    return (sup.use_backup | sup.use_backup_y) & start


def pre_action(cfg: SupervisorConfig, sup: SupervisorState, start: bool
               ) -> Tuple[torch.Tensor, SupervisorState]:
    """The backup flag for this action; bumps the backup timers."""
    if cfg.kind == "none":
        return torch.zeros_like(sup.use_backup), sup
    active = backup_active(sup, start)
    inc = (active & sup.use_backup).to(torch.int32)
    inc_y = (active & sup.use_backup_y).to(torch.int32)
    return active, sup._replace(backup_time=sup.backup_time + inc,
                                backup_y_time=sup.backup_y_time + inc_y)


def _trap_machine(cfg: SupervisorConfig, sup: SupervisorState, pos2,
                  episode_steps: int, start: bool) -> SupervisorState:
    window = sup.positions.shape[0]
    positions = sup.positions.clone()
    positions[sup.ptr] = pos2
    newest = positions[sup.ptr]
    ptr = (sup.ptr + 1) % window
    oldest = positions[ptr]
    disp2 = torch.sum(torch.square(newest - oldest))
    checking = episode_steps >= cfg.min_steps

    trapped = disp2 <= cfg.trap_threshold
    can_check = (~sup.use_backup) & (checking and start)
    vt = torch.where(can_check & trapped, sup.violation_time + 1,
                     sup.violation_time)
    fire = can_check & (vt >= cfg.trap_count)
    vt = torch.where(fire, 0, vt)
    vt = torch.where(can_check & ~trapped, 0, vt)
    use_backup = sup.use_backup | fire
    anchor = torch.where(fire, pos2, sup.anchor)

    exiting_ctx = use_backup & (checking and start)
    timeout = sup.backup_time >= cfg.backup_max_steps
    escaped = torch.sum(torch.square(pos2 - anchor)) >= cfg.escape_distance_sq
    stop = exiting_ctx & (timeout | escaped)
    use_backup = use_backup & ~stop
    backup_time = torch.where(stop, 0, sup.backup_time)
    return sup._replace(positions=positions, ptr=ptr, use_backup=use_backup,
                        violation_time=vt.to(torch.int32),
                        backup_time=backup_time.to(torch.int32),
                        anchor=anchor)


def post_step(cfg: SupervisorConfig, sup: SupervisorState, obs_prev,
              out: StepOut, episode_steps: int, start: bool
              ) -> SupervisorState:
    """Advance the trigger machine after an env step; ``episode_steps`` is
    the post-increment step count."""
    del obs_prev  # read only by the pvtol rush machine
    if cfg.kind == "none":
        return sup
    if cfg.kind == "trap":
        return _trap_machine(cfg, sup, out.lyap_t1, episode_steps, start)
    raise NotImplementedError(f"supervisor kind {cfg.kind!r} is not ported")
