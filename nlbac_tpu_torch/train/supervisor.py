"""Backup-controller supervisor (port of ``nlbac_tpu/train/supervisor.py``).

- ``trap``: if the displacement over the last ``window`` positions stays
  <= ``trap_threshold`` for ``trap_count`` consecutive checks, switch to
  the backup controller; switch back after ``backup_max_steps`` backup
  steps or once displaced >= ``escape_distance_sq`` from the switch
  anchor.
- ``cars_gap``: switch when the car-4/5 gap (next obs) < ``cars_gap``
  while the desired region is reached; back after
  ``cars_backup_max_steps`` steps, or after >= ``cars_min_backup_steps``
  once both gaps clear ``cars_gap``.
- ``pvtol``: the trap machine on the position, plus an operator-rush
  machine (moving toward the goal while beyond the operator distance)
  with its own flag and timer.
- ``none``: never switches.

The flags and timers are device tensors, so a machine adds no device
read to the step; the ring's write slot and the step count are host
integers.

Stacked over seeds (the lockstep seed runner), every tensor field gains
a leading (S,) axis (``init_supervisor(..., seeds=S)``): every machine
runs elementwise over it, reading an observation's coordinates on its
last axis, the seeds sharing the host slot and step count (they run in
lockstep).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from nlbac_tpu_torch.config import SupervisorConfig
from nlbac_tpu_torch.envs.base import StepOut

KINDS = ("trap", "cars_gap", "pvtol", "none")


class SupervisorState(NamedTuple):
    positions: torch.Tensor  # (window, 2) ring of recent positions
    ptr: int  # next write slot
    use_backup: torch.Tensor  # bool
    use_backup_y: torch.Tensor  # bool (pvtol rush machine)
    backup_time: torch.Tensor  # i32
    backup_y_time: torch.Tensor  # i32
    violation_time: torch.Tensor  # i32
    violation_y_time: torch.Tensor  # i32
    anchor: torch.Tensor  # (2,) switch-time position


def init_supervisor(cfg: SupervisorConfig, device,
                    seeds: int | None = None) -> SupervisorState:
    """A fresh machine; with ``seeds`` = S, S of them stacked."""
    if cfg.kind not in KINDS:
        raise ValueError(f"unknown supervisor kind {cfg.kind!r}; options: "
                         f"{KINDS}")
    lead = () if seeds is None else (seeds,)
    i32 = dict(dtype=torch.int32, device=device)
    false = torch.zeros(lead, dtype=torch.bool, device=device)
    return SupervisorState(
        positions=torch.zeros(lead + (cfg.window, 2), device=device), ptr=0,
        use_backup=false, use_backup_y=false.clone(),
        backup_time=torch.zeros(lead, **i32),
        backup_y_time=torch.zeros(lead, **i32),
        violation_time=torch.zeros(lead, **i32),
        violation_y_time=torch.zeros(lead, **i32),
        anchor=torch.zeros(lead + (2,), device=device))


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
    window = sup.positions.shape[-2]
    positions = sup.positions.clone()
    positions[..., sup.ptr, :] = pos2
    newest = positions[..., sup.ptr, :]
    ptr = (sup.ptr + 1) % window
    oldest = positions[..., ptr, :]
    disp2 = torch.sum(torch.square(newest - oldest), dim=-1)
    checking = episode_steps >= cfg.min_steps

    trapped = disp2 <= cfg.trap_threshold
    can_check = (~sup.use_backup) & (checking and start)
    vt = torch.where(can_check & trapped, sup.violation_time + 1,
                     sup.violation_time)
    fire = can_check & (vt >= cfg.trap_count)
    vt = torch.where(fire, 0, vt)
    vt = torch.where(can_check & ~trapped, 0, vt)
    use_backup = sup.use_backup | fire
    anchor = torch.where(fire[..., None], pos2, sup.anchor)

    exiting_ctx = use_backup & (checking and start)
    timeout = sup.backup_time >= cfg.backup_max_steps
    escaped = torch.sum(torch.square(pos2 - anchor),
                        dim=-1) >= cfg.escape_distance_sq
    stop = exiting_ctx & (timeout | escaped)
    use_backup = use_backup & ~stop
    backup_time = torch.where(stop, 0, sup.backup_time)
    return sup._replace(positions=positions, ptr=ptr, use_backup=use_backup,
                        violation_time=vt.to(torch.int32),
                        backup_time=backup_time.to(torch.int32),
                        anchor=anchor)


def _cars_machine(cfg: SupervisorConfig, sup: SupervisorState,
                  out: StepOut, start: bool) -> SupervisorState:
    obs = out.obs
    gap34 = obs[..., 4] * 100.0 - obs[..., 6] * 100.0
    gap45 = obs[..., 6] * 100.0 - obs[..., 8] * 100.0

    trigger = (gap45 < cfg.cars_gap) & (out.reached != 0)
    fire = (~sup.use_backup) & trigger & start
    use_backup = sup.use_backup | fire

    in_backup = use_backup & start
    timeout = sup.backup_time >= cfg.cars_backup_max_steps
    cleared = (sup.backup_time >= cfg.cars_min_backup_steps) & \
        (gap34 > cfg.cars_gap) & (gap45 > cfg.cars_gap)
    stop = in_backup & (timeout | cleared)
    use_backup = use_backup & ~stop
    backup_time = torch.where(stop, 0, sup.backup_time)
    return sup._replace(use_backup=use_backup,
                        backup_time=backup_time.to(torch.int32))


def _pvtol_rush_machine(cfg: SupervisorConfig, sup: SupervisorState,
                        obs_prev, obs, episode_steps: int,
                        start: bool) -> SupervisorState:
    """Operator-rush trigger: rushing toward the goal while beyond the
    operator distance."""
    checking = episode_steps >= cfg.min_steps
    x, x_prev, op = obs[..., 0], obs_prev[..., 0], obs[..., 7]
    od = cfg.operator_dist
    rushing = (((x <= 4.5) & (x - x_prev > 0) & (x - op > od))
               | ((x > 4.5) & (x - x_prev < 0) & (op - x > od)))

    can_check = (~sup.use_backup_y) & (checking and start)
    vt = torch.where(can_check & rushing, sup.violation_y_time + 1,
                     sup.violation_y_time)
    fire = can_check & (vt >= 1)
    vt = torch.where(fire, 0, vt)
    vt = torch.where(can_check & ~rushing, 0, vt)
    use_y = sup.use_backup_y | fire

    in_backup = use_y & (checking and start)
    timeout = sup.backup_y_time >= cfg.rush_backup_max_steps
    safe_again = (((x <= 4.5) & (x - op <= 0.9 * od))
                  | ((x > 4.5) & (op - x <= 0.9 * od)))
    stop = in_backup & (timeout | safe_again)
    use_y = use_y & ~stop
    backup_y_time = torch.where(stop, 0, sup.backup_y_time)
    return sup._replace(use_backup_y=use_y,
                        violation_y_time=vt.to(torch.int32),
                        backup_y_time=backup_y_time.to(torch.int32))


def post_step(cfg: SupervisorConfig, sup: SupervisorState, obs_prev,
              out: StepOut, episode_steps: int, start: bool
              ) -> SupervisorState:
    """Advance the trigger machine after an env step; ``episode_steps`` is
    the post-increment step count and ``obs_prev`` the observation before
    the step (the pvtol rush machine reads the direction of motion)."""
    if cfg.kind == "none":
        return sup
    if cfg.kind == "trap":
        return _trap_machine(cfg, sup, out.lyap_t1, episode_steps, start)
    if cfg.kind == "cars_gap":
        return _cars_machine(cfg, sup, out, start)
    if cfg.kind == "pvtol":
        sup = _trap_machine(cfg, sup, out.obs[..., :2], episode_steps,
                            start)
        return _pvtol_rush_machine(cfg, sup, obs_prev, out.obs,
                                   episode_steps, start)
    raise ValueError(f"unknown supervisor kind {cfg.kind!r}")
