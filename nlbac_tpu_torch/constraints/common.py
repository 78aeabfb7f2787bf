"""Augmented-Lagrangian machinery shared by the constraint builders (port
of ``nlbac_tpu/constraints/common.py``).

1. Residual matrix (B, K) -> ReLU-filter -> per-constraint means c over the
   CONFIGURED batch size (the CLF residual is the last column).
2. A balance ratio |mean(c_cbf)| / max(|c_clf|, 1e-12) scales the CLF term
   (no gradient), optionally floored.
3. Multiplier ascent lam <- clip(lam + rho * c_raw, lambda_min,
   lambda_max) on the gated updates, with rho BEFORE its bump.
4. rho <- min(rho * growth, rho_max) on every loss evaluation.
5. loss = sum_i lam'_i (c_i - cl) + rho'/2 (c_i - cl)^2, the CLF term
   scaled by ratio and ratio^2.

The multipliers and rho stay on the device as tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from nlbac_tpu_torch.config import ConstraintConfig


class LagrangianState(NamedTuple):
    lam: torch.Tensor  # (K_primary,) primary multipliers (CLF last)
    backup_lam: torch.Tensor  # (K_backup,) backup multipliers
    rho: torch.Tensor  # f32 shared/primary augmented coefficient
    backup_rho: torch.Tensor  # f32 separate backup coefficient


def init_lagrangian(num_primary: int, num_backup: int,
                    rho_init: float = 1.0, device=None) -> LagrangianState:
    f32 = torch.float32
    return LagrangianState(
        lam=torch.zeros((num_primary,), dtype=f32, device=device),
        backup_lam=torch.zeros((max(num_backup, 1),), dtype=f32,
                               device=device),
        rho=torch.tensor(rho_init, dtype=f32, device=device),
        backup_rho=torch.tensor(rho_init, dtype=f32, device=device),
    )


def filtered_means(terms: torch.Tensor, batch_size: int) -> torch.Tensor:
    """ReLU-filter then batch-mean each column, dividing by the configured
    ``batch_size``: (B, K) -> (K,)."""
    return torch.sum(torch.clamp(terms, min=0.0), dim=0) / batch_size


def ascend_multipliers(cfg: ConstraintConfig, lam, c, rho,
                       do_update: bool):
    """lam <- clip(lam + rho * c, lambda_min, lambda_max) when
    ``do_update`` (a host bool); identity otherwise."""
    if not do_update:
        return lam
    return torch.clamp(lam + rho * c.detach(), cfg.lambda_min,
                       cfg.lambda_max)


def grow_rho(cfg: ConstraintConfig, rho):
    return torch.clamp(rho * cfg.rho_growth, max=cfg.rho_max)


def primary_loss(cfg: ConstraintConfig, terms: torch.Tensor, lam, rho,
                 do_lambda_update: bool, batch_size: int,
                 do_rho_growth: bool = True
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Primary controller's constraint loss (CBFs + CLF-last).

    Returns (loss, lam', rho'): ascent with rho_in, then the rho bump,
    then the loss with (lam', rho')."""
    m = filtered_means(terms, batch_size)  # raw: ascent only
    c = m - cfg.cost_limit  # shifted: ratio + loss
    if cfg.use_ratio and terms.shape[1] < 2:
        raise ValueError(
            "use_ratio=True requires at least one CBF column before the "
            f"CLF (builder produced {terms.shape[1]} column(s))")
    if cfg.use_ratio:
        other = torch.abs(torch.mean(c[:-1]))
        lya = torch.abs(c[-1])
        ratio = (other / torch.clamp(lya, min=1e-12)).detach()
        if cfg.ratio_floor > 0:
            ratio = torch.clamp(ratio, min=cfg.ratio_floor)
    else:
        ratio = 1.0

    lam_new = ascend_multipliers(cfg, lam, m, rho, do_lambda_update)
    rho_new = grow_rho(cfg, rho) if do_rho_growth else rho

    lam_const = lam_new.detach()
    cbf_part = torch.sum(lam_const[:-1] * c[:-1]
                         + 0.5 * rho_new * torch.square(c[:-1]))
    clf_part = (lam_const[-1] * ratio * c[-1]
                + 0.5 * rho_new * (ratio * ratio) * torch.square(c[-1]))
    return cbf_part + clf_part, lam_new, rho_new


def backup_loss(cfg: ConstraintConfig, terms: torch.Tensor, backup_lam,
                rho, do_lambda_update: bool, batch_size: int,
                do_rho_growth: bool = True
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backup controller's CBF-only constraint loss; returns
    (loss, backup_lam', rho')."""
    m = filtered_means(terms, batch_size)
    c = m - cfg.cost_limit
    lam_new = ascend_multipliers(cfg, backup_lam, m, rho, do_lambda_update)
    rho_new = grow_rho(cfg, rho) if do_rho_growth else rho
    lam_const = lam_new.detach()
    loss = torch.sum(lam_const * c + 0.5 * rho_new * torch.square(c))
    return loss, lam_new, rho_new
