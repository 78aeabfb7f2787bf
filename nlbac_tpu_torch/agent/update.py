"""The NLBAC update step (port of ``nlbac_tpu/agent/update.py``).

Per call, in the reference's order:

1. the NODE fit on a sample of the NODE buffer, every
   ``update_interval``-th update (the sample is drawn only then);
2. twin-Q TD and Lyapunov TD, each with its own Adam;
3. the primary policy loss: SAC term with the just-stepped critic plus
   the augmented-Lagrangian constraint term, whose NODE rollout runs the
   fused Euler kernel on the GPU;
4. the backup policy branch (CBF-only constraints, shared or separate rho);
5. both entropy temperatures;
6. soft target updates.

The gates (``lax.cond`` in the reference) read the host-side update
counter ``ts.updates``, so no gate waits for the device. Parameters and
optimizer state are updated in place; ``update_core`` returns the same
``TrainState`` and a dict of 0-d device tensors.

The learned-barrier (NBC) branch, the pre-tanh regularizers and the
data-parallel entry points are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from nlbac_tpu_torch import replay as replay_lib
from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent.state import TrainState
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.constraints import backup_loss as lag_backup_loss
from nlbac_tpu_torch.constraints import get_builder, uses_barrier
from nlbac_tpu_torch.constraints import primary_loss as lag_primary_loss
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import (
    ActionSpec,
    apply_grads,
    deterministic_policy_sample,
    gaussian_policy_sample,
    lyapunov_apply,
    make_field,
    node_loss,
    soft_update,
    twin_q_apply,
)
from nlbac_tpu_torch.tree import detach, tree_leaves

METRIC_NAMES = ("qf1_loss", "qf2_loss", "lf_loss", "policy_loss",
                "constraint_loss", "alpha_loss", "alpha", "node_loss",
                "barrier_td_loss", "rho", "lam_max")


def _mse(a, b):
    return torch.mean(torch.square(a - b))


def _step(optimizer, params, loss) -> None:
    """One optimizer step of ``params`` on ``loss``."""
    grads = torch.autograd.grad(loss, tree_leaves(params))
    apply_grads(optimizer, params, grads)


class Agent(NamedTuple):
    """Config plus the update's functions (closures over it)."""

    cfg: NLBACConfig
    select_action: Callable
    update: Callable
    update_core: Callable
    node_fit: Callable


def make_agent(cfg: NLBACConfig, device="cuda") -> Agent:
    env = get_env(cfg.env.name)
    builder = get_builder(cfg.constraint.kind)
    ccfg, ncfg, scfg = cfg.constraint, cfg.node, cfg.sac
    if uses_barrier(ccfg.kind):
        raise NotImplementedError("the learned-barrier branch is not ported")
    if scfg.pretanh_reg or scfg.probe_pretanh_reg:
        raise NotImplementedError("the pre-tanh regularizers are not ported")
    device = resolve_device(device)
    field = make_field(ncfg)
    spec = ActionSpec.from_bounds(env.SPEC.action_low, env.SPEC.action_high,
                                  device)
    dt = cfg.env.dt
    target_entropy = (-float(cfg.action_dim) if scfg.target_entropy is None
                      else float(scfg.target_entropy))
    is_gaussian = scfg.policy_type != "deterministic"
    entropy_tuning = scfg.automatic_entropy_tuning and is_gaussian
    sample_policy = (gaussian_policy_sample if is_gaussian
                     else deterministic_policy_sample)

    def sample_fn(params, obs_b, gen, noise=None):
        return sample_policy(params, obs_b, spec, gen=gen, noise=noise)

    action_low = torch.tensor(env.SPEC.action_low, dtype=torch.float32,
                              device=device)
    action_high = torch.tensor(env.SPEC.action_high, dtype=torch.float32,
                               device=device)
    obs_to_node_state = env.obs_to_state

    def zero():
        return torch.zeros((), dtype=torch.float32, device=device)

    # ------------------------------------------------------------------
    def select_action(ts: TrainState, obs, gen, warmup: bool, use_backup):
        """obs: (obs_dim,). ``warmup`` is a host bool; ``use_backup`` a
        device bool."""
        if warmup:
            u = torch.rand((cfg.action_dim,), generator=gen, device=device)
            return action_low + u * (action_high - action_low)
        with torch.no_grad():
            obs_b = obs[None, :]
            a, _, _ = sample_fn(ts.policy, obs_b, gen)
            if ccfg.use_backup:
                a_bak, _, _ = sample_fn(ts.backup_policy, obs_b, gen)
                a = torch.where(use_backup, a_bak, a)
        return a[0]

    # ------------------------------------------------------------------
    def node_fit_batch(node_params, node_opt, batch):
        x = obs_to_node_state(batch["obs"])
        x_next = obs_to_node_state(batch["next_obs"])
        t = batch["t"][:, None] if ncfg.time_input else None
        loss = node_loss(ncfg, node_params, x, batch["action"], x_next, dt,
                         t=t, field=field)
        _step(node_opt, node_params, loss)
        return loss.detach()

    def node_fit(node_params, node_opt, node_replay, gen):
        """Fit on ``max_batch`` rows drawn from the whole buffer."""
        batch = replay_lib.sample(node_replay, gen, ncfg.max_batch)
        return node_fit_batch(node_params, node_opt, batch)

    # ------------------------------------------------------------------
    def update(ts: TrainState, rl_replay, node_replay, gen, i_episode: int
               ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Sample both buffers, then run the update; the NODE sample is
        drawn only when the fit is gated on."""
        batch = replay_lib.sample(rl_replay, gen, scfg.batch_size)
        return update_core(
            ts, batch,
            lambda: replay_lib.sample(node_replay, gen, ncfg.max_batch),
            gen, i_episode)

    def update_core(ts: TrainState, batch, node_batch_thunk, gen,
                    i_episode: int, noise: Optional[dict] = None
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update over ``batch``. ``noise`` may hold the
        standard-normal draws for the samples ("next" for the TD target,
        "pi" for the policy loss, "backup" for the backup loss); the
        rest are drawn from ``gen``."""
        noise = noise or {}
        obs, action = batch["obs"], batch["action"]
        if obs.shape[0] != scfg.batch_size:
            raise ValueError(
                f"batch has {obs.shape[0]} rows but cfg.sac.batch_size="
                f"{scfg.batch_size}; constraint means are normalized by "
                "the configured size, so they must match")
        reward = batch["reward"][:, None]
        constraint = batch["constraint"][:, None]
        mask = batch["mask"][:, None]
        n_upd = ts.updates

        # --- 1. NODE fit (gated) ----------------------------------------
        do_node = n_upd % ncfg.update_interval == 0
        if ncfg.fit_episode_limit is not None:
            do_node = do_node and i_episode <= ncfg.fit_episode_limit
        if do_node:
            node_fit_loss = node_fit_batch(ts.node, ts.opt["node"],
                                           node_batch_thunk())
        else:
            node_fit_loss = zero()

        # --- 2. critic / Lyapunov TD --------------------------------------
        # Stale-alpha rule: the first update uses alpha_init, later ones
        # the temperature left by the previous update.
        if not is_gaussian:
            alpha = 0.0
        elif n_upd == 0:
            alpha = scfg.alpha_init
        else:
            alpha = torch.exp(ts.log_alpha.detach()[0])
        with torch.no_grad():
            next_a, next_logp, _ = sample_fn(ts.policy, batch["next_obs"],
                                             gen, noise.get("next"))
            q1_t, q2_t = twin_q_apply(ts.critic_target, batch["next_obs"],
                                      next_a)
            min_q_t = torch.minimum(q1_t, q2_t) - alpha * next_logp
            next_q = reward + mask * scfg.gamma * min_q_t
            lf_t = lyapunov_apply(ts.lyap_target, batch["lyap_t1"])
            next_l = constraint + mask * scfg.gamma * lf_t

        q1, q2 = twin_q_apply(ts.critic, obs, action)
        qf1_loss, qf2_loss = _mse(q1, next_q), _mse(q2, next_q)
        _step(ts.opt["critic"], ts.critic, qf1_loss + qf2_loss)

        lf_loss = _mse(lyapunov_apply(ts.lyap, batch["lyap_t"]), next_l)
        _step(ts.opt["lyap"], ts.lyap, lf_loss)

        # The policy losses see the stepped critic, Lyapunov net and NODE
        # without differentiating them (gradients go to the policy only).
        pg_critic, pg_lyap, pg_node = (detach(ts.critic), detach(ts.lyap),
                                       detach(ts.node))

        # --- 3. primary policy ------------------------------------------
        do_lam = n_upd % ccfg.lambda_update_interval == 0
        lag_live = True
        if ccfg.lagrangian_warmup_episodes > 0:
            lag_live = i_episode >= ccfg.lagrangian_warmup_episodes
            do_lam = do_lam and lag_live
        term_kwargs = dict(ccfg=ccfg, ncfg=ncfg, node_params=pg_node,
                           field=field, lyap_params=pg_lyap,
                           lyap_t=batch["lyap_t"], dt=dt, gen=gen)

        pi, logp, _ = sample_fn(ts.policy, obs, gen, noise.get("pi"))
        pq1, pq2 = twin_q_apply(pg_critic, obs, pi)
        policy_loss_1 = torch.mean(alpha * logp - torch.minimum(pq1, pq2))
        terms = builder.terms(obs=obs, action=pi, include_clf=True,
                              **term_kwargs)
        policy_loss_2, lam_new, rho1 = lag_primary_loss(
            ccfg, terms, ts.lag.lam, ts.lag.rho, do_lam, scfg.batch_size,
            do_rho_growth=lag_live)
        _step(ts.opt["policy"], ts.policy, policy_loss_1 + policy_loss_2)
        logp = logp.detach()

        # --- 4. backup policy branch --------------------------------------
        backup_lam = ts.lag.backup_lam
        if ccfg.use_backup:
            backup_rho_out = (ts.lag.backup_rho if ccfg.separate_backup_rho
                              else rho1)
            do_backup = (ccfg.backup_update_interval <= 1
                         or n_upd % ccfg.backup_update_interval == 0)
            if do_backup:
                if not is_gaussian:
                    backup_alpha = 0.0
                elif n_upd == 0:
                    backup_alpha = scfg.alpha_init
                else:
                    backup_alpha = torch.exp(ts.backup_log_alpha.detach()[0])
                bpi, blogp, _ = sample_fn(ts.backup_policy, obs, gen,
                                          noise.get("backup"))
                bq1, bq2 = twin_q_apply(pg_critic, obs, bpi)
                bloss1 = torch.mean(backup_alpha * blogp
                                    - torch.minimum(bq1, bq2))
                bterms = builder.terms(obs=obs, action=bpi,
                                       include_clf=False, **term_kwargs)
                bloss2, backup_lam, backup_rho_out = lag_backup_loss(
                    ccfg, bterms, backup_lam, backup_rho_out, do_lam,
                    scfg.batch_size, do_rho_growth=lag_live)
                _step(ts.opt["backup_policy"], ts.backup_policy,
                      bloss1 + bloss2)
                if entropy_tuning:
                    ent_err = torch.mean(blogp.detach()) + target_entropy
                    _step(ts.opt["backup_alpha"], ts.backup_log_alpha,
                          -(ts.backup_log_alpha[0] * ent_err))
            if ccfg.separate_backup_rho:
                rho_final, backup_rho_final = rho1, backup_rho_out
            else:
                rho_final, backup_rho_final = backup_rho_out, \
                    ts.lag.backup_rho
        else:
            rho_final, backup_rho_final = rho1, ts.lag.backup_rho

        # --- 5. primary entropy temperature -------------------------------
        alpha_loss = zero()
        if entropy_tuning:
            ent_err = torch.mean(logp) + target_entropy
            a_loss = -(ts.log_alpha[0] * ent_err)
            alpha_loss = a_loss.detach()
            _step(ts.opt["alpha"], ts.log_alpha, a_loss)

        # --- 6. soft target updates ---------------------------------------
        if scfg.target_update_interval <= 1 or \
                n_upd % scfg.target_update_interval == 0:
            soft_update(ts.critic_target, ts.critic, scfg.tau)
            soft_update(ts.lyap_target, ts.lyap, scfg.tau)

        ts.lag = ts.lag._replace(lam=lam_new.detach(),
                                 backup_lam=backup_lam.detach(),
                                 rho=rho_final, backup_rho=backup_rho_final)
        ts.updates = n_upd + 1
        metrics = {
            "qf1_loss": qf1_loss.detach(), "qf2_loss": qf2_loss.detach(),
            "lf_loss": lf_loss.detach(),
            "policy_loss": policy_loss_1.detach(),
            "constraint_loss": policy_loss_2.detach(),
            "alpha_loss": alpha_loss,
            "alpha": (torch.exp(ts.log_alpha.detach()[0]) if is_gaussian
                      else zero()),
            "node_loss": node_fit_loss, "barrier_td_loss": zero(),
            "rho": rho_final, "lam_max": torch.max(lam_new.detach()),
        }
        return ts, metrics

    return Agent(cfg=cfg, select_action=select_action, update=update,
                 update_core=update_core, node_fit=node_fit)
