"""The update's gates over a sequence of updates, port against JAX, on the
CPU: 8 lockstep updates of unicycle and PVTOL at the tiny widths of
``test_torch_port_presets.py``, with the intervals cut so that every gate
switches inside the sequence:

- the NODE fit every 3rd update while the episode is at most 2
  (``fit_episode_limit``): updates 0 and 3 fit, update 6 (episode 3)
  does not;
- the target update every 2nd update;
- the multiplier ascent every 4th update once the episode reaches the
  Lagrangian warm-up (2 episodes): update 4 ascends, update 0 is frozen;
- the backup branch every 5th update (0 and 5).

The episode runs 0, 0, 1, 1, 2, 2, 3, 3 over the updates. Each update
takes the same batches and the same standard-normal draws on both sides
(drawn from the JAX update's key, as ``test_torch_port_presets.py``
does); each side then carries its own state into the next update. Every
metric, rho, the multipliers and the fit/no-fit choice are compared after
each update, and every parameter, target and Adam moment after the last.
A second case (unicycle) runs the same sequence from multipliers at their
caps (``rho`` 200, ``lam`` 400: where a band seed sits over its last 100
episodes); its tolerances are in its docstring.

Tolerances are the single-update ones: unicycle metrics rtol 1e-5 /
atol 1e-6, PVTOL metrics rtol 1e-4 / atol 1e-6; parameters, Adam moments
and the Lagrangian state rtol 1e-4 with atol 1e-6 (unicycle) and 1e-5
(PVTOL). The samples are kept out of the range where the two libraries'
tanh-squash terms part (``test_torch_port_squash.py``): on a float32 grid
the terms differ by at most 3.7e-5 nats below pre-tanh 3, 3.5e-4 at
3-4, 2.6e-3 at 4-5 and whole nats from 7 up. Update k takes the first
key PRNGKey(100 + k + 1000 j), j = 0, 1, ..., whose TD-target,
policy-loss and backup samples all stay below 3 in magnitude. With a
bound of 4, unicycle's qf1_loss parts by 1.37e-5 relative at update 3;
with plain keys PRNGKey(100 + k), unicycle's update 2 draws a TD-target
sample at 4.17 (qf2_loss 1.07e-5 relative apart) and PVTOL's update 6
one at 8.04, inside the band.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.nn import gaussian_policy_forward
from test_torch_port_presets import leaves_with_paths, resample_draws
from test_torch_port_presets import make_batch as preset_batch
from test_torch_port_update import make_batch as unicycle_batch

BATCH, NODE_BATCH = 6, 8
EPISODES = (0, 0, 1, 1, 2, 2, 3, 3)
TOL = {"unicycle": (1e-5, 1e-6), "pvtol": (1e-4, 1e-5)}
PRE_TANH_MAX = 3.0
# the updates that fit the NODE
FITS = [True, False, False, True, False, False, False, False]
# how far under lambda_max the saturated state's other multipliers start
NEAR_CAP = 1e-3


def gated_cfg(mod, preset):
    cfg = mod.get_config(preset)
    return dataclasses.replace(
        cfg,
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, max_batch=NODE_BATCH,
                                 update_interval=3, fit_episode_limit=2),
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH,
                                target_update_interval=2),
        constraint=dataclasses.replace(
            cfg.constraint, lambda_update_interval=4,
            backup_update_interval=5, lagrangian_warmup_episodes=2),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def batches(preset, rng):
    if preset == "unicycle":
        return unicycle_batch(rng, BATCH), unicycle_batch(rng, NODE_BATCH)
    return preset_batch(preset, rng, BATCH), preset_batch(preset, rng,
                                                          NODE_BATCH)


def draws(preset, key, n_u):
    """The reference's draws from split(key, 8): [2] the TD-target sample,
    [3] the policy-loss sample, [4] the primary resamples, [5] the
    backup-loss sample, [6] the backup resamples."""
    keys = jax.random.split(key, 8)
    noise = {name: torch.tensor(np.asarray(
        jax.random.normal(keys[i], (BATCH, n_u), jnp.float32)))
        for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    if preset == "pvtol":
        noise["resample"] = resample_draws(preset, keys[4], BATCH, n_u)
        noise["backup_resample"] = resample_draws(preset, keys[6], BATCH,
                                                  n_u)
    return noise


def out_of_band_key(port, batch, preset, k, n_u):
    """Update k's key and draws: the first PRNGKey(100 + k + 1000 j) whose
    samples all stay below PRE_TANH_MAX in magnitude."""
    for j in range(100):
        key = jax.random.PRNGKey(100 + k + 1000 * j)
        noise = draws(preset, key, n_u)
        if pre_tanh_max(port, batch, noise) < PRE_TANH_MAX:
            return key, noise
    raise AssertionError(f"update {k}: no key keeps the samples below "
                         f"{PRE_TANH_MAX}")


def pre_tanh_max(port, batch, noise):
    """The largest |mean + std * noise| of the update's three samples."""
    worst = 0.0
    with torch.no_grad():
        for policy, obs, name in ((port.policy, batch["next_obs"], "next"),
                                  (port.policy, batch["obs"], "pi"),
                                  (port.backup_policy, batch["obs"],
                                   "backup")):
            mean, log_std = gaussian_policy_forward(policy, obs)
            x = mean + torch.exp(log_std) * noise[name]
            worst = max(worst, float(x.abs().max()))
    return worst


def saturated(ts_j, cfg):
    """``ts_j`` with its multipliers where a late band seed holds them:
    ``rho`` and ``backup_rho`` at ``rho_max``, the first multiplier of
    each kind at ``lambda_max`` and the rest NEAR_CAP under it."""
    c = cfg.constraint

    def lams(lam):
        return jnp.full_like(lam, c.lambda_max - NEAR_CAP).at[0].set(
            c.lambda_max)

    return ts_j._replace(lag=ts_j.lag._replace(
        rho=jnp.float32(c.rho_max), backup_rho=jnp.float32(c.rho_max),
        lam=lams(ts_j.lag.lam), backup_lam=lams(ts_j.lag.backup_lam)))


def gate_sequence(preset, start=None, leaf_scaled=False):
    """The 8 updates from a fresh state (or ``start(ts, cfg)`` of it),
    each compared with JAX's; returns, per update, whether it fitted the
    NODE and whether it moved the multipliers, and both final states.
    ``leaf_scaled``: the final leaves' atol times their largest entry
    (where it is over 1)."""
    cfg_j, cfg_t = gated_cfg(jconfig, preset), gated_cfg(tconfig, preset)
    metric_rtol, atol = TOL[preset]
    n_u = cfg_j.action_dim
    update = jax.jit(make_agent(cfg_j).update_from_batch)
    agent = t_make_agent(cfg_t, "cpu")
    ts_j = create_train_state(cfg_j, jax.random.PRNGKey(0))
    if start is not None:
        ts_j = start(ts_j, cfg_j)
    port = from_reference(jax.tree.map(np.asarray, ts_j), cfg_t, "cpu")
    rng = np.random.default_rng(1)
    fits, ascents = [], []
    for k, episode in enumerate(EPISODES):
        batch, node_batch = batches(preset, rng)
        tb = {n: torch.tensor(v) for n, v in batch.items()}
        key, noise = out_of_band_key(port, tb, preset, k, n_u)
        lam_before = port.lag.lam.clone()

        ts_j, m_j = update(ts_j, batch, node_batch, key, jnp.int32(episode))
        drawn = []
        tnb = {n: torch.tensor(v) for n, v in node_batch.items()}
        port, m_t = agent.update_core(port, tb,
                                      lambda: drawn.append(1) or tnb, None,
                                      episode, noise=noise)
        fit = bool(drawn)
        assert fit == (float(m_j["node_loss"]) > 0), k
        fits.append(fit)
        ascents.append(not torch.equal(port.lag.lam, lam_before))
        for name in METRIC_NAMES:
            np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                       rtol=metric_rtol, atol=1e-6,
                                       err_msg=f"update {k} {name}")
        ref = jax.tree.map(np.asarray, ts_j)
        for field in ("rho", "lam", "backup_rho", "backup_lam"):
            np.testing.assert_allclose(
                getattr(port.lag, field).numpy(),
                np.asarray(getattr(ref.lag, field)), rtol=1e-4, atol=atol,
                err_msg=f"update {k} {field}")
        assert port.updates == int(ref.updates) == k + 1

    expect = jax.tree.map(np.asarray, ts_j)
    got = to_reference(port, expect)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb
        scale = max(1.0, float(np.abs(a).max(initial=0.0))) \
            if leaf_scaled else 1.0
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol * scale,
                                   err_msg=pa)
    return fits, ascents, port, expect


@pytest.mark.parametrize("preset", ["unicycle", "pvtol"])
def test_gate_sequence_matches_reference(preset):
    fits, ascents, _, _ = gate_sequence(preset)
    assert fits == FITS
    assert ascents == [False, False, False, False, True, False, False,
                       False]


@pytest.mark.parametrize("preset", ["unicycle"])
def test_saturated_multipliers_match_reference(preset):
    """The same 8 updates from multipliers at their caps, where every
    band seed of the port sits over its last 100 episodes: ``rho`` and
    ``backup_rho`` at ``rho_max`` (200), the first multiplier of each kind
    at ``lambda_max`` (400) and the others NEAR_CAP under it, set in the
    JAX state and carried into the port by ``interop.from_reference``.
    Update 4's ascent then lifts those whose constraint its batch violates
    to the cap through the clamp of ``ascend_multipliers``, and
    ``grow_rho`` holds rho at its cap.

    Tolerances are the fresh-state case's, but for the final parameters,
    targets and Adam moments atol is 1e-6 times the leaf's largest entry
    (where it is over 1): at the caps the policy loss carries lam 400 and
    rho 200, so the policy's gradients and Adam first moments grow to
    about 12 (0.2-0.37 from the fresh state), and float32 rounding grows
    with them. The worst gap, in the policy trunk's first moments, is
    9.6e-7 of the leaf's largest entry over rtol 1e-4; every metric and
    multiplier holds at the fresh case's tolerance."""
    fits, ascents, port, ref = gate_sequence(preset, saturated,
                                             leaf_scaled=True)
    assert fits == FITS
    assert ascents == [False, False, False, False, True, False, False,
                       False]
    lam_max = tconfig.get_config(preset).constraint.lambda_max
    rho_max = tconfig.get_config(preset).constraint.rho_max
    assert float(port.lag.rho) == float(ref.lag.rho) == rho_max
    np.testing.assert_array_equal(port.lag.lam.numpy(), ref.lag.lam)
    # each multiplier is at its start or lifted to the cap, some lifted
    near = np.float32(lam_max - NEAR_CAP)
    assert set(ref.lag.lam.tolist()) <= {float(lam_max), float(near)}
    assert (ref.lag.lam[1:] == lam_max).any()
