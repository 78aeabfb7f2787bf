"""The port's cars and PVTOL presets against the JAX package, on the CPU:
the envs (reset with the draw injected, step, the obs/state maps), the
constraint terms with the resample draws injected (values and the
gradient with respect to the action), the ``cars_gap`` and ``pvtol``
supervisor machines on scripted sequences, and one ``update_core`` of
each preset with the NODE fit gated on and off.

Tolerances: envs, terms and machines rtol 1e-5 / atol 1e-5, as the
unicycle's (``test_torch_port_env.py``); the cars update as
``test_torch_port_update.py`` holds unicycle's: metrics rtol 1e-5 /
atol 1e-6, parameters, Adam moments and the Lagrangian state rtol 1e-4 /
atol 1e-6. Both sides run float32 and differ in the order of their
summations. PVTOL's update 0 is held at metrics rtol 1e-4 and parameters
atol 1e-5: at its initial weights one action coordinate of the
policy-loss sample lands deep in the tanh's saturation (pre-tanh -4.96,
std 6.0 against an action scale of 15, 1 - tanh^2 = 2.0e-4), where
log(scale (1 - tanh^2) + 1e-6) turns a one-ulp move of the sample into
about 1e-3 of that row's log-prob: policy_loss then differs by 1.09e-5
relative and one first Adam moment of the policy by 3.4e-6 absolute,
just outside the unicycle's bounds. The tanh is not what moves it: under
the port's XLA-form squash (the same tanh as JAX's) policy_loss differs
by 2.09e-5, since the policy's mean and log_std already leave JAX's by
one ulp (the order of the matmul's sums), the sample by 4.8e-7, and the
row's log-prob by 1.25e-3. Past pre-tanh 8 the forms part: XLA's tanh
is +-1 there and ``torch.tanh`` is not, so a sample there moves
``torch.tanh``'s log-prob by whole nats and XLA's not at all. With such a
sample and none between pre-tanh 4 and XLA's clamp (PRNGKey(1027):
8.99), policy_loss reads 1.904302 in JAX, 1.904301 under the XLA-form
squash (held at the unicycle's bounds) and 1.870122 under
``torch.tanh``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu.constraints import cars as jcars_terms
from nlbac_tpu.constraints import pvtol as jpvtol_terms
from nlbac_tpu.envs import cars as jcars
from nlbac_tpu.envs import pvtol as jpvtol
from nlbac_tpu.envs.base import StepOut as JStepOut
from nlbac_tpu.nn import ActionSpec as JActionSpec
from nlbac_tpu.nn import gaussian_policy_init, gaussian_policy_sample
from nlbac_tpu.nn import lyapunov_init, make_field, node_init
from nlbac_tpu.train import supervisor as jsup
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.constraints import cars as tcars_terms
from nlbac_tpu_torch.constraints import pvtol as tpvtol_terms
from nlbac_tpu_torch.envs import cars as tcars
from nlbac_tpu_torch.envs import pvtol as tpvtol
from nlbac_tpu_torch.envs.base import StepOut as TStepOut
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.nn import ActionSpec as TActionSpec
from nlbac_tpu_torch.nn import gaussian_policy_forward as t_policy_forward
from nlbac_tpu_torch.nn import gaussian_policy_sample as t_policy_sample
from nlbac_tpu_torch.nn import make_field as t_make_field
from nlbac_tpu_torch.nn.xla_float import XLA_TANH_CLAMP
from nlbac_tpu_torch.train import supervisor as tsup

RTOL, ATOL = 1e-5, 1e-5
BATCH, NODE_BATCH = 6, 8
TERMS = {"cars": (jcars_terms, tcars_terms), "pvtol": (jpvtol_terms,
                                                         tpvtol_terms)}


def close(a, b, rtol=RTOL, atol=ATOL, err_msg=""):
    if isinstance(b, torch.Tensor):
        b = b.detach().numpy()
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def tiny_cfg(mod, preset):
    cfg = mod.get_config(preset)
    node = dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                               g_hidden_layers=2, mlp_hidden_layers=2,
                               max_batch=NODE_BATCH)
    return dataclasses.replace(
        cfg, node=node,
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def cars_states(rng, n):
    """Car chains near the start layout (gaps about 8 apart)."""
    x = np.zeros((n, 10), np.float32)
    x[:, 0::2] = jcars.INIT_POS + rng.normal(0, 2.5, size=(n, 5))
    x[:, 1::2] = 3.0 + rng.normal(0, 1.0, size=(n, 5))
    return x.astype(np.float32)


def pvtol_states(rng, n):
    """7-d PVTOL states over the arena, the operator near x."""
    s = np.zeros((n, 7), np.float32)
    s[:, :2] = rng.uniform(-5, 5, size=(n, 2))
    s[:, 2] = rng.uniform(-np.pi, np.pi, size=n)
    s[:, 3:5] = rng.normal(0, 1, size=(n, 2))
    s[:, 5] = rng.uniform(0, 2, size=n)
    s[:, 6] = s[:, 0] + rng.normal(0, 0.8, size=n)
    return s


def preset_obs(preset, rng, n):
    if preset == "cars":
        return np.asarray(jcars.get_obs(cars_states(rng, n)))
    return np.asarray(jpvtol.state_to_obs(pvtol_states(rng, n)))


# --- envs -------------------------------------------------------------------

def test_cars_env_reset_step_and_maps():
    key = jax.random.PRNGKey(3)
    st_j, obs_j = jcars.reset(key)
    st_t, obs_t = tcars.reset(
        "cpu", noise=torch.tensor(np.asarray(jax.random.normal(key, ()))))
    close(st_j.x, st_t.x, rtol=0, atol=0)
    close(obs_j, obs_t, rtol=0, atol=0)

    rng = np.random.default_rng(0)
    # a trajectory from the reset (the sim time advances on both sides)
    for i in range(60):
        a = rng.uniform(-3, 3, size=1).astype(np.float32)
        st_j, out_j = jcars.step(st_j, jnp.asarray(a), max_episode_steps=50)
        st_t, out_t = tcars.step(st_t, torch.tensor(a),
                                 max_episode_steps=50)
        close(st_j.x, st_t.x, err_msg=f"step {i}")
        close(st_j.t, st_t.t)
        assert int(st_j.step) == st_t.step
        for name in out_j._fields:
            close(getattr(out_j, name), getattr(out_t, name),
                  err_msg=f"step {i} {name}")
    # single steps from states that cross the gap and brake thresholds
    for i, x in enumerate(cars_states(rng, 40)):
        x[4] = x[6] + rng.choice([2.0, 9.4, 6.0])  # gap34 (reached, viol)
        x[8] = x[6] - rng.choice([2.0, 9.0])  # gap45
        t = np.float32(rng.uniform(0, 6))
        a = rng.uniform(-3, 3, size=1).astype(np.float32)
        sj, oj = jcars.step(jcars.CarsState(x=jnp.asarray(x),
                                            t=jnp.float32(t),
                                            step=jnp.int32(i)),
                            jnp.asarray(a), barrier_B=-20.0)
        stt, ot = tcars.step(tcars.CarsState(x=torch.tensor(x),
                                             t=torch.tensor(t), step=i),
                             torch.tensor(a), barrier_B=-20.0)
        close(sj.x, stt.x)
        for name in oj._fields:
            close(getattr(oj, name), getattr(ot, name), err_msg=name)
        close(jcars.accelerations(x, t),
              tcars.accelerations(torch.tensor(x), torch.tensor(t)))

    states = cars_states(rng, 16)
    close(jcars.state_to_obs(states),
          tcars.state_to_obs(torch.tensor(states)), rtol=0, atol=0)
    obs = np.asarray(jcars.state_to_obs(states))
    close(jcars.obs_to_state(obs), tcars.obs_to_state(torch.tensor(obs)),
          rtol=0, atol=0)


def test_pvtol_env_reset_step_and_maps():
    st_j, obs_j = jpvtol.reset(jax.random.PRNGKey(0))
    st_t, obs_t = tpvtol.reset("cpu")
    close(st_j.x, st_t.x, rtol=0, atol=0)
    close(obs_j, obs_t)
    close(st_j.last_goal_dist, st_t.last_goal_dist)

    rng = np.random.default_rng(1)
    for i, x in enumerate(pvtol_states(rng, 60)):
        if i % 6 == 0:  # on a hazard
            x[:2] = jpvtol.HAZARDS[i % 5] + rng.uniform(-0.1, 0.1, 2)
        if i % 6 == 1:  # at the goal
            x[:2] = jpvtol.GOAL + rng.uniform(-1, 1, 2)
        if i % 6 == 2:  # beyond the y box
            x[1] = rng.choice([-101.0, 101.0])
        if i % 6 == 3:  # far from the operator
            x[6] = x[0] + rng.choice([-1.8, 1.8])
        a = rng.uniform([-3.5, -15], [3.5, 15]).astype(np.float32)
        steps = int(rng.integers(0, 2000))
        sj, oj = jpvtol.step(
            jpvtol.PvtolState(x=jnp.asarray(x), step=jnp.int32(steps),
                              last_goal_dist=jnp.float32(1.0)),
            jnp.asarray(a), barrier_B=-0.1, max_episode_steps=1000)
        stt, ot = tpvtol.step(
            tpvtol.PvtolState(x=torch.tensor(x), step=steps,
                              last_goal_dist=torch.tensor(1.0)),
            torch.tensor(a), barrier_B=-0.1, max_episode_steps=1000)
        close(sj.x, stt.x)
        assert int(sj.step) == stt.step
        for name in oj._fields:
            close(getattr(oj, name), getattr(ot, name), err_msg=name)

    states = pvtol_states(rng, 16)
    close(jpvtol.state_to_obs(states),
          tpvtol.state_to_obs(torch.tensor(states)))
    obs = np.asarray(jpvtol.state_to_obs(states))
    tobs = torch.tensor(obs)
    close(jpvtol.obs_to_state(obs), tpvtol.obs_to_state(tobs))
    close(jpvtol.obs_to_dynamics_state(obs),
          tpvtol.obs_to_dynamics_state(tobs))
    assert tpvtol.obs_to_dynamics_state(tobs).shape == (16, 6)
    close(jpvtol.propagate_operator(states[:, 6], states[:, 0]),
          tpvtol.propagate_operator(torch.tensor(states[:, 6]),
                                    torch.tensor(states[:, 0])))


# --- constraint terms --------------------------------------------------------

def resample_draws(preset, key, rows, action_dim):
    """The standard-normal draws the JAX builder's resamples take from
    ``key``: cars resamples once with the key itself, pvtol's chain splits
    it into ``horizon`` keys and resamples with the first two."""
    if preset == "cars":
        keys = [key]
    else:
        keys = list(jax.random.split(key, 3))[:2]
    return torch.stack([torch.tensor(np.asarray(
        jax.random.normal(k, (rows, action_dim), jnp.float32)))
        for k in keys])


@pytest.mark.parametrize("include_clf", [True, False])
@pytest.mark.parametrize("preset", ["cars", "pvtol"])
def test_preset_terms_match_reference(preset, include_clf):
    jterms, tterms = TERMS[preset]
    cfg_j, cfg_t = tiny_cfg(jconfig, preset), tiny_cfg(tconfig, preset)
    env = {"cars": jcars, "pvtol": jpvtol}[preset]
    n_u = cfg_j.action_dim
    rng = np.random.default_rng(4)
    node = node_init(jax.random.PRNGKey(1), cfg_j.node)
    lyap = lyapunov_init(jax.random.PRNGKey(2), cfg_j.lyap_dim, 16)
    policy = gaussian_policy_init(jax.random.PRNGKey(3), cfg_j.obs_dim, n_u,
                                  16)
    obs = preset_obs(preset, rng, BATCH)
    action = rng.uniform(env.SPEC.action_low, env.SPEC.action_high,
                         size=(BATCH, n_u)).astype(np.float32)
    lyap_t = (obs[:, 4:8] * 100.0 if preset == "cars" else
              preset_obs(preset, rng, BATCH)).astype(np.float32)
    t = rng.uniform(0, 6, size=(BATCH, 1)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jspec = JActionSpec.from_bounds(env.SPEC.action_low,
                                    env.SPEC.action_high)

    def j_terms(a):
        return jterms.terms(
            cfg_j.constraint, cfg_j.node, node, make_field(cfg_j.node),
            lyap, obs, a, lyap_t, key, cfg_j.env.dt, t=t, next_t=t + 0.02,
            resample=lambda o, k: gaussian_policy_sample(policy, o, k,
                                                         jspec)[0],
            include_clf=include_clf)

    cot = rng.normal(size=(BATCH, (jterms.NUM_PRIMARY if include_clf
                                   else jterms.NUM_BACKUP))).astype(
                                       np.float32)
    tj = j_terms(action)
    gj = jax.grad(lambda a: jnp.sum(j_terms(a) * cot))(action)

    draws = resample_draws(preset, key, BATCH, n_u)
    tspec = TActionSpec.from_bounds(env.SPEC.action_low,
                                    env.SPEC.action_high)
    tpolicy = to_torch(policy)
    calls = []

    def resample(o, k):
        calls.append(k)
        return t_policy_sample(tpolicy, o, tspec, noise=draws[k])[0]

    ta = torch.tensor(action, requires_grad=True)
    tt = tterms.terms(
        cfg_t.constraint, cfg_t.node, to_torch(node),
        t_make_field(cfg_t.node), to_torch(lyap), torch.tensor(obs), ta,
        torch.tensor(lyap_t), cfg_t.env.dt, t=torch.tensor(t),
        next_t=torch.tensor(t + 0.02), resample=resample,
        include_clf=include_clf)
    assert calls == list(range(len(draws)))
    assert tt.shape == tj.shape == cot.shape
    close(tj, tt)
    (gt,) = torch.autograd.grad((tt * torch.tensor(cot)).sum(), ta)
    close(gj, gt)


# --- supervisor machines -----------------------------------------------------

def run_machines(kw, steps, make_obs, reached=None):
    """Drive the JAX and port machines through ``steps`` scripted
    observations, comparing every field after every step. Returns the
    per-step backup flags."""
    cj, ct = jconfig.SupervisorConfig(**kw), tconfig.SupervisorConfig(**kw)
    sj = jsup.init_supervisor(cj)
    st = tsup.init_supervisor(ct, "cpu")
    prev = make_obs(0)
    flags = []
    for i in range(steps):
        start = i >= 2
        aj, sj = jsup.pre_action(cj, sj, start)
        at, st = tsup.pre_action(ct, st, start)
        assert bool(aj) == bool(at), i
        flags.append(bool(at))
        obs = make_obs(i + 1)
        r = np.float32(reached[i]) if reached is not None else np.float32(0)
        oj = JStepOut(*[None] * 13)._replace(obs=jnp.asarray(obs),
                                             reached=jnp.float32(r))
        ot = TStepOut(*[None] * 13)._replace(obs=torch.tensor(obs),
                                             reached=torch.tensor(r))
        sj = jsup.post_step(cj, sj, jnp.asarray(prev), oj, i + 1, start)
        st = tsup.post_step(ct, st, torch.tensor(prev), ot, i + 1, start)
        assert int(sj.ptr) == st.ptr
        for name in ("positions", "use_backup", "use_backup_y",
                     "backup_time", "backup_y_time", "violation_time",
                     "violation_y_time", "anchor"):
            close(getattr(sj, name), getattr(st, name), rtol=0, atol=0,
                  err_msg=f"step {i} {name}")
        prev = obs
    return flags


def test_cars_gap_machine_on_scripted_gaps():
    rng = np.random.default_rng(5)
    steps = 80
    gap45 = np.where(rng.uniform(size=steps + 1) < 0.5, 2.0, 3.0)
    gap45[10:14] = 2.0  # fires (reached), then clears after min steps
    gap45[14:20] = 3.0
    gap45[30:50] = 1.0  # stays closed: the timeout ends it
    gap34 = np.where(rng.uniform(size=steps + 1) < 0.3, 2.0, 9.5)
    reached = (rng.uniform(size=steps) < 0.6).astype(np.float32)
    reached[9:13] = 1.0

    def make_obs(i):
        x = np.zeros(10, np.float32)
        x[6] = 20.0
        x[4] = 20.0 + gap34[i]
        x[8] = 20.0 - gap45[i]
        return np.asarray(jcars.get_obs(x))

    flags = run_machines(dict(kind="cars_gap", cars_gap=2.5,
                              cars_backup_max_steps=6,
                              cars_min_backup_steps=2),
                         steps, make_obs, reached)
    assert any(flags) and not all(flags[10:])


def test_pvtol_machine_on_scripted_motion():
    xs, ops = [], []
    x = -4.0
    for i in range(90):
        if i < 12:  # rushing right, the operator 1.5 behind
            x += 0.3
            op = x - 1.5
        elif i < 18:  # the operator catches up: safe again
            op = x - 0.5
        elif i < 40:  # stalled: the trap machine fires
            x += 0.001
            op = x
        elif i < 48:  # a jump away: escaped
            x += 0.4
            op = x
        elif i < 60:  # beyond the goal's x, rushing left
            x = 6.0 - 0.2 * (i - 48)
            op = x + 1.5
        else:
            op = x
        xs.append(x)
        ops.append(op)

    def make_obs(i):
        s = np.array([xs[i], 0.5 * xs[i], 0.1, 0.0, 0.0, 1.0, ops[i]],
                     np.float32)
        return np.asarray(jpvtol.state_to_obs(s))

    flags = run_machines(dict(kind="pvtol", window=5, min_steps=3,
                              trap_threshold=0.015, trap_count=2,
                              backup_max_steps=4, escape_distance_sq=1.0,
                              rush_backup_max_steps=3, operator_dist=1.0),
                         89, make_obs)
    assert any(flags) and not all(flags)


# --- one update --------------------------------------------------------------

def make_batch(preset, rng, n):
    f = np.float32
    cfg = jconfig.get_config(preset)
    env = {"cars": jcars, "pvtol": jpvtol}[preset]
    obs, next_obs = preset_obs(preset, rng, n), preset_obs(preset, rng, n)
    if preset == "cars":
        lyap_t, lyap_t1 = obs[:, 4:8] * 100.0, next_obs[:, 4:8] * 100.0
    else:
        lyap_t, lyap_t1 = obs, next_obs
    t = rng.uniform(0, 6, size=n).astype(f)
    return {
        "obs": obs, "action": rng.uniform(
            env.SPEC.action_low, env.SPEC.action_high,
            size=(n, cfg.action_dim)).astype(f),
        "reward": rng.normal(size=n).astype(f),
        "constraint": np.abs(rng.normal(size=n)).astype(f),
        "lyap_t": lyap_t.astype(f), "lyap_t1": lyap_t1.astype(f),
        "barrier_signal": np.zeros(n, f), "next_obs": next_obs,
        "mask": (rng.uniform(size=n) > 0.2).astype(f),
        "t": t, "next_t": t + f(0.02),
    }


def leaves_with_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


@pytest.fixture(scope="module")
def jax_updates():
    return {p: jax.jit(make_agent(tiny_cfg(jconfig, p)).update_from_batch)
            for p in ("cars", "pvtol")}


def run_update(update, preset, node_fit, key, squash="torch"):
    """One update of ``preset`` from the initial state (after a first
    reference update when ``node_fit`` is off) by JAX and by the port
    under ``squash``, with JAX's draws from ``key`` injected; returns
    both metrics, both states in JAX's form and the draws."""
    cfg_j, cfg_t = tiny_cfg(jconfig, preset), tiny_cfg(tconfig, preset)
    n_u = cfg_j.action_dim
    rng = np.random.default_rng(0)
    ts = create_train_state(cfg_j, jax.random.PRNGKey(0))
    if not node_fit:
        ts, _ = update(ts, make_batch(preset, rng, BATCH),
                       make_batch(preset, rng, NODE_BATCH),
                       jax.random.PRNGKey(3), jnp.int32(0))
    batch = make_batch(preset, rng, BATCH)
    node_batch = make_batch(preset, rng, NODE_BATCH)
    ts_j, m_j = update(ts, batch, node_batch, key, jnp.int32(0))

    # the reference draws from split(key, 8): [2] the TD-target sample,
    # [3] the policy-loss sample, [4] the primary resamples, [5] the
    # backup-loss sample, [6] the backup resamples
    keys = jax.random.split(key, 8)
    noise = {name: torch.tensor(np.asarray(
        jax.random.normal(keys[i], (BATCH, n_u), jnp.float32)))
        for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    noise["resample"] = resample_draws(preset, keys[4], BATCH, n_u)
    noise["backup_resample"] = resample_draws(preset, keys[6], BATCH, n_u)

    ref = jax.tree.map(np.asarray, ts)
    port = from_reference(ref, cfg_t, "cpu")
    pre_tanh = sample_pre_tanh(port, batch, noise)
    agent = t_make_agent(cfg_t, "cpu", squash=squash)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tnb = {k: torch.tensor(v) for k, v in node_batch.items()}
    drawn = []
    port, m_t = agent.update_core(port, tb,
                                  lambda: drawn.append(1) or tnb,
                                  None, 0, noise=noise)
    assert drawn == ([1] if node_fit else [])
    assert (float(m_j["node_loss"]) > 0) == node_fit
    expect = jax.tree.map(np.asarray, ts_j)
    got = to_reference(port, expect)
    assert int(got.updates) == int(expect.updates) == ref.updates + 1
    return m_j, m_t, expect, got, pre_tanh


def sample_pre_tanh(port, batch, noise):
    """Each sample's pre-tanh values, (TD target, policy loss, backup
    loss), from the state ``port`` before its update."""
    out = []
    with torch.no_grad():
        for policy, obs, name in ((port.policy, "next_obs", "next"),
                                  (port.policy, "obs", "pi"),
                                  (port.backup_policy, "obs", "backup")):
            mean, log_std = t_policy_forward(policy,
                                             torch.tensor(batch[obs]))
            out.append(mean + torch.exp(log_std) * noise[name])
    return torch.stack(out)


def assert_update_close(m_j, m_t, expect, got, metric_rtol, atol):
    for k in METRIC_NAMES:
        close(float(m_j[k]), float(m_t[k]), rtol=metric_rtol, atol=1e-6,
              err_msg=k)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb
        close(a, b, rtol=1e-4, atol=atol, err_msg=pa)


@pytest.mark.parametrize("node_fit", [True, False])
@pytest.mark.parametrize("preset", ["cars", "pvtol"])
def test_update_core_matches_reference(jax_updates, preset, node_fit):
    """Update 0 (NODE fit, multiplier ascent, the backup branch and the
    stale alpha_init all fire) and update 1 after a first reference
    update (no fit, no ascent; PVTOL's backup branch is skipped)."""
    m_j, m_t, expect, got, _ = run_update(
        jax_updates[preset], preset, node_fit, jax.random.PRNGKey(7))
    rtol, atol = (1e-4, 1e-5) if (preset, node_fit) == ("pvtol", True) \
        else (1e-5, 1e-6)
    assert_update_close(m_j, m_t, expect, got, rtol, atol)


def quiet_saturating_key():
    """The first PRNGKey(1000 + j) whose draws put a sample of PVTOL's
    update 0 past pre-tanh 8 and none at pre-tanh 4 up to XLA's clamp,
    with the sample's pre-tanh values."""
    cfg_j, cfg_t = tiny_cfg(jconfig, "pvtol"), tiny_cfg(tconfig, "pvtol")
    port = from_reference(jax.tree.map(np.asarray, create_train_state(
        cfg_j, jax.random.PRNGKey(0))), cfg_t, "cpu")
    batch = make_batch("pvtol", np.random.default_rng(0), BATCH)
    for j in range(200):
        key = jax.random.PRNGKey(1000 + j)
        keys = jax.random.split(key, 8)
        noise = {name: torch.tensor(np.asarray(jax.random.normal(
            keys[i], (BATCH, cfg_t.action_dim), jnp.float32)))
            for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
        x = sample_pre_tanh(port, batch, noise).abs()
        if float(x.max()) > 8.0 and not bool(
                ((x > 4.0) & (x <= XLA_TANH_CLAMP)).any()):
            return key
    raise AssertionError("no key puts a sample past pre-tanh 8 alone")


def test_pvtol_update_under_xla_squash(jax_updates):
    """PVTOL's update 0 with the port's XLA-form squash, with a sample
    past pre-tanh 8 (where XLA's tanh is +-1 and ``torch.tanh`` is not)
    and none at pre-tanh 4 up to XLA's clamp, held at the unicycle's
    bounds (metrics rtol 1e-5 / atol 1e-6; parameters, Adam moments and
    the Lagrangian state rtol 1e-4 / atol 1e-6). Under ``torch.tanh`` the
    same update's policy_loss leaves JAX's by over 1e-3 relative."""
    update = jax_updates["pvtol"]
    key = quiet_saturating_key()
    m_j, m_t, expect, got, pre_tanh = run_update(update, "pvtol", True, key,
                                                 squash="xla")
    assert float(pre_tanh.abs().max()) > 8.0
    assert_update_close(m_j, m_t, expect, got, 1e-5, 1e-6)
    m_j, m_t, *_ = run_update(update, "pvtol", True, key)
    gap = abs(float(m_t["policy_loss"]) / float(m_j["policy_loss"]) - 1)
    assert gap > 1e-3, gap


def test_pvtol_update0_under_xla_squash(jax_updates):
    """PVTOL's update 0 of ``test_update_core_matches_reference`` with the
    port's XLA-form squash, at the same bounds as under ``torch.tanh``
    (metrics rtol 1e-4, parameters atol 1e-5): its policy-loss sample at
    pre-tanh -4.96 is not a matter of the tanh (see the module note)."""
    m_j, m_t, expect, got, pre_tanh = run_update(
        jax_updates["pvtol"], "pvtol", True, jax.random.PRNGKey(7),
        squash="xla")
    assert 4.9 < float(pre_tanh.abs().max()) < 5.0
    assert_update_close(m_j, m_t, expect, got, 1e-4, 1e-5)
