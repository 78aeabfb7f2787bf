"""The port's learned-barrier family against the JAX package, on the CPU:
``learned_barrier.terms`` for the unicycle, PVTOL and quadrotor (values and
the gradient with respect to the action, with and without the CLF column,
the resample draw injected), and one ``update_core`` each of
``nbc_unicycle``, ``nbc_pvtol`` and ``quadrotor`` (the last with both
pre-tanh regularizers on) with the NODE fit gated on and off, comparing
every metric (``barrier_td_loss`` included), every parameter and target
(the barrier and its target included) and every Adam moment.

Tolerances: terms rtol 1e-5 / atol 1e-5, as the other builders'
(``test_torch_port_presets.py``); the update as
``test_torch_port_update.py`` holds the unicycle's: metrics rtol 1e-5 /
atol 1e-6, parameters, Adam moments and the Lagrangian state rtol 1e-4 /
atol 1e-6. Both sides run float32 and differ in the order of their
summations. ``nbc_pvtol``'s updates are held at metrics rtol 1e-4 and
parameters atol 1e-5, as PVTOL's update 0 is in
``test_torch_port_presets.py``, for the same reason: PVTOL's thrust
scale of 15 puts a sampled action deep in the tanh's saturation, where
log(scale (1 - tanh^2) + 1e-6) turns the one-ulp difference between the
two libraries' tanh into a large difference of that row's log-prob. In
update 0 one policy-loss row (pre-tanh -4.96, the batch and initial
policy are PVTOL's) moves policy_loss by 1.09e-5 relative; in update 1
one TD-target row (pre-tanh 4.06, log-prob 0.15357 against 0.15347)
moves qf1_loss by 1.42e-5 relative.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu.constraints import learned_barrier as jterms
from nlbac_tpu.envs import pvtol as jpvtol
from nlbac_tpu.envs import quadrotor as jquad
from nlbac_tpu.envs import unicycle as juni
from nlbac_tpu.nn import ActionSpec as JActionSpec
from nlbac_tpu.nn import barrier_init, gaussian_policy_init
from nlbac_tpu.nn import gaussian_policy_sample, lyapunov_init
from nlbac_tpu.nn import make_field, node_init
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.constraints import get_builder
from nlbac_tpu_torch.constraints import learned_barrier as tterms
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.nn import ActionSpec as TActionSpec
from nlbac_tpu_torch.nn import gaussian_policy_sample as t_policy_sample
from nlbac_tpu_torch.nn import make_field as t_make_field

RTOL, ATOL = 1e-5, 1e-5
BATCH, NODE_BATCH = 6, 8
PRESETS = ("nbc_unicycle", "nbc_pvtol", "quadrotor")
ENVS = {"unicycle": juni, "pvtol": jpvtol, "quadrotor": jquad}
# the quadrotor's update runs with both pre-tanh regularizers on
PRETANH = {"quadrotor": dict(pretanh_reg=0.05, probe_pretanh_reg=0.2)}


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
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH,
                                **PRETANH.get(preset, {})),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def env_obs(env_name, rng, n):
    """Observations spread over each env's arena."""
    f = np.float32
    if env_name == "unicycle":
        s = np.stack([rng.uniform(-3, 3, n), rng.uniform(-3, 3, n),
                      rng.uniform(-np.pi, np.pi, n)], 1).astype(f)
        return np.asarray(juni.state_to_obs(s))
    if env_name == "pvtol":
        s = np.zeros((n, 7), f)
        s[:, :2] = rng.uniform(-5, 5, size=(n, 2))
        s[:, 2] = rng.uniform(-np.pi, np.pi, size=n)
        s[:, 3:5] = rng.normal(0, 1, size=(n, 2))
        s[:, 5] = rng.uniform(0, 2, size=n)
        s[:, 6] = s[:, 0] + rng.normal(0, 0.8, size=n)
        return np.asarray(jpvtol.state_to_obs(s))
    return np.stack([rng.uniform(-2.5, 2.5, n), rng.normal(0, 1, n),
                     rng.uniform(-0.3, 2.5, n), rng.normal(0, 1, n),
                     rng.uniform(-1, 1, n), rng.normal(0, 2, n)],
                    1).astype(f)


def lyap_input(env_name, rng, obs):
    """What each env's Lyapunov net reads: the unicycle's lookahead point,
    PVTOL's obs, the quadrotor's (x, z)."""
    if env_name == "unicycle":
        return rng.normal(size=(obs.shape[0], 2)).astype(np.float32)
    if env_name == "pvtol":
        return obs
    return obs[:, [0, 2]]


def draw(key, rows, n_u):
    return torch.tensor(np.asarray(
        jax.random.normal(key, (rows, n_u), jnp.float32)))


# --- constraint terms --------------------------------------------------------

@pytest.mark.parametrize("include_clf", [True, False])
@pytest.mark.parametrize("env_name", ["unicycle", "pvtol", "quadrotor"])
def test_learned_barrier_terms_match_reference(env_name, include_clf):
    preset = "quadrotor" if env_name == "quadrotor" else f"nbc_{env_name}"
    cfg_j, cfg_t = tiny_cfg(jconfig, preset), tiny_cfg(tconfig, preset)
    env = ENVS[env_name]
    n_u = cfg_j.action_dim
    rng = np.random.default_rng(4)
    node = node_init(jax.random.PRNGKey(1), cfg_j.node)
    lyap = lyapunov_init(jax.random.PRNGKey(2), cfg_j.lyap_dim, 16)
    policy = gaussian_policy_init(jax.random.PRNGKey(3), cfg_j.obs_dim, n_u,
                                  16)
    barrier = barrier_init(jax.random.PRNGKey(6), cfg_j.obs_dim, n_u, 16)
    obs = env_obs(env_name, rng, BATCH)
    lyap_t = lyap_input(env_name, rng, env_obs(env_name, rng, BATCH))
    action = rng.uniform(env.SPEC.action_low, env.SPEC.action_high,
                         size=(BATCH, n_u)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jspec = JActionSpec.from_bounds(env.SPEC.action_low,
                                    env.SPEC.action_high)

    def j_terms(a):
        return jterms.terms(
            cfg_j.constraint, cfg_j.node, node, make_field(cfg_j.node),
            lyap, obs, a, lyap_t, key, cfg_j.env.dt, env_name=env_name,
            barrier_params=barrier,
            resample=lambda o, k: gaussian_policy_sample(policy, o, k,
                                                         jspec)[0],
            include_clf=include_clf)

    cot = rng.normal(size=(BATCH, (jterms.NUM_PRIMARY if include_clf
                                   else jterms.NUM_BACKUP))).astype(
                                       np.float32)
    tj = j_terms(action)
    gj = jax.grad(lambda a: jnp.sum(j_terms(a) * cot))(action)

    # the reference resamples u_{t+1} once, with the builder's key itself
    draws = draw(key, BATCH, n_u)[None]
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
        torch.tensor(lyap_t), cfg_t.env.dt, env_name=env_name,
        barrier_params=to_torch(barrier), resample=resample,
        include_clf=include_clf)
    assert calls == [0]
    assert tt.shape == tj.shape == cot.shape
    close(tj, tt)
    (gt,) = torch.autograd.grad((tt * torch.tensor(cot)).sum(), ta)
    assert float(gt.abs().max()) > 0  # B_{t+1} reaches the action
    close(gj, gt)


def test_learned_barrier_identity_branch_names_its_item():
    """The builder's registry entry and constants; its ``identity`` branch
    (a host env whose obs is the NODE state, as the host loop drives it)
    against the JAX package's, values and the gradient with respect to
    the action; an unknown env still raises."""
    cfg = tiny_cfg(tconfig, "nbc_unicycle")
    assert get_builder("learned_barrier") is tterms
    assert tterms.USES_BARRIER and tterms.NUM_PRIMARY == 2 and \
        tterms.NUM_BACKUP == 1
    kw = dict(form="mlp", state_dim=2, action_dim=1, hidden_dim=8,
              mlp_hidden_layers=1)
    ncfg_j, ncfg_t = jconfig.NodeConfig(**kw), tconfig.NodeConfig(**kw)
    node = node_init(jax.random.PRNGKey(1), ncfg_j)
    lyap = lyapunov_init(jax.random.PRNGKey(2), 2, 16)
    policy = gaussian_policy_init(jax.random.PRNGKey(3), 2, 1, 16)
    barrier = barrier_init(jax.random.PRNGKey(6), 2, 1, 16)
    rng = np.random.default_rng(9)
    obs = rng.normal(size=(BATCH, 2)).astype(np.float32)
    lyap_t = rng.normal(size=(BATCH, 2)).astype(np.float32)
    action = rng.uniform(-1, 1, size=(BATCH, 1)).astype(np.float32)
    cot = rng.normal(size=(BATCH, 2)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    jspec = JActionSpec.from_bounds((-1.0,), (1.0,))

    def j_terms(a):
        return jterms.terms(
            cfg.constraint, ncfg_j, node, make_field(ncfg_j), lyap, obs, a,
            lyap_t, key, 0.1, env_name="identity", barrier_params=barrier,
            resample=lambda o, k: gaussian_policy_sample(policy, o, k,
                                                         jspec)[0])

    tj = j_terms(action)
    gj = jax.grad(lambda a: jnp.sum(j_terms(a) * cot))(action)
    draws = draw(key, BATCH, 1)[None]
    tspec = TActionSpec.from_bounds((-1.0,), (1.0,))
    ta = torch.tensor(action, requires_grad=True)
    tt = tterms.terms(
        cfg.constraint, ncfg_t, to_torch(node), t_make_field(ncfg_t),
        to_torch(lyap), torch.tensor(obs), ta, torch.tensor(lyap_t), 0.1,
        env_name="identity", barrier_params=to_torch(barrier),
        resample=lambda o, k: t_policy_sample(to_torch(policy), o, tspec,
                                              noise=draws[k])[0])
    close(tj, tt)
    (gt,) = torch.autograd.grad((tt * torch.tensor(cot)).sum(), ta)
    close(gj, gt)
    zeros = torch.zeros(BATCH, 3)
    with pytest.raises(ValueError, match="unsupported env"):
        tterms.terms(cfg.constraint, cfg.node, None, None, None, zeros,
                     torch.zeros(BATCH, 2), None, 0.02, env_name="cars")


# --- one update --------------------------------------------------------------

def make_batch(preset, rng, n):
    f = np.float32
    cfg = jconfig.get_config(preset)
    env_name = cfg.env.name
    env = ENVS[env_name]
    obs, next_obs = env_obs(env_name, rng, n), env_obs(env_name, rng, n)
    t = rng.uniform(0, 6, size=n).astype(f)
    return {
        "obs": obs, "action": rng.uniform(
            env.SPEC.action_low, env.SPEC.action_high,
            size=(n, cfg.action_dim)).astype(f),
        "reward": rng.normal(size=n).astype(f),
        "constraint": np.abs(rng.normal(size=n)).astype(f),
        "lyap_t": lyap_input(env_name, rng, obs),
        "lyap_t1": lyap_input(env_name, rng, next_obs),
        "barrier_signal": rng.choice([0.0, 0.0, -1.0, -10.0, -20.0],
                                     size=n).astype(f),
        "next_obs": next_obs,
        "mask": (rng.uniform(size=n) > 0.2).astype(f),
        "t": t, "next_t": t + f(0.02),
    }


def leaves_with_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


@pytest.fixture(scope="module")
def jax_updates():
    return {p: jax.jit(make_agent(tiny_cfg(jconfig, p)).update_from_batch)
            for p in PRESETS}


@pytest.mark.parametrize("node_fit", [True, False])
@pytest.mark.parametrize("preset", PRESETS)
def test_nbc_update_core_matches_reference(jax_updates, preset, node_fit):
    """Update 0 (NODE fit, multiplier ascent, the stale alpha_init, the
    quadrotor's backup branch) and update 1 after a first reference
    update (no fit, no ascent); the barrier TD step and the barrier
    target's soft update run in both."""
    update = jax_updates[preset]
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
    key = jax.random.PRNGKey(7)
    ts_j, m_j = update(ts, batch, node_batch, key, jnp.int32(0))

    # the reference draws from split(key, 8): [2] the TD-target sample
    # (critic and barrier), [3] the policy-loss sample, [4] the primary
    # resample, [5] the backup-loss sample, [6] the backup resample
    keys = jax.random.split(key, 8)
    noise = {name: draw(keys[i], BATCH, n_u)
             for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    noise["resample"] = draw(keys[4], BATCH, n_u)[None]
    noise["backup_resample"] = draw(keys[6], BATCH, n_u)[None]

    ref = jax.tree.map(np.asarray, ts)
    port = from_reference(ref, cfg_t, "cpu")
    agent = t_make_agent(cfg_t, "cpu")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tnb = {k: torch.tensor(v) for k, v in node_batch.items()}
    drawn = []
    port, m_t = agent.update_core(port, tb,
                                  lambda: drawn.append(1) or tnb,
                                  None, 0, noise=noise)
    assert drawn == ([1] if node_fit else [])
    assert (float(m_j["node_loss"]) > 0) == node_fit
    assert float(m_t["barrier_td_loss"]) > 0

    rtol, atol = (1e-4, 1e-5) if preset == "nbc_pvtol" else (1e-5, 1e-6)
    for k in METRIC_NAMES:
        close(float(m_j[k]), float(m_t[k]), rtol=rtol, atol=1e-6,
              err_msg=k)
    expect = jax.tree.map(np.asarray, ts_j)
    got = to_reference(port, expect)
    assert int(got.updates) == int(expect.updates) == ref.updates + 1
    # the barrier, its target and its Adam moments moved in this update
    assert not np.array_equal(expect.barrier_target["w"][0],
                              ref.barrier_target["w"][0])
    paths = []
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb
        paths.append(pa)
        close(a, b, rtol=1e-4, atol=atol, err_msg=pa)
    assert any(".barrier_target" in p for p in paths)
    assert any("'barrier'" in p and ".mu" in p for p in paths)
