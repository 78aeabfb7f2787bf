"""The port's quadrotor env (``nlbac_tpu_torch/envs/quadrotor.py``) against
the JAX package's, on the CPU: constants, ``reset``, ``step`` (the kill
box, ``kill_attitude``, ``kill_penalty``, the collision and out-of-range
barrier signals and costs), ``reset_curriculum`` in its three modes with
the uniforms injected (and both range checks), ``spawn_at_alpha``,
``ground_probe_obs``, ``dynamics`` and the obs/state maps; then the
driver's curriculum and kill-term plumbing and the pre-tanh regularizers'
errors.

Tolerance rtol 1e-5 / atol 1e-5, as the other envs'
(``test_torch_port_env.py``); float32 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import make_agent as j_make_agent
from nlbac_tpu.envs import quadrotor as jquad
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.envs import quadrotor as tquad
from nlbac_tpu_torch.train import driver

RTOL, ATOL = 1e-5, 1e-5
E = 12  # curriculum episodes


def close(a, b, rtol=RTOL, atol=ATOL, err_msg=""):
    if isinstance(b, torch.Tensor):
        b = b.detach().numpy()
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol,
                               err_msg=err_msg)


def test_constants_match_the_reference_and_the_ports_config():
    for name in ("MASS", "ARM", "IYY", "GRAVITY", "HOVER_T", "KILL_X",
                 "KILL_Z", "GOAL_SIZE", "REWARD_GOAL", "X_RANGE", "Z_RANGE",
                 "OBSTACLE_RADIUS", "BARRIER_OUT_OF_RANGE",
                 "BARRIER_COLLISION", "STATE_SCALE", "ACTION_SCALE",
                 "CURRICULUM_ALPHA_MIN", "CURRICULUM_JITTER",
                 "MIX_GROUND_INTERVAL", "SPEC"):
        assert getattr(tquad, name) == getattr(jquad, name), name
    for name in ("GOAL", "OBSTACLE", "INIT_STATE"):
        np.testing.assert_array_equal(getattr(tquad, name),
                                      getattr(jquad, name), err_msg=name)
    node = tconfig.get_config("quadrotor").node
    assert tquad.STATE_SCALE == tconfig._QUAD_STATE_SCALE == node.state_scale
    assert tquad.ACTION_SCALE == tconfig._QUAD_ACTION_SCALE == \
        node.action_scale
    assert tquad.HOVER_T == tconfig._QUAD_HOVER_T
    assert get_env("quadrotor") is tquad


def test_reset_probe_and_maps():
    st_j, obs_j = jquad.reset(jax.random.PRNGKey(0))
    st_t, obs_t = tquad.reset("cpu")
    close(st_j.x, st_t.x, rtol=0, atol=0)
    close(obs_j, obs_t, rtol=0, atol=0)
    assert st_t.step == int(st_j.step) == 0
    probe = tquad.ground_probe_obs("cpu")
    assert probe.shape == (13, 6)
    close(jquad.ground_probe_obs(), probe, rtol=0, atol=0)
    x = torch.randn(5, 6)
    assert tquad.obs_to_state(x) is x and tquad.state_to_obs(x) is x


def arena_states(rng, n):
    """States over and beyond the kill box, some on the obstacle, some at
    the goal, some tilted past an attitude limit."""
    s = np.stack([rng.uniform(-3.3, 3.3, n), rng.normal(0, 2, n),
                  rng.uniform(-0.8, 3.3, n), rng.normal(0, 2, n),
                  rng.uniform(-1.2, 1.2, n), rng.normal(0, 5, n)],
                 1).astype(np.float32)
    s[0::7, [0, 2]] = jquad.OBSTACLE + rng.uniform(-0.1, 0.1, (len(s[0::7]),
                                                                2))
    s[1::7, [0, 2]] = jquad.GOAL + rng.uniform(-0.1, 0.1, (len(s[1::7]), 2))
    s[2::7, [1, 3, 5]] = 0.0
    return s


@pytest.mark.parametrize("kill", [(0.0, 0.0), (250.0, 0.0), (250.0, 0.6),
                                  (0.0, 0.9)])
def test_step_matches_reference(kill):
    kill_penalty, kill_attitude = kill
    rng = np.random.default_rng(int(kill_penalty + 10 * kill_attitude))
    lo, hi = jquad.SPEC.action_low, jquad.SPEC.action_high
    seen = {"killed": 0, "collision": 0, "out": 0, "goal": 0}
    for i, x in enumerate(arena_states(rng, 80)):
        a = rng.uniform(lo, hi).astype(np.float32)
        steps = int(rng.integers(0, 1000))
        sj, oj = jquad.step(
            jquad.QuadrotorState(x=jnp.asarray(x), step=jnp.int32(steps)),
            jnp.asarray(a), max_episode_steps=900,
            kill_penalty=kill_penalty, kill_attitude=kill_attitude)
        stt, ot = tquad.step(
            tquad.QuadrotorState(x=torch.tensor(x), step=steps),
            torch.tensor(a), max_episode_steps=900,
            kill_penalty=kill_penalty, kill_attitude=kill_attitude)
        close(sj.x, stt.x, err_msg=f"state {i}")
        assert int(sj.step) == stt.step
        for name in oj._fields:
            close(getattr(oj, name), getattr(ot, name),
                  err_msg=f"state {i} {name}")
        seen["killed"] += bool(ot.done) and not bool(ot.goal_met)
        seen["collision"] += float(ot.viol_breakdown[1]) > 0
        seen["out"] += float(ot.viol_breakdown[2]) > 0
        seen["goal"] += bool(ot.goal_met)
    assert all(v > 0 for v in seen.values()), seen


def test_trajectory_and_dynamics_match_reference():
    rng = np.random.default_rng(3)
    st_j, _ = jquad.reset(jax.random.PRNGKey(0))
    st_t, _ = tquad.reset("cpu")
    lo, hi = jquad.SPEC.action_low, jquad.SPEC.action_high
    for i in range(60):
        a = rng.uniform(lo, hi).astype(np.float32)
        st_j, out_j = jquad.step(st_j, jnp.asarray(a), kill_penalty=250.0)
        st_t, out_t = tquad.step(st_t, torch.tensor(a), kill_penalty=250.0)
        close(st_j.x, st_t.x, err_msg=f"step {i}")
        close(out_j.reward, out_t.reward, err_msg=f"step {i}")
        close(out_j.lyap_t, out_t.lyap_t)
        close(out_j.lyap_t1, out_t.lyap_t1)
    x = arena_states(rng, 9)
    u = rng.uniform(lo, hi, size=(9, 2)).astype(np.float32)
    batched = tquad.dynamics(torch.tensor(x), torch.tensor(u))
    assert batched.shape == (9, 6)
    for i in range(9):
        close(jquad.dynamics(jnp.asarray(x[i]), jnp.asarray(u[i])),
              batched[i])


def curriculum_pair(key, ep, mode="anneal", mix_alpha_min=0.15):
    """The JAX reset and the port's with the same uniforms: the jitter's
    from ``key``, the mixture's from ``fold_in(key, 1)``."""
    kwargs = {}
    if mode != "anneal":
        kwargs = {"mode": mode, "mix_alpha_min": mix_alpha_min}
    _, obs_j = jquad.reset_curriculum(key, jnp.int32(ep), E, **kwargs)
    jitter_u = torch.tensor(np.asarray(jax.random.uniform(key, (2,))))
    mix_u = torch.tensor(np.asarray(jax.random.uniform(
        jax.random.fold_in(key, 1), ())))
    st_t, obs_t = tquad.reset_curriculum(
        "cpu", ep, E, mode=mode, mix_alpha_min=mix_alpha_min,
        jitter_u=jitter_u, mix_u=mix_u)
    assert st_t.step == 0
    return np.asarray(obs_j), obs_t


@pytest.mark.parametrize("mode,mix_alpha_min", [
    ("anneal", 0.15), ("mix", 0.15), ("mix", 0.6), ("mix_early", 0.15)])
def test_reset_curriculum_matches_reference(mode, mix_alpha_min):
    ground = tquad.constants(torch.device("cpu"))["init_state"]
    for ep in range(0, 3 * E, 1):
        key = jax.random.PRNGKey(100 + ep)
        obs_j, obs_t = curriculum_pair(key, ep, mode, mix_alpha_min)
        close(obs_j, obs_t, err_msg=f"episode {ep}")
        on_cadence = ep % tquad.MIX_GROUND_INTERVAL == 0
        if ep >= E and (mode == "anneal" or on_cadence):
            assert torch.equal(obs_t, ground), ep  # the exact ground start
        if mode == "mix_early" and on_cadence:
            assert torch.equal(obs_t, ground), ep


def test_reset_curriculum_draws_from_the_generator():
    gen = torch.Generator().manual_seed(0)
    _, a = tquad.reset_curriculum("cpu", 1, E, gen=gen, mode="mix")
    _, b = tquad.reset_curriculum("cpu", 1, E, gen=gen, mode="mix")
    assert not torch.equal(a, b)  # a fresh jitter each episode
    again = torch.Generator().manual_seed(0)
    _, c = tquad.reset_curriculum("cpu", 1, E, gen=again, mode="mix")
    assert torch.equal(a, c)


@pytest.mark.parametrize("kwargs,match", [
    (dict(curriculum_episodes=0), "must be > 0"),
    (dict(curriculum_episodes=E, mix_alpha_min=0.1, mode="mix"),
     "must lie in"),
    (dict(curriculum_episodes=E, mix_alpha_min=1.0, mode="mix"),
     "must lie in"),
    (dict(curriculum_episodes=E, mode="spiral"), "unknown spawn"),
])
def test_reset_curriculum_range_checks(kwargs, match):
    with pytest.raises(ValueError, match=match):
        tquad.reset_curriculum("cpu", 0, **kwargs)
    jkw = dict(kwargs)
    with pytest.raises(ValueError, match=match):
        jquad.reset_curriculum(jax.random.PRNGKey(0), jnp.int32(0),
                               jkw.pop("curriculum_episodes"), **jkw)


@pytest.mark.parametrize("alpha", [0.0, 0.15, 0.5, 0.73, 1.0])
def test_spawn_at_alpha_matches_reference(alpha):
    st_j, obs_j = jquad.spawn_at_alpha(alpha)
    st_t, obs_t = tquad.spawn_at_alpha(alpha, "cpu")
    close(obs_j, obs_t)
    assert st_t.step == 0
    if alpha == 1.0:
        close(jquad.INIT_STATE, obs_t, rtol=0, atol=0)


# --- the driver's curriculum and kill terms ---------------------------------

def tiny_quad(**env_kw):
    cfg = tconfig.get_config("quadrotor")
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, max_episode_steps=20, **env_kw),
        sac=dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=4,
                                start_steps=8, pretanh_reg=0.001,
                                probe_pretanh_reg=0.01),
        node=dataclasses.replace(cfg.node, hidden_dim=8,
                                 mlp_hidden_layers=1, max_batch=8,
                                 update_interval=2),
        replay=tconfig.ReplayConfig(capacity=64, node_capacity=64))


def test_driver_checks_curriculum_and_kill_flags():
    quad = get_env("quadrotor")
    assert driver.build_step_kwargs(tiny_quad(), quad) == \
        {"kill_penalty": 250.0}
    assert driver.build_step_kwargs(
        tiny_quad(kill_attitude=0.5, kill_penalty=0.0), quad) == \
        {"kill_attitude": 0.5}
    uni = tconfig.get_config("unicycle")
    with pytest.raises(ValueError, match="quadrotor only"):
        driver.build_step_kwargs(dataclasses.replace(
            uni, env=dataclasses.replace(uni.env, kill_penalty=1.0)),
            get_env("unicycle"))
    with pytest.raises(ValueError, match="quadrotor only"):
        driver.curriculum_kwargs(dataclasses.replace(
            uni, env=dataclasses.replace(uni.env,
                                         spawn_curriculum_episodes=3)),
            get_env("unicycle"))
    with pytest.raises(ValueError, match="requires"):
        driver.curriculum_kwargs(tiny_quad(spawn_curriculum_mode="mix"),
                                 quad)
    with pytest.raises(ValueError, match="only read"):
        driver.curriculum_kwargs(tiny_quad(spawn_curriculum_episodes=3,
                                           spawn_mix_alpha_min=0.5), quad)
    assert driver.curriculum_kwargs(tiny_quad(), quad) is None
    assert driver.curriculum_kwargs(
        tiny_quad(spawn_curriculum_episodes=3,
                  spawn_curriculum_mode="mix_early"), quad) == \
        {"curriculum_episodes": 3, "mode": "mix_early",
         "mix_alpha_min": 0.15}


def test_quadrotor_episodes_run_the_curriculum_on_cpu(monkeypatch):
    """Two short episodes with the mix curriculum, the kill penalty and
    both pre-tanh regularizers: each reset goes through reset_curriculum
    with its episode index, and updates and the barrier TD run."""
    cfg = tiny_quad(spawn_curriculum_episodes=3,
                    spawn_curriculum_mode="mix", kill_attitude=1.0)
    calls = []
    real = tquad.reset_curriculum

    def spy(device, i_episode, *args, **kwargs):
        calls.append((i_episode, kwargs["mode"]))
        return real(device, i_episode, *args, **kwargs)

    monkeypatch.setattr(tquad, "reset_curriculum", spy)
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = driver.create_replays(cfg, "cpu")
    run = driver.make_episode_runner(cfg, "cpu")
    total = 0
    for ep in range(2):
        ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
    assert calls == [(0, "mix"), (1, "mix")]
    assert ts.updates > 0
    assert float(m.train["barrier_td_loss"]) > 0
    assert all(np.isfinite(float(v)) for v in m.train.values())


@pytest.mark.parametrize("preset,sac_kw,match", [
    ("quadrotor", dict(policy_type="deterministic", pretanh_reg=0.1),
     "requires the Gaussian policy"),
    ("quadrotor", dict(policy_type="deterministic", probe_pretanh_reg=0.1),
     "requires the Gaussian policy"),
    ("unicycle", dict(probe_pretanh_reg=0.1), "ground_probe_obs"),
])
def test_pretanh_regularizers_keep_the_references_errors(preset, sac_kw,
                                                         match):
    for mod, make in ((jconfig, j_make_agent),
                      (tconfig, lambda c: t_make_agent(c, "cpu"))):
        cfg = mod.get_config(preset)
        cfg = dataclasses.replace(cfg, sac=dataclasses.replace(cfg.sac,
                                                               **sac_kw))
        with pytest.raises(ValueError, match=match):
            make(cfg)
