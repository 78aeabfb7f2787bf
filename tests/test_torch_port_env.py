"""The port's replay, unicycle env, unicycle constraints and trap supervisor
against the JAX package's, on the CPU.

float32 on both sides; rtol 1e-5 / atol 1e-5 covers the different
evaluation order of sin/cos/atan2 and of the summations (the CBF columns
divide differences of O(1) barrier values by dt = 0.02, which scales
rounding by 50).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import replay as jreplay
from nlbac_tpu.config import ConstraintConfig as JCC
from nlbac_tpu.config import NodeConfig as JNC
from nlbac_tpu.config import SupervisorConfig as JSC
from nlbac_tpu.constraints import backup_loss as j_backup_loss
from nlbac_tpu.constraints import primary_loss as j_primary_loss
from nlbac_tpu.constraints import unicycle as jterms
from nlbac_tpu.envs import unicycle as jenv
from nlbac_tpu.nn import lyapunov_init, node_init
from nlbac_tpu.train import supervisor as jsup
from nlbac_tpu_torch import replay as treplay
from nlbac_tpu_torch.config import ConstraintConfig as TCC
from nlbac_tpu_torch.config import NodeConfig as TNC
from nlbac_tpu_torch.config import SupervisorConfig as TSC
from nlbac_tpu_torch.constraints import backup_loss as t_backup_loss
from nlbac_tpu_torch.constraints import primary_loss as t_primary_loss
from nlbac_tpu_torch.constraints import unicycle as tterms
from nlbac_tpu_torch.envs import unicycle as tenv
from nlbac_tpu_torch.train import supervisor as tsup

RTOL, ATOL = 1e-5, 1e-5


def close(a, b, rtol=RTOL, atol=ATOL):
    if isinstance(b, torch.Tensor):
        b = b.detach().numpy()
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol)


def to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def test_replay_layout_push_mask_and_sample():
    assert treplay.make_layout(7, 2, 2) == jreplay.make_layout(7, 2, 2)
    assert sum(w for _, _, w in treplay.make_layout(7, 2, 2)) == 26
    for dims in ((10, 1, 4), (11, 2, 11), (6, 2, 2)):
        assert treplay.make_layout(*dims) == jreplay.make_layout(*dims)

    rng = np.random.default_rng(0)
    jb = jreplay.create(5, 7, 2, 2)
    tb = treplay.create(5, 7, 2, 2, device="cpu")
    pushes = [True, False, True, True, True, False, True, True]
    for do in pushes:
        rec = {name: rng.normal(size=(w,)).astype(np.float32)
               for name, _, w in jb.layout}
        jb = jreplay.push(jb, rec, do_push=do)
        treplay.push(tb, {k: torch.tensor(v) for k, v in rec.items()},
                     do_push=do)
    close(jb.data, tb.data, rtol=0, atol=0)
    assert (int(jb.position), int(jb.size), int(jb.total)) == \
        (tb.position, tb.size, tb.total) == (1, 5, 6)
    for name in ("obs", "reward", "next_t"):
        close(jb.field(name), tb.field(name), rtol=0, atol=0)

    gen = torch.Generator().manual_seed(0)
    batch = treplay.sample(tb, gen, 64)
    rows = tb.data
    for i in range(64):  # every sampled record is a stored row
        row = torch.cat([batch[n][i].reshape(-1)
                         for n, _, _ in tb.layout])
        assert (rows == row).all(dim=1).any()
    assert batch["reward"].shape == (64,) and batch["obs"].shape == (64, 7)


def test_env_step_reset_and_obs_maps():
    st_j, obs_j = jenv.reset(jax.random.PRNGKey(0))
    st_t, obs_t = tenv.reset("cpu")
    close(obs_j, obs_t)
    close(st_j.last_goal_dist, st_t.last_goal_dist, rtol=0, atol=0)

    rng = np.random.default_rng(1)
    for i in range(40):
        x = rng.uniform(-3, 3, size=3).astype(np.float32)
        if i % 8 == 0:  # near the goal, so goal_met fires too
            x[:2] = jenv.GOAL + rng.uniform(-0.2, 0.2, 2)
        a = rng.uniform([-3.5, -12], [3.5, 12]).astype(np.float32)
        steps = int(rng.integers(0, 1200))
        last = np.float32(rng.uniform(0, 5))
        sj = jenv.UnicycleState(x=jnp.asarray(x), step=jnp.int32(steps),
                                last_goal_dist=jnp.float32(last))
        stj, oj = jenv.step(sj, jnp.asarray(a), barrier_B=-20.0,
                            max_episode_steps=600)
        stt, ot = tenv.step(
            tenv.UnicycleState(x=torch.tensor(x), step=steps,
                               last_goal_dist=torch.tensor(last)),
            torch.tensor(a), barrier_B=-20.0, max_episode_steps=600)
        close(stj.x, stt.x)
        assert int(stj.step) == stt.step
        for name in oj._fields:
            close(getattr(oj, name), getattr(ot, name))

    states = rng.normal(size=(16, 3)).astype(np.float32)
    close(jenv.state_to_obs(states), tenv.state_to_obs(torch.tensor(states)))
    obs = np.asarray(jenv.state_to_obs(states))
    close(jenv.obs_to_state(obs), tenv.obs_to_state(torch.tensor(obs)))
    close(jenv.HAZARDS, torch.tensor(tenv.HAZARDS), rtol=0, atol=0)


def _terms_inputs(seed=2, rows=6):
    ncfg_kw = dict(form="control_affine", state_dim=3, action_dim=2,
                   hidden_dim=12, f_hidden_layers=2, g_hidden_layers=2)
    rng = np.random.default_rng(seed)
    node = node_init(jax.random.PRNGKey(seed), JNC(**ncfg_kw))
    lyap = lyapunov_init(jax.random.PRNGKey(seed + 1), 2, 16)
    states = rng.uniform(-2.5, 2.5, size=(rows, 3)).astype(np.float32)
    obs = np.asarray(jenv.state_to_obs(states))
    action = rng.uniform([-3.5, -12], [3.5, 12],
                         size=(rows, 2)).astype(np.float32)
    lyap_t = rng.normal(size=(rows, 2)).astype(np.float32)
    return ncfg_kw, node, lyap, obs, action, lyap_t


@pytest.mark.parametrize("include_clf", [True, False])
def test_unicycle_terms(include_clf):
    ncfg_kw, node, lyap, obs, action, lyap_t = _terms_inputs()
    ccfg = JCC()
    tj = jterms.terms(ccfg, JNC(**ncfg_kw), node, None, lyap, obs, action,
                      lyap_t, None, 0.02, include_clf=include_clf)
    tt = tterms.terms(TCC(), TNC(**ncfg_kw), to_torch(node), None,
                      to_torch(lyap), torch.tensor(obs), torch.tensor(action),
                      torch.tensor(lyap_t), None, 0.02,
                      include_clf=include_clf)
    assert tt.shape == tj.shape == (6, 8 if include_clf else 7)
    close(tj, tt)


@pytest.mark.parametrize("do_lam,ratio_floor,cost_limit",
                         [(True, 0.0, 0.0), (False, 0.0, 0.0),
                          (True, 0.002, 0.3)])
def test_primary_and_backup_loss(do_lam, ratio_floor, cost_limit):
    rng = np.random.default_rng(3)
    terms = rng.normal(size=(6, 8)).astype(np.float32)
    # a zero CLF column exercises the 1e-12 clamp of the ratio denominator
    zero_clf = terms.copy()
    zero_clf[:, -1] = -1.0
    kw = dict(ratio_floor=ratio_floor, cost_limit=cost_limit)
    cj, ct = JCC(**kw), TCC(**kw)
    lam = rng.uniform(0, 3, size=8).astype(np.float32)
    rho = np.float32(1.7)
    for m in (terms, zero_clf):
        # batch size 8 (configured) != 6 rows: the means divide by 8
        lj, lamj, rhoj = j_primary_loss(cj, m, lam, rho, do_lam, 8)
        lt, lamt, rhot = t_primary_loss(ct, torch.tensor(m),
                                        torch.tensor(lam),
                                        torch.tensor(rho), do_lam, 8)
        close(lj, lt)
        close(lamj, lamt)
        close(rhoj, rhot)
        bj, blamj, brhoj = j_backup_loss(cj, m[:, :7], lam[:7], rho,
                                         do_lam, 8, do_rho_growth=False)
        bt, blamt, brhot = t_backup_loss(ct, torch.tensor(m[:, :7]),
                                         torch.tensor(lam[:7]),
                                         torch.tensor(rho), do_lam, 8,
                                         do_rho_growth=False)
        close(bj, bt)
        close(blamj, blamt)
        close(brhoj, brhot)


def test_trap_supervisor_on_scripted_positions():
    """A scripted run: move, stall until the machine fires, then escape
    under the backup controller; compare every state after every step."""
    kw = dict(kind="trap", window=6, min_steps=5, trap_threshold=0.01,
              trap_count=3, backup_max_steps=4, escape_distance_sq=0.6)
    cj, ct = JSC(**kw), TSC(**kw)
    sj = jsup.init_supervisor(cj)
    st = tsup.init_supervisor(ct, "cpu")
    pos = np.zeros(2, np.float32)
    moves = ([0.3] * 4 + [0.0] * 12 + [0.05] * 6 + [0.5] * 3 + [0.0] * 10)
    fired = False
    for i, dx in enumerate(moves):
        start = i >= 2
        aj, sj = jsup.pre_action(cj, sj, start)
        at, st = tsup.pre_action(ct, st, start)
        assert bool(aj) == bool(at)
        pos = pos + np.float32(dx)
        out = jenv.StepOut(*[None] * 13)._replace(lyap_t1=jnp.asarray(pos))
        sj = jsup.post_step(cj, sj, None, out, i + 1, start)
        st = tsup.post_step(ct, st, None,
                            out._replace(lyap_t1=torch.tensor(pos)),
                            i + 1, start)
        fired = fired or bool(sj.use_backup)
        assert int(sj.ptr) == st.ptr
        for name in ("positions", "use_backup", "backup_time",
                     "violation_time", "anchor"):
            close(getattr(sj, name), getattr(st, name), rtol=0, atol=0)
    assert fired


def test_none_supervisor_never_engages():
    st = tsup.init_supervisor(TSC(kind="none"), "cpu")
    active, st2 = tsup.pre_action(TSC(kind="none"), st, True)
    assert not bool(active) and st2 is st
    with pytest.raises(ValueError, match="unknown supervisor kind"):
        tsup.init_supervisor(dataclasses.replace(TSC(), kind="rush"),
                             "cpu")
