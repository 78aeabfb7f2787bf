"""The port's adaptive ODE stack (``nlbac_tpu_torch.ode``: ``solve_adaptive``
in its ``while`` and ``scan`` forms, ``odeint_grid``, ``odeint_adjoint``)
and the NODE paths that use it (``predict_next_state`` and one
``update_core`` of unicycle under ``--node_solver dopri5``), against the
JAX package on the CPU.

Inputs are made with numpy from seeds. Tolerances: solver values rtol 1e-5
/ atol 1e-6 (float32 both sides; XLA's and torch's pow and sums round
differently in the last bits); gradients rtol 1e-4 / atol 1e-6. The trial
counts must be equal: the fields are picked so that no trial's error lies
within 1e-3 of the accept threshold 1.0 (checked), so a mismatch means a
flipped accept, and its message carries the error sequence. One update of
unicycle: metrics rtol 1e-5 / atol 1e-6, parameters and Adam moments rtol
1e-4 / atol 1e-6, as for the Euler update (tests/test_torch_port_update.py),
but for the NODE optimizer's moments. Gradients with respect to the NODE's
weights through its adaptive solve (``predict_next_state``'s, and the
NODE fit's Adam moments) are held within 1.5e-1 (scan) and 2e-2 (while)
of the leaf's largest entry (``NODE_GRAD_FRAC``: the float32 noise of the
adaptive steps, measured against a float64 solve; see there).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu.nn import make_field as j_make_field
from nlbac_tpu.nn import node_init as j_node_init
from nlbac_tpu.nn.node import predict_next_state as j_predict
from nlbac_tpu.ode import adjoint as jadjoint
from nlbac_tpu.ode import solvers as jsolvers
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.nn import node as tnode
from nlbac_tpu_torch.ode import odeint_adjoint, odeint_grid, solve_adaptive
from nlbac_tpu_torch.ode import solvers as tsolvers
from nlbac_tpu_torch.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
MARGIN = 1e-3  # no trial error this close to the accept threshold
# Gradients through the NODE's adaptive solve (and the Adam moments made
# from them): within this fraction of the leaf's largest entry, by form.
# At dt = 0.02 the trial errors are float32 rounding noise, and under
# ``scan`` the gradient also runs through the step sizes they set.
# ``python3 scripts/dopri5_probe.py`` measures it: the
# port's float32 gradient of the fit's loss (8 rows, six seeds) lies up
# to 1.228e-1 (scan) and 1.598e-2 (while) of the leaf's largest entry
# from a float64 solve's.
NODE_GRAD_FRAC = {"scan": 1.5e-1, "while": 2e-2}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these solves are thousands of small ops, which
    other test workers' threads would slow down many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_t(tree, requires_grad=False):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a, np.float32))
                        .requires_grad_(requires_grad), tree)


def close(a, b, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(
        np.asarray(b.detach() if isinstance(b, torch.Tensor) else b),
        np.asarray(a), rtol=rtol, atol=atol, err_msg=msg)


def close_scaled(a, b, frac, msg=""):
    """max |a - b| <= frac * max |a| (+ 1e-7 for all-zero leaves)."""
    a = np.asarray(a)
    b = np.asarray(b.detach() if isinstance(b, torch.Tensor) else b)
    gap, scale = np.abs(a - b).max(), np.abs(a).max()
    assert gap <= frac * scale + 1e-7, f"{msg}: max gap {gap} vs scale {scale}"


def jax_trials(field_j, params, y0, t0, t1, **kw):
    """The JAX while-form's number of trial steps: the field's calls
    (seven a trial) with jit off, so the loop runs in Python."""
    calls = []

    def counting(p, t, y):
        calls.append(1)
        return field_j(p, t, y)

    with jax.disable_jit():
        jsolvers.solve_adaptive(counting, params, y0, t0, t1,
                                impl="while", **kw)
    return len(calls) // 7


# -- fields (as in tests/test_ode.py) ---------------------------------------

def _lin(lam):
    return (lambda p, t, y: p * y), np.float32(lam)


def _pend_j(p, t, y):
    return jnp.stack([y[1], -jnp.sin(y[0])])


def _pend_t(p, t, y):
    return torch.stack([y[1], -torch.sin(y[0])])


def _tree_j(p, t, y):
    a, b = y
    return (-a, {"v": -2.0 * b["v"]})


_tree_t = _tree_j


def _mlp_j(p, t, y):
    return jnp.tanh(y @ p) * (1.0 + t)


def _mlp_t(p, t, y):
    return torch.tanh(y @ p) * (1.0 + t)


def _stiff_j(p, t, y):
    return -4.0 * y + jnp.tanh(y @ p)


def _stiff_t(p, t, y):
    return -4.0 * y + torch.tanh(y @ p)


def _case(name):
    """(field_j, field_t, params, y0, t0, t1, solver kwargs)."""
    rng = np.random.default_rng(11)
    f = np.float32
    if name == "stiffish":
        fj, lam = _lin(-4.0)
        return fj, fj, lam, np.array([1.0], f), 0.0, 1.0, \
            dict(rtol=1e-6, atol=1e-8)
    if name == "nonlinear":
        return _pend_j, _pend_t, None, np.array([1.0, 0.0], f), 0.0, 2.0, \
            dict(rtol=1e-6, atol=1e-8)
    if name == "tree":
        y0 = (np.array([1.0, 2.0], f), {"v": np.array([3.0], f)})
        return _tree_j, _tree_t, None, y0, 0.0, 1.0, \
            dict(rtol=1e-6, atol=1e-8)
    if name == "mlp_batch":
        w = (0.5 * rng.normal(size=(4, 4))).astype(f)
        return _mlp_j, _mlp_t, w, rng.normal(size=(5, 4)).astype(f), \
            0.0, 1.0, {}
    if name == "reverse":
        fj, _ = _lin(0.0)
        return (lambda p, t, y: -0.8 * y), (lambda p, t, y: -0.8 * y), None, \
            np.array([1.0, 2.0, -3.0], f), 1.0, 0.0, {}
    if name == "truncated":
        return (lambda p, t, y: -0.8 * y), (lambda p, t, y: -0.8 * y), None, \
            np.array([1.0], f), 0.0, 1e6, \
            dict(rtol=1e-12, atol=1e-14, max_steps=4)
    raise KeyError(name)


CASES = ("stiffish", "nonlinear", "tree", "mlp_batch", "reverse",
         "truncated")


@pytest.mark.parametrize("impl", ["while", "scan"])
@pytest.mark.parametrize("name", CASES)
def test_solve_adaptive_matches_jax(name, impl):
    fj, ft, p, y0, t0, t1, kw = _case(name)
    kw = dict(kw)
    max_steps = kw.pop("max_steps", 64)
    y_j, t_j = jsolvers.solve_adaptive(
        fj, None if p is None else jnp.asarray(p),
        jax.tree.map(jnp.asarray, y0), t0, t1, impl=impl,
        max_steps=max_steps, return_final_t=True, **kw)
    trace = []
    y_t, t_t = solve_adaptive(ft, None if p is None else torch.tensor(p),
                              to_t(y0), t0, t1, impl=impl,
                              max_steps=max_steps, return_final_t=True,
                              trace=trace, **kw)
    errs = [float(e) for e, _, active in trace if bool(active)]
    assert all(abs(e - 1.0) > MARGIN for e in errs), \
        f"a trial error lies within {MARGIN} of 1.0: {errs}"
    n_j = jax_trials(fj, None if p is None else jnp.asarray(p),
                     jax.tree.map(jnp.asarray, y0), t0, t1,
                     max_steps=max_steps, **kw)
    assert len(errs) == n_j, f"trials {len(errs)} vs JAX {n_j}; port " \
                             f"errors {errs}"
    for a, b in zip(jax.tree.leaves(y_j), tree_leaves(y_t)):
        close(a, b, msg=f"errors {errs}")
    close(t_j, t_t)
    if name == "truncated":
        assert float(t_t) < 1e6 and n_j == 4
    else:
        np.testing.assert_allclose(float(t_t), t1, rtol=1e-6)


@pytest.mark.parametrize("method,steps", [("rk4", 1), ("heun", 3)])
def test_odeint_grid_matches_jax(method, steps):
    rng = np.random.default_rng(2)
    w = (0.5 * rng.normal(size=(4, 4))).astype(np.float32)
    y0 = rng.normal(size=(5, 4)).astype(np.float32)
    ts = np.array([0.0, 0.1, 0.25, 0.7], np.float32)
    out_j = jsolvers.odeint_grid(_mlp_j, jnp.asarray(w), jnp.asarray(y0),
                                 ts, method=method, steps_per_interval=steps)
    out_t = odeint_grid(_mlp_t, torch.tensor(w), torch.tensor(y0), ts,
                        method=method, steps_per_interval=steps)
    assert tuple(out_t.shape) == (4, 5, 4)
    close(out_j, out_t)
    tree0 = (np.array([1.0, 2.0], np.float32), {"v": np.array([3.0],
                                                            np.float32)})
    out_j = jsolvers.odeint_grid(_tree_j, None,
                                 jax.tree.map(jnp.asarray, tree0), ts,
                                 method=method, steps_per_interval=steps)
    out_t = odeint_grid(_tree_t, None, to_t(tree0), ts, method=method,
                        steps_per_interval=steps)
    for a, b in zip(jax.tree.leaves(out_j), tree_leaves(out_t)):
        close(a, b)


def _stiff_inputs():
    rng = np.random.default_rng(3)
    w = (0.4 * rng.normal(size=(3, 3))).astype(np.float32)
    y0 = np.array([[0.8, -0.3, 0.2], [0.1, 0.5, -0.6]], np.float32)
    return w, y0


def _grads_j(solve, w, y0):
    def loss(p, y):
        return jnp.sum(jnp.square(solve(p, y)))
    return jax.value_and_grad(loss, argnums=(0, 1))(jnp.asarray(w),
                                                    jnp.asarray(y0))


def _grads_t(solve, w, y0):
    p, y = torch.tensor(w, requires_grad=True), torch.tensor(
        y0, requires_grad=True)
    loss = torch.sum(torch.square(solve(p, y)))
    return loss, torch.autograd.grad(loss, [p, y])


@pytest.mark.parametrize("field", ["stiff", "mlp"])
def test_scan_form_gradients_match_jax(field):
    """Autograd through the scan form against JAX's reverse mode through
    its lax.scan, for the parameters and y0."""
    fj, ft = (_stiff_j, _stiff_t) if field == "stiff" else (_mlp_j, _mlp_t)
    w, y0 = _stiff_inputs()
    v_j, (gw_j, gy_j) = _grads_j(lambda p, y: jsolvers.solve_adaptive(
        fj, p, y, 0.0, 1.0, impl="scan", max_steps=32), w, y0)
    v_t, (gw_t, gy_t) = _grads_t(lambda p, y: solve_adaptive(
        ft, p, y, 0.0, 1.0, impl="scan", max_steps=32), w, y0)
    close(v_j, v_t)
    close(gw_j, gw_t, rtol=GRAD_RTOL)
    close(gy_j, gy_t, rtol=GRAD_RTOL)


@pytest.mark.parametrize("method", ["dopri5", "rk4"])
def test_odeint_adjoint_matches_jax(method):
    """The adjoint's backward integration (augmented state (y, a, g_theta),
    g_theta in the error norm) against JAX's custom VJP."""
    w, y0 = _stiff_inputs()
    kw = dict(method=method, rtol=1e-6, atol=1e-9) if method == "dopri5" \
        else dict(method=method, num_steps=16)
    v_j, (gw_j, gy_j) = _grads_j(lambda p, y: jadjoint.odeint_adjoint(
        _stiff_j, p, y, 0.0, 1.0, **kw), w, y0)
    v_t, (gw_t, gy_t) = _grads_t(lambda p, y: odeint_adjoint(
        _stiff_t, p, y, 0.0, 1.0, **kw), w, y0)
    close(v_j, v_t)
    close(gw_j, gw_t, rtol=GRAD_RTOL)
    close(gy_j, gy_t, rtol=GRAD_RTOL)


def test_adjoint_dopri5_matches_scan_form():
    """Within the port: the adjoint's gradients of the while form agree
    with autograd through the scan form (tests/test_ode.py:170 holds the
    JAX adjoint against a fine fixed grid)."""
    w, y0 = _stiff_inputs()
    kw = dict(rtol=1e-6, atol=1e-9)
    _, g_adj = _grads_t(lambda p, y: odeint_adjoint(
        _stiff_t, p, y, 0.0, 1.0, method="dopri5", **kw), w, y0)
    _, g_scan = _grads_t(lambda p, y: solve_adaptive(
        _stiff_t, p, y, 0.0, 1.0, impl="scan", max_steps=64, **kw), w, y0)
    for a, b in zip(g_adj, g_scan):
        close(b, a, rtol=1e-3, atol=2e-4)


def _exp_j(p, t, y):
    return jnp.exp(p * y)


def _exp_t(p, t, y):
    return torch.exp(p * y)


@pytest.mark.parametrize("p0,y0,t1,tol,before", [
    (5.0, (1.0, 2.0), 1.0, None, 0),
    (1.0, (1.5, 0.75), 2.0, 1e-3, 2),
])
def test_rejected_overflowing_trial_keeps_the_gradient_finite(
        p0, y0, t1, tol, before):
    """dy/dt = exp(p y): after ``before`` trials (one rejected and one
    accepted in the second case) a trial overflows; its NaN error leaves
    every later step NaN, so both packages stop at the same t with the
    same values. The port's gradient is finite and equals the gradient of
    the same solve stopped just before the overflowing trial; JAX's, in
    the first case, is NaN (the rejected trial's zero cotangent meets its
    infinities)."""
    y0 = np.array(y0, np.float32)
    kw = {} if tol is None else dict(rtol=tol, atol=tol)

    def solve_j(p, steps):
        y, t = jsolvers.solve_adaptive(_exp_j, p, jnp.asarray(y0), 0.0, t1,
                                       impl="scan", max_steps=steps,
                                       return_final_t=True, **kw)
        return jnp.sum(y), (y, t)

    (_, (y_j, t_j)), g_j = jax.value_and_grad(
        solve_j, has_aux=True)(jnp.float32(p0), 32)
    if before == 0:
        assert np.isnan(float(g_j))  # the fault this guards against
    (_, (y_k, _)), g_k = jax.value_and_grad(
        solve_j, has_aux=True)(jnp.float32(p0), before)

    p = torch.tensor(p0, requires_grad=True)
    trace = []
    y_t, t_t = solve_adaptive(_exp_t, p, torch.tensor(y0), 0.0, t1,
                              impl="scan", max_steps=32,
                              return_final_t=True, trace=trace, **kw)
    errs = [float(e.detach()) for e, _, _ in trace]
    assert all(np.isfinite(errs[:before])) and np.isnan(errs[before]), errs
    (g_t,) = torch.autograd.grad(y_t.sum(), [p])
    close(y_j, y_t, msg=f"errors {errs}")
    close(t_j, t_t)
    close(y_k, y_t)
    assert np.isfinite(float(g_t))
    if before == 0:
        assert float(g_t) == 0.0
    else:
        close(g_k, g_t, rtol=GRAD_RTOL)


# -- the NODE paths -----------------------------------------------------------

def _node_cfgs(impl):
    kw = dict(form="control_affine", state_dim=3, action_dim=2,
              hidden_dim=12, f_hidden_layers=2, g_hidden_layers=2,
              solver="dopri5", adaptive_impl=impl)
    return jconfig.NodeConfig(**kw), tconfig.NodeConfig(**kw)


@pytest.mark.parametrize("impl", ["while", "scan"])
def test_predict_next_state_dopri5_matches_jax(impl):
    """Values, and the gradients with respect to the NODE parameters (the
    fit) and the action (the constraint rollout)."""
    cfg_j, cfg_t = _node_cfgs(impl)
    params = j_node_init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(16, 3)).astype(np.float32)
    u = rng.normal(size=(16, 2)).astype(np.float32)
    cot = rng.normal(size=(16, 3)).astype(np.float32)
    field_j = j_make_field(cfg_j)

    def loss_j(p, uu):
        pred = j_predict(cfg_j, p, jnp.asarray(x), uu, 0.02, field=field_j)
        return jnp.sum(pred * cot), pred

    (_, pred_j), (gp_j, gu_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(params, jnp.asarray(u))
    p_t = to_t(params, requires_grad=True)
    u_t = torch.tensor(u, requires_grad=True)
    shorts = []
    pred_t = tnode.predict_next_state(cfg_t, p_t, torch.tensor(x), u_t, 0.02,
                                      shorts=shorts)
    grads = torch.autograd.grad(torch.sum(pred_t * torch.tensor(cot)),
                                tree_leaves(p_t) + [u_t])
    close(pred_j, pred_t)
    for i, (a, b) in enumerate(zip(jax.tree.leaves(gp_j), grads[:-1])):
        close_scaled(a, b, NODE_GRAD_FRAC[impl], msg=f"gradient {i}")
    close(gu_j, grads[-1], rtol=GRAD_RTOL, msg="action gradient")
    assert [bool(s) for s in shorts] == [False]


def test_short_scan_integrations_are_counted():
    """An exhausted ``adaptive_scan_steps`` is reported: the integration
    ends short of dt (the JAX package returns the same partial state) and
    the count says so."""
    cfg_j, cfg_t = _node_cfgs("scan")
    cfg_j = dataclasses.replace(cfg_j, adaptive_scan_steps=1)
    cfg_t = dataclasses.replace(cfg_t, adaptive_scan_steps=1)
    params = j_node_init(jax.random.PRNGKey(0), cfg_j)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(4, 3)).astype(np.float32)
    u = rng.normal(size=(4, 2)).astype(np.float32)
    pred_j = j_predict(cfg_j, params, jnp.asarray(x), jnp.asarray(u), 0.02)
    shorts = []
    pred_t = tnode.predict_next_state(cfg_t, to_t(params), torch.tensor(x),
                                      torch.tensor(u), 0.02, shorts=shorts)
    close(pred_j, pred_t)
    assert [bool(s) for s in shorts] == [True]


BATCH, NODE_BATCH = 6, 8


def _tiny_cfg(mod, impl):
    cfg = mod.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH),
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, max_batch=NODE_BATCH,
                                 solver="dopri5", adaptive_impl=impl),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def _batch(rng, n):
    f = np.float32
    return {
        "obs": rng.normal(size=(n, 7)).astype(f),
        "action": rng.uniform([-3.5, -12], [3.5, 12], size=(n, 2)).astype(f),
        "reward": rng.normal(size=n).astype(f),
        "constraint": np.abs(rng.normal(size=n)).astype(f),
        "lyap_t": rng.normal(size=(n, 2)).astype(f),
        "lyap_t1": rng.normal(size=(n, 2)).astype(f),
        "barrier_signal": np.zeros(n, f),
        "next_obs": rng.normal(size=(n, 7)).astype(f),
        "mask": (rng.uniform(size=n) > 0.2).astype(f),
        "t": rng.uniform(size=n).astype(f),
        "next_t": rng.uniform(size=n).astype(f),
    }


def _leaves_with_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), np.asarray(v)) for p, v in flat]


@functools.lru_cache(maxsize=None)
def _jax_update(impl):
    cfg_j = _tiny_cfg(jconfig, impl)
    return cfg_j, jax.jit(make_agent(cfg_j).update_from_batch)


@pytest.mark.parametrize("node_fit", [True, False])
@pytest.mark.parametrize("impl", ["while", "scan"])
def test_update_core_dopri5_matches_jax(impl, node_fit):
    """One update of unicycle under dopri5 from the same state, the JAX
    draws injected (tests/test_torch_oracle_update.py:89-107): fit gated on
    (update 0) and off (update 1)."""
    cfg_j, update = _jax_update(impl)
    rng = np.random.default_rng(0)
    ts = create_train_state(cfg_j, jax.random.PRNGKey(0))
    if not node_fit:
        ts, _ = update(ts, _batch(rng, BATCH), _batch(rng, NODE_BATCH),
                       jax.random.PRNGKey(3), jnp.int32(0))
    batch, node_batch = _batch(rng, BATCH), _batch(rng, NODE_BATCH)
    key = jax.random.PRNGKey(7)
    ts_j, m_j = update(ts, batch, node_batch, key, jnp.int32(0))
    keys = jax.random.split(key, 8)
    noise = {name: torch.tensor(np.asarray(
        jax.random.normal(keys[i], (BATCH, 2), jnp.float32)))
        for name, i in (("next", 2), ("pi", 3), ("backup", 5))}

    ref = jax.tree.map(np.asarray, ts)
    cfg_t = _tiny_cfg(tconfig, impl)
    port = from_reference(ref, cfg_t, "cpu")
    agent = t_make_agent(cfg_t, "cpu")
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tnb = {k: torch.tensor(v) for k, v in node_batch.items()}
    port, m_t = agent.update_core(port, tb, lambda: tnb, None, 0,
                                  noise=noise)
    assert (float(m_j["node_loss"]) > 0) == node_fit
    for k in METRIC_NAMES:
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=k)
    assert int(m_t["short_integrations"]) == 0
    expect = jax.tree.map(np.asarray, ts_j)
    got = to_reference(port, expect)
    for (pa, a), (pb, b) in zip(_leaves_with_paths(expect),
                                _leaves_with_paths(got)):
        assert pa == pb
        if pa.startswith(".opt['node']"):  # moments of the fit's gradient
            close_scaled(a, b, NODE_GRAD_FRAC[impl], msg=pa)
        else:
            np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=ATOL,
                                       err_msg=pa)


def test_odeint_front_end_routes_dopri5():
    fj, lam = _lin(-1.3)
    y0 = np.array([0.5, -0.4], np.float32)
    y_j = jsolvers.odeint(fj, jnp.float32(lam), jnp.asarray(y0), 0.0, 0.7,
                          method="dopri5", impl="scan", max_steps=16)
    y_t = tsolvers.odeint(fj, torch.tensor(lam), torch.tensor(y0), 0.0, 0.7,
                          method="dopri5", impl="scan", max_steps=16)
    close(y_j, y_t)
    with pytest.raises(ValueError, match="unknown method"):
        tsolvers.odeint(fj, torch.tensor(lam), torch.tensor(y0), 0.0, 0.7,
                        method="bogus")
