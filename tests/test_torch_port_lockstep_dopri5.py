"""The lockstep seed runner under ``--node_solver dopri5`` and with a
constraint builder that does not declare ``SEED_AXIS``, on the CPU, against
``jax.vmap`` of the JAX package's functions and against the port's own
one-seed path:

(a) ``solve_adaptive(..., seed_axis=True)`` in both forms against
    ``jax.vmap`` of JAX's ``solve_adaptive``, on three seeds whose trial
    counts differ (a tanh field with weights at scales 0.5, 3 and 12);
(b) a seed whose trial overflows leaves the other seeds' gradients finite
    and equal to their one-seed gradients;
(c) the stacked ``odeint_adjoint`` gradients (parameters and y0) against
    ``jax.vmap(jax.grad(...))``;
(d) one seed-batched update under dopri5, both forms, against
    ``jax.vmap(update_from_batch)``, the fit gated on for some seeds only;
and tests/test_torch_port_lockstep_dopri5_runs.py (e) the runner under
each form against each seed's standalone run, the per-seed counts of
short integrations, and (f) a registered builder without ``SEED_AXIS``.

Tolerances. (a): each seed bit for bit and with the trial count of its
one-seed solve (the field's product is written out, so that a seed's
arithmetic is the one-seed arithmetic), and against JAX the one-seed
solver tests' rtol 1e-5 / atol 1e-6: ``jax.vmap`` gives each seed its
one-seed JAX solve bit for bit too, so the gap is the one-seed port's
gap from JAX (up to 2.7e-7 over rtol 1e-6 times the value here, so rtol
1e-6 / atol 1e-7 does not hold for one seed either). The inputs of (a),
(b) and (c) were checked to give each seed the trial count of its own
solve: a seed's error norm sums a slice of a stacked tensor, which may
round otherwise than the one-seed sum, so an accept decision can flip
where an error lies within float32 rounding of 1.0; none of these does.
(b):
rtol 1e-6 / atol 1e-7. (c): ``tests/test_torch_port_ode.py``'s adjoint
tolerances (values rtol 1e-5 / atol 1e-6, gradients rtol 1e-4 / atol
1e-6). (d): ``tests/test_torch_port_lockstep.py``'s seed-batched update
tolerances (metrics rtol 1e-5 / atol 1e-6; the state rtol 1e-4 / atol
1e-6), but for the NODE optimizer's moments, which hold the fit's gradient
through the adaptive solve: within ``NODE_GRAD_FRAC`` of each leaf's
largest entry, as ``tests/test_torch_port_ode.py`` holds one seed's
update. (e), (f): the runner tests' rtol 1e-4 / atol 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu.ode import adjoint as jadjoint
from nlbac_tpu.ode import solvers as jsolvers
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import (
    from_reference,
    from_reference_stacked,
    to_reference_stacked,
)
from nlbac_tpu_torch.ode import odeint_adjoint, solve_adaptive
from test_torch_port_gates import out_of_band_key
from test_torch_port_lockstep import (
    as_numpy,
    gated_cfg,
    stack_trees,
    take,
)
from test_torch_port_ode import NODE_GRAD_FRAC, close_scaled
from test_torch_port_presets import leaves_with_paths
from test_torch_port_update import make_batch

S = 3
SCALES = (0.5, 3.0, 12.0)
RTOL, ATOL = 1e-6, 1e-7
# the one-seed solver tests' tolerance against JAX (tests/test_torch_port_
# ode.py): XLA's and torch's tanh and pow round differently in the last
# bits, and the gap grows over a solve's trials
JAX_RTOL, JAX_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (the dopri5 solves are thousands of small ops)
    and full float32 matmuls."""
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


# tanh(y @ p) with the product written out, so that a seed's arithmetic
# in the stacked solve is its one-seed solve's (a batched matmul need not
# round as the one-seed matmul does)
def _tanh_j(p, t, y):
    return jnp.tanh(jnp.sum(y[..., :, None] * p[..., None, :, :], axis=-2))


def _tanh_t(p, t, y):
    return torch.tanh(torch.sum(y[..., :, None] * p[..., None, :, :],
                                dim=-2))


def _tanh_inputs():
    """Three seeds' weights (4, 4) at SCALES and states (5, 4)."""
    rng = np.random.default_rng(21)
    w = np.stack([s * rng.normal(size=(4, 4)) for s in SCALES]
                 ).astype(np.float32)
    y0 = rng.normal(size=(S, 5, 4)).astype(np.float32)
    return w, y0


def trials(trace, i=None):
    """Trials run (active) in a trace, of seed i for a stacked one."""
    return sum(int(a if i is None else a[i]) for _, _, a in trace)


# ---------------------------------------------------------------------------
# (a) the seed-batched solver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["while", "scan"])
def test_seed_axis_solve_matches_jax_vmap_and_one_seed_solves(impl):
    w, y0 = _tanh_inputs()
    kw = dict(impl=impl, max_steps=64, return_final_t=True)
    y_j, t_j = jax.vmap(lambda p, y: jsolvers.solve_adaptive(
        _tanh_j, p, y, 0.0, 1.0, **kw))(jnp.asarray(w), jnp.asarray(y0))
    trace = []
    y_t, t_t = solve_adaptive(_tanh_t, torch.tensor(w), torch.tensor(y0),
                              0.0, 1.0, seed_axis=True, trace=trace, **kw)
    assert t_t.shape == (S,) and trace[0][0].shape == (S,)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=JAX_RTOL,
                               atol=JAX_ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), rtol=RTOL)
    counts = []
    for i in range(S):
        one = []
        y_1, t_1 = solve_adaptive(_tanh_t, torch.tensor(w[i]),
                                  torch.tensor(y0[i]), 0.0, 1.0, trace=one,
                                  **kw)
        counts.append(trials(one))
        assert trials(trace, i) == counts[-1], (i, trials(trace, i),
                                                counts[-1])
        assert torch.equal(y_t[i], y_1) and float(t_t[i]) == float(t_1)
    # the seeds take their own steps: no two counts are equal
    assert len(set(counts)) == S, counts
    # the while form stops at the last seed's last trial
    assert len(trace) == (max(counts) if impl == "while" else 64)


# ---------------------------------------------------------------------------
# (b) a seed whose trial overflows
# ---------------------------------------------------------------------------

def _exp_t(p, t, y):
    return torch.exp(p[:, None] * y)


def test_overflowing_seed_keeps_the_others_gradients():
    """dy/dt = exp(p y) per seed: seed 1 (p = 5 from (1, 2)) overflows at
    its first trial and stays NaN to the end of the scan, as one seed's
    solve does (tests/test_torch_port_ode.py); seeds 0 and 2 integrate.
    Each seed's values and gradients (p and y0) equal its one-seed
    solve's: seed 1 keeps y0 and p gets none of its
    gradient, the others' are finite."""
    p0 = np.array([-0.5, 5.0, 0.3], np.float32)
    y0 = np.array([[0.4, -0.2], [1.0, 2.0], [0.1, 0.5]], np.float32)
    kw = dict(impl="scan", max_steps=32, return_final_t=True)
    p = torch.tensor(p0, requires_grad=True)
    y = torch.tensor(y0, requires_grad=True)
    trace = []
    y_t, t_t = solve_adaptive(_exp_t, p, y, 0.0, 1.0, seed_axis=True,
                              trace=trace, **kw)
    g_p, g_y = torch.autograd.grad(y_t.sum(), [p, y])
    assert np.isnan(float(trace[0][0][1].detach()))  # seed 1's first trial
    assert float(t_t[1].detach()) == 0.0
    for i in range(S):
        pi = torch.tensor(p0[i:i + 1], requires_grad=True)
        yi = torch.tensor(y0[i:i + 1], requires_grad=True)
        one = []
        y_1, t_1 = solve_adaptive(_exp_t, pi, yi, 0.0, 1.0, trace=one, **kw)
        g_1 = torch.autograd.grad(y_1.sum(), [pi, yi])
        assert trials(trace, i) == trials(one)
        np.testing.assert_allclose(y_t[i].detach().numpy(),
                                   y_1[0].detach().numpy(), rtol=RTOL,
                                   atol=ATOL)
        assert float(t_t[i].detach()) == float(t_1.detach())
        assert np.all(np.isfinite(g_p[i].numpy()))
        assert np.all(np.isfinite(g_y[i].numpy()))
        np.testing.assert_allclose(g_p[i].numpy(), g_1[0][0].numpy(),
                                   rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(g_y[i].numpy(), g_1[1][0].numpy(),
                                   rtol=RTOL, atol=ATOL)
    # seed 1 keeps y0: no gradient reaches p, y0's passes through
    assert float(g_p[1]) == 0.0 and torch.equal(g_y[1], torch.ones(2))
    assert float(g_p[0]) != 0.0 and float(g_p[2]) != 0.0


# ---------------------------------------------------------------------------
# (c) the stacked adjoint
# ---------------------------------------------------------------------------

def _stiff_j(p, t, y):
    return -4.0 * y + jnp.tanh(y @ p)


def _stiff_t(p, t, y):
    return -4.0 * y + torch.tanh(y @ p)


def test_stacked_adjoint_matches_jax_vmap_grad():
    rng = np.random.default_rng(8)
    w = np.stack([s * rng.normal(size=(3, 3)) for s in SCALES]
                 ).astype(np.float32)
    y0 = rng.normal(size=(S, 2, 3)).astype(np.float32)
    kw = dict(method="dopri5", rtol=1e-6, atol=1e-9)

    def loss_j(p, y):
        return jnp.sum(jnp.square(jadjoint.odeint_adjoint(
            _stiff_j, p, y, 0.0, 1.0, **kw)))

    v_j, (gw_j, gy_j) = jax.vmap(jax.value_and_grad(
        loss_j, argnums=(0, 1)))(jnp.asarray(w), jnp.asarray(y0))
    p = torch.tensor(w, requires_grad=True)
    y = torch.tensor(y0, requires_grad=True)
    y1, t1 = odeint_adjoint(_stiff_t, p, y, 0.0, 1.0, seed_axis=True,
                            return_final_t=True, **kw)
    v_t = torch.sum(torch.square(y1), dim=(1, 2))
    gw_t, gy_t = torch.autograd.grad(v_t.sum(), [p, y])
    assert t1.shape == (S,)
    np.testing.assert_allclose(v_t.detach().numpy(), np.asarray(v_j),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(gy_t.numpy(), np.asarray(gy_j), rtol=1e-4,
                               atol=1e-6)
    with pytest.raises(ValueError, match="not both"):
        odeint_adjoint(_stiff_t, p, y, 0.0, 1.0, seed_axis=True,
                       dp_group=object(), **kw)


# ---------------------------------------------------------------------------
# (d) one seed-batched update against jax.vmap(update_from_batch)
# ---------------------------------------------------------------------------

BATCH, NODE_BATCH = 6, 8
# each seed's update counter (gated_cfg: a fit every 3rd update, an ascent
# every 4th, a target update every 2nd): seed 0 fits, ascends and updates
# its targets; seed 1 does none of these; seed 2 ascends and updates its
# targets
COUNTERS = (0, 1, 4)


def dopri5_cfg(mod, impl, base=gated_cfg):
    cfg = base(mod)
    return dataclasses.replace(cfg, node=dataclasses.replace(
        cfg.node, solver="dopri5", adaptive_impl=impl))


@pytest.mark.parametrize("impl", ["while", "scan"])
def test_seed_batched_dopri5_update_matches_jax_vmap(impl):
    cfg_j, cfg_t = dopri5_cfg(jconfig, impl), dopri5_cfg(tconfig, impl)
    vupdate = jax.jit(jax.vmap(make_agent(cfg_j).update_from_batch,
                               in_axes=(0, 0, 0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(4), S)
    ts = jax.vmap(lambda k: create_train_state(cfg_j, k))(keys)
    ts = ts._replace(updates=jnp.asarray(COUNTERS, ts.updates.dtype))
    rng = np.random.default_rng(3)
    batches = [make_batch(rng, BATCH) for _ in range(S)]
    node_batches = [make_batch(rng, NODE_BATCH) for _ in range(S)]
    ref = as_numpy(ts)
    draws, step_keys = [], []
    for i in range(S):  # each seed's key keeps its samples out of the band
        port_i = from_reference(take(ref, i), cfg_t, "cpu")
        tb = {k: torch.tensor(v) for k, v in batches[i].items()}
        key, noise = out_of_band_key(port_i, tb, "unicycle", i, 2)
        step_keys.append(key)
        draws.append(noise)
    ts_j, m_j = vupdate(ts, stack_trees(batches), stack_trees(node_batches),
                        jnp.stack(step_keys), jnp.int32(1))

    port = from_reference_stacked(ref, cfg_t, S, "cpu")
    assert port.updates == list(COUNTERS)
    agent = t_make_agent(cfg_t, "cpu")
    tb = {k: torch.stack([torch.tensor(b[k]) for b in batches])
          for k in batches[0]}
    tnb = {k: torch.stack([torch.tensor(b[k]) for b in node_batches])
           for k in node_batches[0]}
    noise = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    port, m_t = agent.update_from_batch(port, tb, tnb, None, 1, noise=noise)

    # the fit is gated on for seed 0 alone
    assert (np.asarray(m_j["node_loss"]) > 0).tolist() == [True, False,
                                                            False]
    assert m_t["short_integrations"].tolist() == [0] * S
    for k in METRIC_NAMES:
        assert m_t[k].shape == (S,), k
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    expect = as_numpy(ts_j)
    got = to_reference_stacked(port, expect, cfg_t)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb and a.shape == b.shape, pa
        if pa.startswith(".opt['node']"):  # moments of the fit's gradient
            for i in range(S):
                close_scaled(a[i], b[i], NODE_GRAD_FRAC[impl],
                             msg=f"{pa} seed {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6,
                                       err_msg=pa)
