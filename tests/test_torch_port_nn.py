"""The port's nn/ and ode/ modules against the JAX package's, on the CPU.

The same weights and inputs (made with numpy from a seed) go through both;
float32 on both sides, so the tolerance (rtol 1e-5, atol 1e-6) covers only
the different summation order of the two frameworks' matmuls.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import nn as jnn
from nlbac_tpu.config import NodeConfig as JNodeConfig
from nlbac_tpu.ode import solvers as jsolvers
from nlbac_tpu_torch import nn as tnn
from nlbac_tpu_torch.config import NodeConfig as TNodeConfig
from nlbac_tpu_torch.ode import solvers as tsolvers
from nlbac_tpu_torch.tree import tree_leaves

RTOL, ATOL = 1e-5, 1e-6


def to_torch(tree, requires_grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(requires_grad),
        tree)


def close(a, b, rtol=RTOL, atol=ATOL):
    if isinstance(b, torch.Tensor):
        b = b.detach().numpy()
    np.testing.assert_allclose(np.asarray(a), b, rtol=rtol, atol=atol)


def rand(rng, *shape, scale=1.0):
    return (scale * rng.normal(size=shape)).astype(np.float32)


def test_mlp_apply_and_init_shapes():
    rng = np.random.default_rng(0)
    params = jnn.mlp_init(jax.random.PRNGKey(0), [5, 16, 16, 3])
    x = rand(rng, 9, 5)
    close(jnn.mlp_apply(params, x),
          tnn.mlp_apply(to_torch(params), torch.tensor(x)))
    close(jnn.mlp_apply(params, x, final_activation=jax.nn.relu),
          tnn.mlp_apply(to_torch(params), torch.tensor(x),
                        final_activation=torch.relu))
    gen = torch.Generator().manual_seed(0)
    tp = tnn.mlp_init(gen, tnn.mlp_sizes(5, 16, 2, 3))
    assert [tuple(w.shape) for w in tp["w"]] == \
        [tuple(w.shape) for w in params["w"]]
    assert all(float(b.abs().max()) == 0.0 for b in tp["b"])
    a = np.sqrt(6.0 / (16 + 16))
    w = tnn.xavier_uniform(gen, (16, 16))
    assert float(w.abs().max()) <= a and float(w.abs().max()) > 0.5 * a


def test_gaussian_policy_sample_with_injected_noise():
    rng = np.random.default_rng(1)
    params = jnn.gaussian_policy_init(jax.random.PRNGKey(1), 7, 2, 24)
    spec_j = jnn.ActionSpec.from_bounds([-3.5, -12.0], [3.5, 12.0])
    spec_t = tnn.ActionSpec.from_bounds([-3.5, -12.0], [3.5, 12.0])
    obs = rand(rng, 6, 7)
    key = jax.random.PRNGKey(5)
    a_j, logp_j, det_j = jnn.gaussian_policy_sample(params, obs, key, spec_j)
    noise = np.asarray(jax.random.normal(key, (6, 2), jnp.float32))
    a_t, logp_t, det_t = tnn.gaussian_policy_sample(
        to_torch(params), torch.tensor(obs), spec_t,
        noise=torch.tensor(noise))
    close(a_j, a_t)
    close(logp_j, logp_t, rtol=1e-5, atol=1e-5)
    close(det_j, det_t)
    mean_j, log_std_j = jnn.gaussian_policy_forward(params, obs)
    mean_t, log_std_t = tnn.gaussian_policy_forward(to_torch(params),
                                                    torch.tensor(obs))
    close(mean_j, mean_t)
    close(log_std_j, log_std_t)


def test_log_std_clamp_and_deterministic_head():
    rng = np.random.default_rng(2)
    params = jnn.gaussian_policy_init(jax.random.PRNGKey(2), 7, 2, 8)
    params["log_std"]["b"][0] = jnp.array([50.0, -50.0])
    obs = rand(rng, 4, 7)
    _, log_std = tnn.gaussian_policy_forward(to_torch(params),
                                             torch.tensor(obs))
    assert float(log_std[:, 0].min()) == tnn.policy.LOG_SIG_MAX
    assert float(log_std[:, 1].max()) == tnn.policy.LOG_SIG_MIN

    dparams = jnn.deterministic_policy_init(jax.random.PRNGKey(3), 7, 2, 8)
    spec_j = jnn.ActionSpec.from_bounds([-1.0, -2.0], [1.0, 2.0])
    spec_t = tnn.ActionSpec.from_bounds([-1.0, -2.0], [1.0, 2.0])
    key = jax.random.PRNGKey(4)
    a_j, lp_j, m_j = jnn.deterministic_policy_sample(dparams, obs, key,
                                                      spec_j)
    noise = np.asarray(jax.random.normal(key, (4, 2)))
    a_t, lp_t, m_t = tnn.deterministic_policy_sample(
        to_torch(dparams), torch.tensor(obs), spec_t,
        noise=torch.tensor(noise))
    close(a_j, a_t)
    close(m_j, m_t)
    close(lp_j, lp_t)


def test_critics_and_soft_update():
    rng = np.random.default_rng(3)
    obs, act = rand(rng, 6, 7), rand(rng, 6, 2)
    q = jnn.twin_q_init(jax.random.PRNGKey(0), 7, 2, 24)
    q1_j, q2_j = jnn.twin_q_apply(q, obs, act)
    q1_t, q2_t = tnn.twin_q_apply(to_torch(q), torch.tensor(obs),
                                  torch.tensor(act))
    close(q1_j, q1_t)
    close(q2_j, q2_t)
    lyap = jnn.lyapunov_init(jax.random.PRNGKey(1), 2, 24)
    close(jnn.lyapunov_apply(lyap, act),
          tnn.lyapunov_apply(to_torch(lyap), torch.tensor(act)))
    bar = jnn.barrier_init(jax.random.PRNGKey(2), 7, 2, 24)
    close(jnn.barrier_apply(bar, obs, act),
          tnn.barrier_apply(to_torch(bar), torch.tensor(obs),
                            torch.tensor(act)))
    val = jnn.value_init(jax.random.PRNGKey(3), 7, 24)
    close(jnn.value_apply(val, obs),
          tnn.value_apply(to_torch(val), torch.tensor(obs)))

    q_other = jnn.twin_q_init(jax.random.PRNGKey(9), 7, 2, 24)
    target_j = jnn.soft_update(q, q_other, 0.005)
    target_t = tnn.soft_update(to_torch(q), to_torch(q_other), 0.005)
    for a, b in zip(jax.tree.leaves(target_j), tree_leaves(target_t)):
        close(a, b)


@pytest.mark.parametrize("method", ["euler", "midpoint", "heun", "rk4"])
def test_fixed_step_solvers(method):
    rng = np.random.default_rng(4)
    w = rand(rng, 4, 4, scale=0.5)
    y0 = rand(rng, 5, 4)

    def field_j(p, t, y):
        return jnp.tanh(y @ p) * (1.0 + t)

    def field_t(p, t, y):
        return torch.tanh(y @ p) * (1.0 + t)

    for steps in (1, 3):
        y_j = jsolvers.odeint(field_j, w, y0, 0.0, 0.1, method=method,
                              num_steps=steps)
        y_t = tsolvers.odeint(field_t, torch.tensor(w), torch.tensor(y0),
                              0.0, 0.1, method=method, num_steps=steps)
        close(y_j, y_t)
    # the adaptive method through the same front end (its own tests are in
    # tests/test_torch_port_ode.py)
    y_j = jsolvers.odeint(field_j, w, y0, 0.0, 0.1, method="dopri5")
    y_t = tsolvers.odeint(field_t, torch.tensor(w), torch.tensor(y0), 0.0,
                          0.1, method="dopri5")
    close(y_j, y_t)


@pytest.mark.parametrize("form", ["control_affine", "mlp"])
def test_node_loss_and_train_step(form):
    """node_loss and one Adam step of node_train_step, against
    nlbac_tpu.nn.node (the mlp form through the generic solver path)."""
    import optax

    kw = dict(form=form, state_dim=3, action_dim=2, hidden_dim=12,
              f_hidden_layers=2, g_hidden_layers=2, mlp_hidden_layers=2)
    if form == "mlp":
        kw["time_input"] = True
    cfg_j, cfg_t = JNodeConfig(**kw), TNodeConfig(**kw)
    rng = np.random.default_rng(5)
    x, u, x1 = rand(rng, 16, 3), rand(rng, 16, 2), rand(rng, 16, 3)
    t = rand(rng, 16, 1)
    params = jnn.node_init(jax.random.PRNGKey(0), cfg_j)
    opt = optax.adam(cfg_j.lr)
    p_j, _, loss_j = jnn.node_train_step(cfg_j, params, opt.init(params),
                                         opt, x, u, x1, 0.02, t=t)
    tp = to_torch(params, requires_grad=True)
    topt = torch.optim.Adam(tree_leaves(tp), lr=cfg_t.lr)
    args = (torch.tensor(x), torch.tensor(u), torch.tensor(x1), 0.02)
    tt = torch.tensor(t)
    close(jnn.node_loss(cfg_j, params, x, u, x1, 0.02, t=t),
          tnn.node_loss(cfg_t, tp, *args, t=tt))
    loss_t = tnn.node_train_step(cfg_t, tp, topt, *args, t=tt)
    close(loss_j, loss_t)
    for a, b in zip(jax.tree.leaves(p_j), tree_leaves(tp)):
        close(a, b)
    field_j, field_t = jnn.make_field(cfg_j), tnn.make_field(cfg_t)
    s = np.concatenate([x, u] + ([t] if form == "mlp" else []), axis=1)
    close(field_j(p_j, 0.0, s), field_t(tp, 0.0, torch.tensor(s)))


def test_normalized_mlp_field():
    kw = dict(form="mlp", state_dim=3, action_dim=2, hidden_dim=8,
              mlp_hidden_layers=2, normalize=True,
              state_scale=(2.0, 1.0, 5.0), action_scale=(4.0, 0.5))
    cfg_j, cfg_t = JNodeConfig(**kw), TNodeConfig(**kw)
    rng = np.random.default_rng(6)
    params = jnn.node_init(jax.random.PRNGKey(1), cfg_j)
    s = rand(rng, 5, 5)
    close(jnn.make_field(cfg_j)(params, 0.0, s),
          tnn.make_field(cfg_t)(to_torch(params), 0.0, torch.tensor(s)))
    bad = dataclasses.replace(cfg_t, form="control_affine")
    with pytest.raises(ValueError, match="normalize"):
        tnn.make_field(bad)


def test_bfloat16_node_takes_the_plain_field(monkeypatch):
    """A ``compute_dtype='bfloat16'`` control-affine NODE steps through the
    plain bf16 field, as the JAX package's does through XLA: its
    ``predict_next_state`` never calls ``node_euler_step`` (the kernel
    computes float32 only), where the float32 config does. Against JAX's
    bf16 prediction: atol 1e-5 (the two libraries round the same bf16
    products; here they agree bit for bit), a tenth of the gap to the
    float32 prediction (1.3e-4 here), which the test also checks."""
    from nlbac_tpu.nn.node import predict_next_state as j_predict
    from nlbac_tpu_torch.nn import node as tnode

    kw = dict(state_dim=3, action_dim=2, hidden_dim=12, f_hidden_layers=2,
              g_hidden_layers=2, compute_dtype="bfloat16")
    cfg_j, cfg_t = JNodeConfig(**kw), TNodeConfig(**kw)
    rng = np.random.default_rng(7)
    x, u = rand(rng, 16, 3), rand(rng, 16, 2)
    params = jnn.node_init(jax.random.PRNGKey(3), cfg_j)
    calls = []
    kernel = tnode.node_euler_step

    def counted(*args, **kwargs):
        calls.append(kwargs.get("compute_dtype"))
        return kernel(*args, **kwargs)

    monkeypatch.setattr(tnode, "node_euler_step", counted)
    tp = to_torch(params, requires_grad=True)
    pred = tnode.predict_next_state(cfg_t, tp, torch.tensor(x),
                                    torch.tensor(u), 0.02)
    assert calls == []
    close(j_predict(cfg_j, params, x, u, 0.02), pred, rtol=0, atol=1e-5)
    grads = torch.autograd.grad(pred.sum(), tree_leaves(tp))
    assert all(torch.isfinite(g).all() for g in grads)
    f32 = dataclasses.replace(cfg_t, compute_dtype=None)
    pred32 = tnode.predict_next_state(f32, tp, torch.tensor(x),
                                      torch.tensor(u), 0.02)
    assert calls == [None]
    assert float((pred32 - pred).detach().abs().max()) > 1e-4
