"""The NODE Euler kernel module (nlbac_tpu_torch/ops/node_kernel.py).

On the CPU: the plain version against the JAX package's
``predict_next_state`` (control-affine field, one Euler step) and its
``jax.grad`` in params, x and u, at the unicycle (3, 2) and pvtol (6, 2)
dimensions; the autograd.Function path's gradients against plain autograd;
the wrapper's input checks. float32 on both sides: rtol 1e-5 / atol 1e-6
covers the frameworks' different summation order.

The CUDA kernel itself is tested in test_torch_port_gpu.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu.config import NodeConfig as JNodeConfig
from nlbac_tpu.nn import node_init, predict_next_state
from nlbac_tpu_torch.ops import node_kernel as nk
from nlbac_tpu_torch.tree import tree_leaves

DT = 0.02
HID = 12


def setup(n_s, n_u, rows=9, seed=0):
    cfg = JNodeConfig(form="control_affine", state_dim=n_s, action_dim=n_u,
                      hidden_dim=HID, f_hidden_layers=4, g_hidden_layers=3)
    params = node_init(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    # non-zero biases, so the bias path is exercised too
    params = jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        params)
    x = rng.normal(size=(rows, n_s)).astype(np.float32)
    u = rng.normal(size=(rows, n_u)).astype(np.float32)
    return cfg, params, x, u


def to_torch(tree, requires_grad=False):
    return jax.tree.map(
        lambda a: torch.tensor(np.asarray(a)).requires_grad_(requires_grad),
        tree)


def close(a, b, rtol=1e-5, atol=1e-6):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("dims", [(3, 2), (6, 2)])
def test_plain_matches_jax_forward_and_grads(dims):
    cfg, params, x, u = setup(*dims)
    rng = np.random.default_rng(1)
    cot = rng.normal(size=(x.shape[0], dims[0])).astype(np.float32)

    def loss_j(p, xx, uu):
        return jnp.sum(predict_next_state(cfg, p, xx, uu, DT) * cot)

    y_j = predict_next_state(cfg, params, x, u, DT)
    gp_j, gx_j, gu_j = jax.grad(loss_j, argnums=(0, 1, 2))(params, x, u)

    tp = to_torch(params, requires_grad=True)
    xt = torch.tensor(x, requires_grad=True)
    ut = torch.tensor(u, requires_grad=True)
    for step in (nk.node_euler_step_plain, nk.node_euler_step):
        y_t = step(tp, xt, ut, DT)
        close(y_j, y_t)
        grads = torch.autograd.grad((y_t * torch.tensor(cot)).sum(),
                                    [xt, ut] + tree_leaves(tp))
        close(gx_j, grads[0])
        close(gu_j, grads[1])
        for a, b in zip(jax.tree.leaves(gp_j), grads[2:]):
            close(a, b)


def test_function_path_gradients_match_plain_autograd():
    """The autograd.Function (forward without a graph, backward by
    recomputation) against autograd through the plain version, including
    a call where only u needs a gradient (the policy-loss rollout)."""
    _, params, x, u = setup(3, 2, rows=7, seed=3)
    treedef, leaves = nk._flatten(to_torch(params, requires_grad=True))
    xt = torch.tensor(x, requires_grad=True)
    ut = torch.tensor(u, requires_grad=True)
    cot = torch.randn(7, 3, generator=torch.Generator().manual_seed(0))
    y_f = nk._NodeEulerFn.apply(xt, ut, DT, treedef, *leaves)
    assert y_f.requires_grad
    g_f = torch.autograd.grad((y_f * cot).sum(), [xt, ut] + leaves)
    y_p = nk.node_euler_step_plain(nk._unflatten(treedef, leaves), xt, ut,
                                   DT)
    g_p = torch.autograd.grad((y_p * cot).sum(), [xt, ut] + leaves)
    torch.testing.assert_close(y_f, y_p, rtol=0, atol=0)
    for a, b in zip(g_f, g_p):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)

    detached = [leaf.detach() for leaf in leaves]
    y_u = nk._NodeEulerFn.apply(xt.detach(), ut, DT, treedef, *detached)
    (g_u,) = torch.autograd.grad((y_u * cot).sum(), [ut])
    torch.testing.assert_close(g_u, g_p[1], rtol=1e-6, atol=1e-7)


def test_validate_rejects_what_the_kernel_does_not_take():
    _, params, x, u = setup(3, 2)
    tp, xt, ut = to_torch(params), torch.tensor(x), torch.tensor(u)
    nk.validate(tp, xt, ut)
    with pytest.raises(ValueError, match="float32 only"):
        nk.validate(tp, xt, ut, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="float32"):
        nk.validate(tp, xt.double(), ut)
    with pytest.raises(ValueError, match="contiguous"):
        nk.validate(tp, torch.tensor(x.T.copy()).T, ut)
    with pytest.raises(ValueError, match=r"\(B, n_s\)"):
        nk.validate(tp, xt, ut[:-1])
    with pytest.raises(ValueError, match="ends at"):
        nk.validate(tp, xt, torch.zeros(x.shape[0], 3))
    wide = {"f": tp["f"], "g": {"w": [torch.zeros(3, 200),
                                      torch.zeros(200, 6)],
                                "b": [torch.zeros(200), torch.zeros(6)]}}
    with pytest.raises(ValueError, match="exceeds"):
        nk.validate(wide, xt, ut)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        nk.node_euler_step(tp, xt.to("meta"), ut.to("meta"), DT)
