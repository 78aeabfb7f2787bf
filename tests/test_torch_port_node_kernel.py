"""The NODE Euler kernel module (nlbac_tpu_torch/ops/node_kernel.py).

On the CPU: the plain version against the JAX package's
``predict_next_state`` (control-affine field, one Euler step) and its
``jax.grad`` in params, x and u, at the unicycle (3, 2) and pvtol (6, 2)
dimensions; the autograd.Function path's gradients against plain autograd;
the wrapper's input checks, its cache of launch arguments and its
bookkeeping under several threads. float32 on
both sides: rtol 1e-5 / atol 1e-6 covers the frameworks' different
summation order.

The kernel's arithmetic, three TF32 tensor-core passes per product
(3xTF32), is emulated here at the unicycle widths and held against
``predict_next_state`` at the kernel's tolerance (rtol/atol 1e-5, as on the
card); one pass is shown to miss it. The CUDA kernel itself is tested in
test_torch_port_gpu.py.
"""

import sys
import threading
import time

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


def test_launch_args_are_cached_per_parameter_set():
    """One validation and one ctypes block per parameter set: reused while
    the tensors stay (in-place updates, as Adam's, keep them), rebuilt when
    one is swapped; x and u are still checked on every call."""
    _, params, x, u = setup(3, 2, seed=4)
    tp, xt, ut = to_torch(params), torch.tensor(x), torch.tensor(u)
    first = nk.launch_args(tp, xt, ut)
    assert nk.launch_args(tp, xt, ut) is first
    with torch.no_grad():
        tp["f"]["w"][1].add_(0.5)
    assert nk.launch_args(tp, xt, ut) is first
    f_ptrs = first.c_args[1]
    assert [f_ptrs[i] for i in range(len(tp["f"]["w"]))] == \
        [w.data_ptr() for w in tp["f"]["w"]]

    tp["g"]["w"][2] = tp["g"]["w"][2].clone()
    swapped = nk.launch_args(tp, xt, ut)
    assert swapped is not first
    assert swapped.c_args[5][2] == tp["g"]["w"][2].data_ptr()
    assert nk.launch_args(tp, xt, ut) is swapped

    with pytest.raises(ValueError, match="float32"):
        nk.launch_args(tp, xt.double(), ut)
    with pytest.raises(ValueError, match="contiguous"):
        nk.launch_args(tp, torch.tensor(x.T.copy()).T, ut)
    with pytest.raises(ValueError, match=r"\(B, n_s\)"):
        nk.launch_args(tp, xt, ut[:-1])
    with pytest.raises(ValueError, match="ends at"):
        nk.launch_args(tp, xt, torch.zeros(x.shape[0], 3))
    tp["f"]["w"][0] = torch.zeros(3, HID + 1)
    with pytest.raises(ValueError, match="do not chain"):
        nk.launch_args(tp, xt, ut)


def test_bookkeeping_holds_under_threads(monkeypatch):
    """The wrapper shared by host threads: the library loads once however
    many threads ask at once, no launch count is lost, and the cache
    keeps every parameter set of a process's seeds (LAUNCH_ARGS_KEPT
    threads, each its own seed's parameters, find their own first
    LaunchArgs again after all have validated)."""
    loads = []

    def slow_build(verbose=False):
        loads.append(1)
        time.sleep(0.05)
        return "libnode_euler.so"

    monkeypatch.setattr(nk, "build", slow_build)
    monkeypatch.setattr(nk.ctypes, "CDLL", lambda path: object())
    monkeypatch.setattr(nk, "_bind", lambda lib: lib)
    monkeypatch.setattr(nk, "_lib", None)

    def in_threads(n, fn):
        """``fn(i, barrier)`` on n threads released together, with the
        interpreter switching threads as often as it can."""
        barrier = threading.Barrier(n)
        out = [None] * n

        def run(i):
            barrier.wait()
            out[i] = fn(i, barrier)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
        interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        finally:
            sys.setswitchinterval(interval)
        assert not any(t.is_alive() for t in threads)
        return out

    libs = in_threads(8, lambda i, b: nk.load())
    assert len(loads) == 1 and all(lib is libs[0] for lib in libs)

    nk.reset_launch_counts()
    in_threads(8, lambda i, b: [nk.count_launch(128 + i % 2)
                                for _ in range(2000)])
    assert nk.launch_counts["node_euler"] == 16000
    assert nk.launches_by_rows == {128: 8000, 129: 8000}
    nk.reset_launch_counts()
    assert nk.launch_counts["node_euler"] == 0 and not nk.launches_by_rows

    monkeypatch.setattr(nk, "_launch_args", {})
    n = nk._LAUNCH_ARGS_KEPT

    def validate_twice(i, barrier):
        _, params, x, u = setup(3, 2, seed=i)
        tp, xt, ut = to_torch(params), torch.tensor(x), torch.tensor(u)
        first = nk.launch_args(tp, xt, ut)
        barrier.wait()
        return nk.launch_args(tp, xt, ut) is first

    assert all(in_threads(n, validate_twice))


def _tf32(a):
    """float32 rounded to TF32 (10 mantissa bits), to nearest even."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    lsb = (bits >> np.uint32(13)) & np.uint32(1)
    bits = (bits + np.uint32(0xFFF) + lsb) & np.uint32(0xFFFFE000)
    return bits.view(np.float32)


def _tf32_matmul(a, w, passes):
    """a @ w from TF32 operands with float32 sums: one pass big*big, or
    three, small*big + big*small + big*big, each operand split as
    big = tf32(v), small = tf32(v - big). TF32 products are exact in
    float32, so float32 matmuls of the parts emulate the tensor cores."""
    a_big, w_big = _tf32(a), _tf32(w)
    out = torch.tensor(a_big) @ torch.tensor(w_big)
    if passes == 3:
        a_small, w_small = _tf32(a - a_big), _tf32(w - w_big)
        cor = torch.tensor(a_small) @ torch.tensor(w_big) + \
            torch.tensor(a_big) @ torch.tensor(w_small)
        out = cor + out
    return out.numpy()


def _euler_tf32(params, x, u, passes):
    def mlp(net, h):
        n = len(net["w"])
        for i, (w, b) in enumerate(zip(net["w"], net["b"])):
            h = _tf32_matmul(h, np.asarray(w), passes) + np.asarray(b)
            if i < n - 1:
                h = np.maximum(h, np.float32(0))
        return h
    n_s, n_u = x.shape[1], u.shape[1]
    g = mlp(params["g"], x).reshape(-1, n_s, n_u)
    dx = mlp(params["f"], x) + np.einsum("rij,rj->ri", g, u)
    return x + np.float32(DT) * dx


def _full_width(n_s, n_u, rows=4096, seed=5):
    """The unicycle NODE at its full width 100 (f_net 5 layers, g_net 4),
    Glorot-uniform weights and small biases from a numpy seed."""
    cfg = JNodeConfig(form="control_affine", state_dim=n_s, action_dim=n_u,
                      hidden_dim=100, f_hidden_layers=4, g_hidden_layers=3)
    rng = np.random.default_rng(seed)

    def net(sizes):
        ws = [(rng.uniform(-1, 1, (i, o)) * np.sqrt(6 / (i + o)))
              .astype(np.float32) for i, o in zip(sizes, sizes[1:])]
        bs = [rng.uniform(-0.1, 0.1, o).astype(np.float32)
              for o in sizes[1:]]
        return {"w": ws, "b": bs}

    params = {"f": net([n_s] + [100] * 4 + [n_s]),
              "g": net([n_s] + [100] * 3 + [n_s * n_u])}
    x = rng.normal(size=(rows, n_s)).astype(np.float32)
    u = rng.uniform(-3.5, 3.5, (rows, n_u)).astype(np.float32)
    y_j = np.asarray(predict_next_state(cfg, params, x, u, DT))
    return params, x, u, y_j


@pytest.mark.parametrize("dims", [(3, 2), (6, 2)])
def test_three_tf32_passes_hold_float32_tolerance(dims):
    params, x, u, y_j = _full_width(*dims)
    y = _euler_tf32(params, x, u, passes=3)
    np.testing.assert_allclose(y, y_j, rtol=1e-5, atol=1e-5)


def test_one_tf32_pass_misses_float32_tolerance():
    """Why the kernel takes three passes: one exceeds rtol/atol 1e-5."""
    params, x, u, y_j = _full_width(3, 2)
    y = _euler_tf32(params, x, u, passes=1)
    excess = np.abs(y - y_j) / (1e-5 + 1e-5 * np.abs(y_j))
    assert excess.max() > 1.0
