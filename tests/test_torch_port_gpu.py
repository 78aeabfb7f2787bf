"""The CUDA kernels of nlbac_tpu_torch against their plain versions, on a
GPU with nvcc (marked ``gpu``; each test skips elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerance: rtol 1e-5 / atol 1e-5, float32 on both sides; the kernel and
cuBLAS sum each layer's products in different orders.
"""

import dataclasses
import shutil
from pathlib import Path

import pytest
import torch

from nlbac_tpu_torch.config import get_config
from nlbac_tpu_torch.nn import node_init
from nlbac_tpu_torch.ops import node_kernel as nk
from nlbac_tpu_torch.tree import tree_leaves


def _require_gpu():
    nvcc = shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists()
    if not torch.cuda.is_available() or not nvcc:
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.gpu
@pytest.mark.parametrize("dims,rows", [((3, 2), 128), ((3, 2), 1000),
                                       ((3, 2), 32768), ((6, 2), 128),
                                       ((3, 2), 1)])
def test_node_euler_kernel_matches_plain_version(dims, rows):
    _require_gpu()
    n_s, n_u = dims
    cfg = dataclasses.replace(get_config("unicycle").node, state_dim=n_s,
                              action_dim=n_u)
    gen = torch.Generator("cuda").manual_seed(rows)
    params = node_init(gen, cfg, device="cuda")
    for net in params.values():
        for b in net["b"]:
            b.uniform_(-0.1, 0.1, generator=gen)
            b.requires_grad_(True)
        for w in net["w"]:
            w.requires_grad_(True)
    x = torch.randn(rows, n_s, device="cuda", generator=gen)
    u = torch.randn(rows, n_u, device="cuda", generator=gen,
                    requires_grad=True)
    before = nk.launch_counts["node_euler"]
    y_k = nk.node_euler_step(params, x, u, 0.02)
    torch.cuda.synchronize()
    assert nk.launch_counts["node_euler"] == before + 1
    y_p = nk.node_euler_step_plain(params, x, u, 0.02)
    torch.testing.assert_close(y_k, y_p, rtol=1e-5, atol=1e-5)
    inputs = [u] + tree_leaves(params)
    g_k = torch.autograd.grad(y_k.square().sum(), inputs)
    g_p = torch.autograd.grad(y_p.square().sum(), inputs)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_node_euler_kernel_rejects_bfloat16_and_counts_nothing():
    _require_gpu()
    cfg = get_config("unicycle").node
    params = node_init(torch.Generator("cuda").manual_seed(0), cfg,
                       device="cuda")
    x = torch.zeros(4, 3, device="cuda")
    u = torch.zeros(4, 2, device="cuda")
    before = nk.launch_counts["node_euler"]
    with pytest.raises(ValueError, match="float32 only"):
        nk.node_euler_step(params, x, u, 0.02, compute_dtype="bfloat16")
    with pytest.raises(ValueError, match="contiguous"):
        nk.node_euler_step(params, x.t().contiguous().t(), u, 0.02)
    assert nk.launch_counts["node_euler"] == before
