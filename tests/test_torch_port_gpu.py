"""The CUDA kernels of nlbac_tpu_torch against their plain versions, on a
GPU with nvcc (marked ``gpu``; each test skips elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerance: rtol 1e-5 / atol 1e-5, float32 on both sides; the kernel
(three TF32 tensor-core passes a product) and cuBLAS sum each layer's
products in different orders.
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


# the 16-row tile's edges, the main path's 128 and 32768, a ragged 1000,
# and the switch from 16-row to 64-row tiles with a row either side
ROWS = (1, 16, 17, 127, 128, 129, 1000, nk.SMALL_TILE_MAX_ROWS - 1,
        nk.SMALL_TILE_MAX_ROWS, nk.SMALL_TILE_MAX_ROWS + 1, 32768)


def _params(n_s, n_u, gen):
    cfg = dataclasses.replace(get_config("unicycle").node, state_dim=n_s,
                              action_dim=n_u)
    params = node_init(gen, cfg, device="cuda")
    for net in params.values():
        for b in net["b"]:
            b.uniform_(-0.1, 0.1, generator=gen)
            b.requires_grad_(True)
        for w in net["w"]:
            w.requires_grad_(True)
    return params


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(3, 2), (6, 2)])
@pytest.mark.parametrize("rows", ROWS)
def test_node_euler_kernel_matches_plain_version(dims, rows):
    _require_gpu()
    n_s, n_u = dims
    gen = torch.Generator("cuda").manual_seed(rows)
    params = _params(n_s, n_u, gen)
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
@pytest.mark.parametrize("config", range(len(nk.TILE_CONFIGS)))
@pytest.mark.parametrize("rows", (17, 1000))
def test_every_tile_config_matches_plain_version(config, rows):
    _require_gpu()
    gen = torch.Generator("cuda").manual_seed(config)
    params = _params(3, 2, gen)
    x = torch.randn(rows, 3, device="cuda", generator=gen)
    u = torch.randn(rows, 2, device="cuda", generator=gen)
    with torch.no_grad():
        y_k = nk._launch(nk.launch_args(params, x, u), x, u, 0.02, config)
        y_p = nk.node_euler_step_plain(params, x, u, 0.02)
    torch.testing.assert_close(y_k, y_p, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_node_euler_kernel_replays_from_a_cuda_graph():
    """The cluster launch survives stream capture: replayed on new inputs
    copied into the captured buffers, the graph matches the plain
    version."""
    _require_gpu()
    gen = torch.Generator("cuda").manual_seed(7)
    params = _params(3, 2, gen)
    x = torch.randn(128, 3, device="cuda", generator=gen)
    u = torch.randn(128, 2, device="cuda", generator=gen)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.no_grad(), torch.cuda.stream(side):
        nk.node_euler_step(params, x, u, 0.02)  # build, load, warm up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.no_grad(), torch.cuda.graph(graph):
        y = nk.node_euler_step(params, x, u, 0.02)
    for _ in range(2):
        x.copy_(torch.randn(128, 3, device="cuda", generator=gen))
        u.copy_(torch.randn(128, 2, device="cuda", generator=gen))
        graph.replay()
        torch.cuda.synchronize()
        with torch.no_grad():
            y_p = nk.node_euler_step_plain(params, x, u, 0.02)
        torch.testing.assert_close(y, y_p, rtol=1e-5, atol=1e-5)


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


@pytest.mark.gpu
def test_node_euler_kernel_on_the_pvtol_chain():
    """PVTOL's constraint chain at its batch (256 rows, (6, 2)): three
    chained calls, the second and third differentiated with respect to x
    as well; gradients of u_t, of x on a single call, and of the
    parameters against the plain version's."""
    _require_gpu()
    gen = torch.Generator("cuda").manual_seed(256)
    params = _params(6, 2, gen)
    x0 = torch.randn(256, 6, device="cuda", generator=gen)
    u0 = torch.randn(256, 2, device="cuda", generator=gen,
                     requires_grad=True)
    resampled = [torch.randn(256, 2, device="cuda", generator=gen)
                 for _ in range(2)]
    cot = torch.randn(3, 256, 6, device="cuda", generator=gen)

    def chain(step):
        ys, x, u = [], x0, u0
        for k in range(3):
            x = step(params, x, u, 0.02)
            ys.append(x)
            if k < 2:
                u = resampled[k]
        return torch.stack(ys)

    before = nk.launch_counts["node_euler"]
    y_k = chain(nk.node_euler_step)
    torch.cuda.synchronize()
    assert nk.launch_counts["node_euler"] == before + 3
    y_p = chain(nk.node_euler_step_plain)
    torch.testing.assert_close(y_k, y_p, rtol=1e-5, atol=1e-5)
    inputs = [u0] + tree_leaves(params)
    g_k = torch.autograd.grad((y_k * cot).sum(), inputs)
    g_p = torch.autograd.grad((y_p * cot).sum(), inputs)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)

    x = x0.clone().requires_grad_(True)
    g_k = torch.autograd.grad((nk.node_euler_step(params, x, u0, 0.02)
                               * cot[0]).sum(), [x, u0])
    g_p = torch.autograd.grad((nk.node_euler_step_plain(params, x, u0, 0.02)
                               * cot[0]).sum(), [x, u0])
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["unicycle", "cars", "pvtol"])
def test_cli_trains_each_preset_on_the_card(preset, tmp_path):
    """One short episode of each preset through nlbac-train-torch's
    main() on the GPU (no --cpu): the run's files, a finite progress row,
    and K1 launched where the preset's NODE is control-affine."""
    _require_gpu()
    import glob

    from nlbac_tpu_torch.train import cli

    before = nk.launch_counts["node_euler"]
    cli.main(["--preset", preset, "--quiet", "--output", str(tmp_path),
              "--max_episodes", "1", "--max_episode_steps", "40",
              "--start_steps", "20", "--batch_size", "16",
              "--replay_size", "1000"])
    (run,) = glob.glob(str(tmp_path / "*-run*" / "*" / "*_s*"))
    for name in ("progress.txt", "config.json", "checkpoint.npz",
                 "actor.pkl", "critic.pkl", "lyapunov.pkl",
                 "node_model.pkl"):
        assert (Path(run) / name).is_file(), name
    header, row = (Path(run) / "progress.txt").read_text().splitlines()
    values = dict(zip(header.split("\t"), map(float, row.split("\t"))))
    assert values["updates"] > 0
    assert all(v == v and abs(v) != float("inf") for v in values.values())
    launched = nk.launch_counts["node_euler"] - before
    assert (launched > 0) == (preset != "cars")
