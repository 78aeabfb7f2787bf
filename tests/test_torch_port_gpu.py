"""The CUDA kernels of nlbac_tpu_torch against their plain versions, on a
GPU with nvcc (marked ``gpu``; each test skips elsewhere).

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py

Tolerance: rtol 1e-5 / atol 1e-5, float32 on both sides; the kernel
(three TF32 tensor-core passes a product) and cuBLAS sum each layer's
products in different orders. A full-width update on the card against the
same update on the CPU: rtol 1e-3 / atol 1e-4 on its metrics (cuBLAS and
the CPU's BLAS sum in different orders, and the difference passes through
Adam's normalisation and the constraint's /dt).
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


# the 16-row tile's edges, the main path's 128 and 32768 (and a dp rank's
# share of them at dp=2 and 4), a ragged 1000, and the switch from 16-row
# to 64-row tiles with a row either side
ROWS = (1, 16, 17, 32, 64, 127, 128, 129, 1000, nk.SMALL_TILE_MAX_ROWS - 1,
        nk.SMALL_TILE_MAX_ROWS, nk.SMALL_TILE_MAX_ROWS + 1, 8192, 16384,
        32768)


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
@pytest.mark.parametrize("dims,rows", [((3, 2), 128), ((6, 2), 256)])
def test_node_euler_kernel_at_the_learned_barrier_calls(dims, rows):
    """The learned barrier's single call (nbc_unicycle: 128 rows, (3, 2);
    nbc_pvtol: 256 rows, (6, 2)): x carries no gradient, u does."""
    _require_gpu()
    n_s, n_u = dims
    gen = torch.Generator("cuda").manual_seed(rows + n_s)
    params = _params(n_s, n_u, gen)
    x = torch.randn(rows, n_s, device="cuda", generator=gen)
    u = torch.randn(rows, n_u, device="cuda", generator=gen,
                    requires_grad=True)
    cot = torch.randn(rows, n_s, device="cuda", generator=gen)
    before = nk.launch_counts["node_euler"]
    y_k = nk.node_euler_step(params, x, u, 0.02)
    torch.cuda.synchronize()
    assert nk.launch_counts["node_euler"] == before + 1
    y_p = nk.node_euler_step_plain(params, x, u, 0.02)
    torch.testing.assert_close(y_k, y_p, rtol=1e-5, atol=1e-5)
    (g_k,) = torch.autograd.grad((y_k * cot).sum(), [u])
    (g_p,) = torch.autograd.grad((y_p * cot).sum(), [u])
    torch.testing.assert_close(g_k, g_p, rtol=1e-5, atol=1e-5)


def _to_device(ts, cfg, dev):
    """A copy of a fresh TrainState on ``dev`` with fresh optimizers."""
    from nlbac_tpu_torch.agent.state import make_optimizers
    from nlbac_tpu_torch.tree import tree_map

    def move(p):
        return p.detach().to(dev, copy=True).requires_grad_(p.requires_grad)
    fields = {name: tree_map(move, getattr(ts, name)) for name in (
        "policy", "backup_policy", "critic", "critic_target", "lyap",
        "lyap_target", "barrier", "barrier_target", "node", "log_alpha",
        "backup_log_alpha")}
    return type(ts)(**fields, opt=make_optimizers(cfg, fields),
                    lag=type(ts.lag)(*(t.to(dev, copy=True)
                                       for t in ts.lag)),
                    updates=ts.updates)


@pytest.mark.gpu
def test_nbc_unicycle_update_on_the_card_matches_the_cpu():
    """One full-width nbc_unicycle update (batch 128, NODE width 100, the
    32768-row fit) on the card, through K1, against the CPU's plain
    version: every metric, barrier_td_loss included."""
    _require_gpu()
    from nlbac_tpu_torch.agent import create_train_state, make_agent
    from nlbac_tpu_torch.envs import unicycle

    cfg = get_config("nbc_unicycle")
    gen = torch.Generator().manual_seed(0)
    ts_cpu = create_train_state(cfg, gen, "cpu")
    ts_dev = _to_device(ts_cpu, cfg, "cuda")

    def batch(n):
        states = torch.stack([torch.rand(n, generator=gen) * 6 - 3,
                              torch.rand(n, generator=gen) * 6 - 3,
                              torch.rand(n, generator=gen) * 6 - 3], 1)
        action = (torch.rand(n, 2, generator=gen) * 2 - 1) * \
            torch.tensor([3.5, 12.0])
        return {"obs": unicycle.state_to_obs(states), "action": action,
                "reward": torch.randn(n, generator=gen),
                "constraint": torch.rand(n, generator=gen),
                "lyap_t": torch.randn(n, 2, generator=gen),
                "lyap_t1": torch.randn(n, 2, generator=gen),
                "barrier_signal": -20.0 * (torch.rand(n, generator=gen)
                                           < 0.3).float(),
                "next_obs": unicycle.state_to_obs(states + 0.02),
                "mask": (torch.rand(n, generator=gen) > 0.1).float(),
                "t": torch.zeros(n), "next_t": torch.full((n,), 0.02)}

    b, nb = batch(cfg.sac.batch_size), batch(cfg.node.max_batch)
    noise = {k: torch.randn(cfg.sac.batch_size, 2, generator=gen)
             for k in ("next", "pi")}
    noise["resample"] = torch.randn(1, cfg.sac.batch_size, 2, generator=gen)

    def run(ts, device):
        moved = {k: {n: v.to(device) for n, v in d.items()}
                 for k, d in (("b", b), ("nb", nb))}
        _, m = make_agent(cfg, device).update_core(
            ts, moved["b"], lambda: moved["nb"], None, 0,
            noise={k: v.to(device) for k, v in noise.items()})
        return {k: v.item() for k, v in m.items()}

    before = nk.launch_counts["node_euler"]
    m_dev = run(ts_dev, "cuda")
    assert nk.launch_counts["node_euler"] == before + 2  # fit, rollout
    m_cpu = run(ts_cpu, "cpu")
    assert m_cpu["barrier_td_loss"] > 0 and m_cpu["node_loss"] > 0
    for k, v in m_cpu.items():
        assert abs(m_dev[k] - v) <= 1e-4 + 1e-3 * abs(v), (k, m_dev[k], v)


@pytest.mark.gpu
def test_bfloat16_unicycle_update_on_the_card_matches_the_cpu():
    """One full-width unicycle update with ``compute_dtype='bfloat16'``
    (the 32768-row fit and both rollouts through the plain bf16 field; K1
    computes float32 only and is not launched) on the card against the
    same update on the CPU, within rtol 2e-2 / atol 1e-6 (the atol for the
    metrics that are 0): bf16 keeps 8 significant bits, so each rounding
    of a layer's output is up to 2e-3 of it, the card's tensor cores and
    the CPU round different partial sums, and the constraint term divides
    the prediction's rounding by dt = 0.02."""
    _require_gpu()
    from nlbac_tpu_torch.agent import create_train_state, make_agent
    from nlbac_tpu_torch.envs import unicycle

    cfg = get_config("unicycle")
    cfg = dataclasses.replace(cfg, node=dataclasses.replace(
        cfg.node, compute_dtype="bfloat16"))
    gen = torch.Generator().manual_seed(0)
    ts_cpu = create_train_state(cfg, gen, "cpu")
    ts_dev = _to_device(ts_cpu, cfg, "cuda")

    def batch(n):
        states = torch.rand(n, 3, generator=gen) * 6 - 3
        action = (torch.rand(n, 2, generator=gen) * 2 - 1) * \
            torch.tensor([3.5, 12.0])
        return {"obs": unicycle.state_to_obs(states), "action": action,
                "reward": torch.randn(n, generator=gen),
                "constraint": torch.rand(n, generator=gen),
                "lyap_t": torch.randn(n, 2, generator=gen),
                "lyap_t1": torch.randn(n, 2, generator=gen),
                "barrier_signal": torch.zeros(n),
                "next_obs": unicycle.state_to_obs(states + 0.02),
                "mask": (torch.rand(n, generator=gen) > 0.1).float(),
                "t": torch.zeros(n), "next_t": torch.full((n,), 0.02)}

    b, nb = batch(cfg.sac.batch_size), batch(cfg.node.max_batch)
    noise = {k: torch.randn(cfg.sac.batch_size, 2, generator=gen)
             for k in ("next", "pi", "backup")}

    def run(ts, device):
        moved = {k: {n: v.to(device) for n, v in d.items()}
                 for k, d in (("b", b), ("nb", nb))}
        _, m = make_agent(cfg, device).update_core(
            ts, moved["b"], lambda: moved["nb"], None, 0,
            noise={k: v.to(device) for k, v in noise.items()})
        return {k: v.item() for k, v in m.items()}

    before = nk.launch_counts["node_euler"]
    m_dev = run(ts_dev, "cuda")
    assert nk.launch_counts["node_euler"] == before
    m_cpu = run(ts_cpu, "cpu")
    assert m_cpu["node_loss"] > 0 and m_cpu["constraint_loss"] != 0
    for k, v in m_cpu.items():
        assert abs(m_dev[k] - v) <= 1e-6 + 2e-2 * abs(v), (k, m_dev[k], v)


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["unicycle", "cars", "pvtol",
                                    "nbc_unicycle", "nbc_pvtol",
                                    "quadrotor"])
def test_cli_trains_each_preset_on_the_card(preset, tmp_path):
    """One short episode of each preset through nlbac-train-torch's
    main() on the GPU (no --cpu): the run's files (barrier.pkl for the
    learned-barrier family), a finite progress row, and K1 launched where
    the preset's NODE is control-affine."""
    _require_gpu()
    import glob

    from nlbac_tpu_torch.train import cli

    before = nk.launch_counts["node_euler"]
    # random thrusts can crash the quadrotor into its kill box before the
    # replay holds a batch, so it gets three episodes
    episodes = "3" if preset == "quadrotor" else "1"
    cli.main(["--preset", preset, "--quiet", "--output", str(tmp_path),
              "--max_episodes", episodes, "--max_episode_steps", "40",
              "--start_steps", "20", "--batch_size", "16",
              "--replay_size", "1000"])
    (run,) = glob.glob(str(tmp_path / "*-run*" / "*" / "*_s*"))
    for name in ("progress.txt", "config.json", "checkpoint.npz",
                 "actor.pkl", "critic.pkl", "lyapunov.pkl",
                 "node_model.pkl"):
        assert (Path(run) / name).is_file(), name
    nbc = preset in ("nbc_unicycle", "nbc_pvtol", "quadrotor")
    assert (Path(run) / "barrier.pkl").is_file() == nbc
    header, *rows = (Path(run) / "progress.txt").read_text().splitlines()
    assert len(rows) == int(episodes)
    row = rows[-1]
    values = dict(zip(header.split("\t"), map(float, row.split("\t"))))
    assert values["updates"] > 0
    assert all(v == v and abs(v) != float("inf") for v in values.values())
    assert ("barrier_td_loss" in values) == nbc
    launched = nk.launch_counts["node_euler"] - before
    assert (launched > 0) == (preset not in ("cars", "quadrotor"))


def _dopri5_inputs(rows, gen):
    cfg = get_config("unicycle")
    params = _params(3, 2, gen)
    x = torch.randn(rows, 3, device="cuda", generator=gen)
    u = (torch.rand(rows, 2, device="cuda", generator=gen) * 2 - 1) * \
        torch.tensor([3.5, 12.0], device="cuda")
    return cfg, params, torch.cat([x, u], dim=1)


@pytest.mark.gpu
@pytest.mark.parametrize("impl", ["while", "scan"])
@pytest.mark.parametrize("rows", [128, 32768])
def test_dopri5_on_the_card_matches_the_cpu(impl, rows):
    """The adaptive solver on the unicycle NODE field at full width over
    its 0.02 span: the card's values within rtol 1e-4 / atol 1e-5 of the
    CPU's (float32 both; each accepted step within the solver's rtol
    1e-5), both reaching dt."""
    _require_gpu()
    from nlbac_tpu_torch.nn import make_field
    from nlbac_tpu_torch.ode import solve_adaptive
    from nlbac_tpu_torch.tree import tree_map

    gen = torch.Generator("cuda").manual_seed(0)
    cfg, params, s0 = _dopri5_inputs(rows, gen)
    field = make_field(cfg.node)
    kw = dict(impl=impl, max_steps=cfg.node.adaptive_scan_steps
              if impl == "scan" else 512, return_final_t=True)
    with torch.no_grad():
        y_d, t_d = solve_adaptive(field, params, s0, 0.0, cfg.env.dt, **kw)
        y_c, t_c = solve_adaptive(
            field, tree_map(lambda p: p.detach().cpu(), params), s0.cpu(),
            0.0, cfg.env.dt, **kw)
    torch.testing.assert_close(y_d.cpu(), y_c, rtol=1e-4, atol=1e-5)
    assert float(t_d) == float(t_c) == float(torch.tensor(cfg.env.dt))


@pytest.mark.gpu
def test_dopri5_adjoint_gradients_match_the_scan_form_on_the_card():
    """The while form's adjoint gradients (parameters and y0) against
    autograd through the scan form, within 5e-2 of each leaf's largest
    entry: at the 0.02 span the scan form's gradient through the step
    sizes is float32 noise (``scripts/dopri5_probe.py``)."""
    _require_gpu()
    from nlbac_tpu_torch.nn import make_field
    from nlbac_tpu_torch.ode import odeint_adjoint, solve_adaptive

    gen = torch.Generator("cuda").manual_seed(1)
    cfg, params, s0 = _dopri5_inputs(128, gen)
    field = make_field(cfg.node)
    cot = torch.randn(128, 5, device="cuda", generator=gen)
    grads = []
    for adjoint in (True, False):
        s = s0.clone().requires_grad_(True)
        y = (odeint_adjoint(field, params, s, 0.0, cfg.env.dt,
                            method="dopri5") if adjoint
             else solve_adaptive(field, params, s, 0.0, cfg.env.dt,
                                 impl="scan", max_steps=16))
        grads.append(torch.autograd.grad((y * cot).sum(),
                                         tree_leaves(params) + [s]))
    for a, b in zip(*grads):
        assert (a - b).abs().max() <= 5e-2 * b.abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("extra", [
    ["--host_loop"], ["--node_solver", "dopri5"],
    ["--node_solver", "dopri5", "--node_adaptive_impl", "scan"],
    ["--host_loop", "--node_solver", "dopri5"]],
    ids=["host_loop", "dopri5_while", "dopri5_scan", "host_loop_dopri5"])
def test_cli_trains_unicycle_on_the_card_in_the_new_modes(extra, tmp_path):
    """unicycle through main() on the GPU in the host-loop mode and under
    dopri5: a finite progress row after updates, K1 launched only under
    Euler, the host loop's checkpoint in its own mode."""
    _require_gpu()
    import glob
    import json

    import numpy as np

    from nlbac_tpu_torch.train import cli

    before = nk.launch_counts["node_euler"]
    cli.main(["--preset", "unicycle", "--quiet", "--output", str(tmp_path),
              "--max_episodes", "1", "--max_episode_steps", "24",
              "--start_steps", "20", "--batch_size", "16",
              "--replay_size", "1000", *extra])
    (run,) = glob.glob(str(tmp_path / "*-run*" / "*" / "*_s*"))
    header, row = (Path(run) / "progress.txt").read_text().splitlines()
    values = dict(zip(header.split("\t"), map(float, row.split("\t"))))
    assert values["updates"] > 0
    assert all(v == v and abs(v) != float("inf") for v in values.values())
    launched = nk.launch_counts["node_euler"] - before
    assert (launched > 0) == ("dopri5" not in extra)
    with np.load(Path(run) / "checkpoint.npz") as z:
        mode = json.loads(bytes(z["extra"]).decode())["mode"]
    assert mode == ("host_loop" if "--host_loop" in extra else "fused")


@pytest.mark.gpu
def test_eval_on_the_card_matches_the_cpu(tmp_path):
    """run_policy's deterministic quadrotor rollouts (the ground start,
    40 steps) on the card against the CPU on the same weights: return,
    length and violations within rtol 1e-3 / atol 1e-4; then --mode eval
    through main() on the card."""
    _require_gpu()
    import dataclasses

    from nlbac_tpu_torch.agent import create_train_state
    from nlbac_tpu_torch.train import cli
    from nlbac_tpu_torch.train.checkpoint import save_model_weights
    from nlbac_tpu_torch.utils.evaluate import load_trained_state, run_policy

    cfg = get_config("quadrotor")
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, max_episode_steps=40))
    save_model_weights(str(tmp_path), create_train_state(
        cfg, torch.Generator().manual_seed(3), "cpu"), include_barrier=True)
    res = {dev: run_policy(cfg, load_trained_state(cfg, str(tmp_path),
                                                   torch.device(dev)),
                           episodes=2, seed=0)
           for dev in ("cuda", "cpu")}
    for a, b in zip(res["cuda"], res["cpu"]):
        assert a["length"] == b["length"]
        for k in ("return", "violations"):
            assert abs(a[k] - b[k]) <= 1e-4 + 1e-3 * abs(b[k]), (k, a, b)
    cli.main(["--preset", "quadrotor", "--mode", "eval", "--output",
              str(tmp_path), "--max_episode_steps", "40"])


@pytest.mark.gpu
def test_export_on_the_card_matches_det_action(tmp_path):
    """The exported deterministic head traced on the card, and one traced
    on the CPU then moved with .to("cuda"), against the policy's own
    det_action on the card at batch 1, 7 and 128 (atol 1e-6)."""
    _require_gpu()
    from nlbac_tpu_torch.agent import create_train_state
    from nlbac_tpu_torch.envs import unicycle
    from nlbac_tpu_torch.nn import ActionSpec, gaussian_policy_sample
    from nlbac_tpu_torch.utils.export_policy import export_policy, load_policy

    cfg = get_config("unicycle")
    ts = {dev: create_train_state(cfg, torch.Generator(dev).manual_seed(0),
                                  dev) for dev in ("cuda", "cpu")}
    with torch.no_grad():
        for a, b in zip(tree_leaves(ts["cuda"].policy),
                        tree_leaves(ts["cpu"].policy)):
            b.copy_(a.cpu())
    export_policy(cfg, ts["cuda"], str(tmp_path / "card.pt2"))
    export_policy(cfg, ts["cpu"], str(tmp_path / "cpu.pt2"))
    card, _ = load_policy(str(tmp_path / "card.pt2"))
    moved, _ = load_policy(str(tmp_path / "cpu.pt2"))
    moved = moved.to("cuda")
    spec = ActionSpec.from_bounds(unicycle.SPEC.action_low,
                                  unicycle.SPEC.action_high, "cuda")
    for n in (1, 7, 128):
        obs = torch.randn(n, 7, device="cuda")
        with torch.no_grad():
            det = gaussian_policy_sample(ts["cuda"].policy, obs, spec,
                                         noise=torch.zeros(n, 2,
                                                           device="cuda"))[2]
            for act in (card, moved):
                torch.testing.assert_close(act(obs), det, rtol=0, atol=1e-6)


@pytest.mark.gpu
def test_nccl_is_refused_for_ranks_that_share_a_card():
    """Two ranks on card 0 with NCCL: each refuses before any collective
    (gloo is the backend for ranks that share a card)."""
    _require_gpu()
    from nlbac_tpu_torch.parallel import run_gang
    from torch.multiprocessing import ProcessRaisedException

    import torch_gang_workers
    with pytest.raises(ProcessRaisedException, match="share cards"):
        run_gang(torch_gang_workers.nccl_on_one_card, 2, timeout=120)


def _stacked_params(n_s, n_u, seeds, gen):
    """``seeds`` parameter sets stacked on a leading seed axis, and the
    sets themselves (views of the stacked leaves)."""
    from nlbac_tpu_torch.tree import tree_map

    sets = [_params(n_s, n_u, gen) for _ in range(seeds)]
    stacked = tree_map(lambda *ps: torch.stack([p.detach() for p in ps]
                                               ).requires_grad_(True), *sets)
    return stacked


@pytest.mark.gpu
@pytest.mark.parametrize("dims", [(3, 2), (6, 2)])
@pytest.mark.parametrize("rows", (1, 128, 129, 32768))
@pytest.mark.parametrize("seeds", (1, 3, 8))
def test_seed_batched_kernel_matches_plain_version(dims, rows, seeds):
    """K1 over stacked seeds (one launch, counted once at seeds * rows)
    against its seed-batched plain version (forward and every gradient)
    and against one launch per seed (forward)."""
    from nlbac_tpu_torch.tree import tree_map

    _require_gpu()
    n_s, n_u = dims
    gen = torch.Generator("cuda").manual_seed(1000 * seeds + rows)
    params = _stacked_params(n_s, n_u, seeds, gen)
    x = torch.randn(seeds, rows, n_s, device="cuda", generator=gen)
    u = torch.randn(seeds, rows, n_u, device="cuda", generator=gen,
                    requires_grad=True)
    before = nk.launch_counts["node_euler"]
    by_rows = nk.launches_by_rows[seeds * rows]
    y_k = nk.node_euler_step(params, x, u, 0.02)
    torch.cuda.synchronize()
    assert nk.launch_counts["node_euler"] == before + 1
    assert nk.launches_by_rows[seeds * rows] == by_rows + 1
    y_p = nk.node_euler_step_plain(params, x, u, 0.02)
    torch.testing.assert_close(y_k, y_p, rtol=1e-5, atol=1e-5)
    inputs = [u] + tree_leaves(params)
    g_k = torch.autograd.grad(y_k.square().sum(), inputs)
    g_p = torch.autograd.grad(y_p.square().sum(), inputs)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        for i in range(seeds):
            one = tree_map(lambda p: p[i].contiguous(), params)
            y_1 = nk.node_euler_step(one, x[i], u[i], 0.02)
            torch.testing.assert_close(y_k[i], y_1, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_seed_batched_unicycle_update_on_the_card_matches_the_cpu():
    """One full-width unicycle update of 3 stacked seeds at different
    counters (seed 0 fits the NODE on 32768 rows and ascends, seed 1 does
    neither, seed 2 does not update) on the card, through one
    seed-batched K1 launch per rollout and per fit, against the same
    update on the CPU: every metric and parameter at the update
    tolerance, seed 2's state unchanged on both."""
    _require_gpu()
    from nlbac_tpu_torch.agent import create_train_state, make_agent
    from nlbac_tpu_torch.agent.state import stack_states, unstack_state
    from nlbac_tpu_torch.envs import unicycle
    from nlbac_tpu_torch.parallel import state_arrays

    cfg = get_config("unicycle")
    gen = torch.Generator().manual_seed(0)
    states = [create_train_state(cfg, gen, "cpu") for _ in range(3)]
    counters = [0, 3, 5]
    for ts, n in zip(states, counters):
        ts.updates = n

    def batch(n):
        states = torch.stack([torch.rand(3, n, generator=gen) * 6 - 3,
                              torch.rand(3, n, generator=gen) * 6 - 3,
                              torch.rand(3, n, generator=gen) * 6 - 3], -1)
        action = (torch.rand(3, n, 2, generator=gen) * 2 - 1) * \
            torch.tensor([3.5, 12.0])
        return {"obs": unicycle.state_to_obs(states), "action": action,
                "reward": torch.randn(3, n, generator=gen),
                "constraint": torch.rand(3, n, generator=gen),
                "lyap_t": torch.randn(3, n, 2, generator=gen),
                "lyap_t1": torch.randn(3, n, 2, generator=gen),
                "barrier_signal": torch.zeros(3, n),
                "next_obs": unicycle.state_to_obs(states + 0.02),
                "mask": (torch.rand(3, n, generator=gen) > 0.1).float(),
                "t": torch.zeros(3, n), "next_t": torch.full((3, n), 0.02)}

    b, nb = batch(cfg.sac.batch_size), batch(cfg.node.max_batch)
    noise = {k: torch.randn(3, cfg.sac.batch_size, 2, generator=gen)
             for k in ("next", "pi", "backup")}
    seeds = [True, True, False]

    def run(device):
        ts = stack_states(cfg, [_to_device(s, cfg, device) for s in states])
        moved = {k: {n: v.to(device) for n, v in d.items()}
                 for k, d in (("b", b), ("nb", nb))}
        fits = []
        ts, m = make_agent(cfg, device).update_core(
            ts, moved["b"], lambda fit: fits.append(fit) or moved["nb"],
            None, 0, noise={k: v.to(device) for k, v in noise.items()},
            seeds=seeds)
        assert fits == [[True, False, False]] and ts.updates == [1, 4, 5]
        return ts, {k: v.cpu() for k, v in m.items()}

    before = nk.launch_counts["node_euler"]
    by_rows = dict(nk.launches_by_rows)
    ts_dev, m_dev = run("cuda")
    assert nk.launch_counts["node_euler"] == before + 3
    assert nk.launches_by_rows[3 * 128] == by_rows.get(3 * 128, 0) + 2
    assert nk.launches_by_rows[3 * 32768] == by_rows.get(3 * 32768, 0) + 1
    ts_cpu, m_cpu = run("cpu")
    for k, v in m_cpu.items():
        torch.testing.assert_close(m_dev[k], v, rtol=1e-3, atol=1e-4,
                                   msg=k)
    # each Adam moment within 2e-3 of the CPU's, relative to its 2-norm
    # (an Adam step's size is its sign where a gradient is near zero, so
    # the parameters after one step are not held tighter than that)
    for group in ts_cpu.opt:
        for a, b in zip(ts_dev.opt[group].moments(),
                        ts_cpu.opt[group].moments()):
            for x, y in zip(a, b):
                gap = (x.cpu() - y).norm() / y.norm().clamp_min(1e-30)
                assert gap <= 2e-3, (group, float(gap))
    # seed 2 did not update: its whole state as it was, bit for bit
    start = state_arrays(states[2])
    for ts in (ts_dev, ts_cpu):
        got = state_arrays(unstack_state(cfg, ts, 2))
        for key, want in start.items():
            if key == "updates":
                assert got[key] == want == 5
            else:
                assert len(got[key]) == len(want), key
                for g, w in zip(got[key], want):
                    assert (torch.as_tensor(g) == torch.as_tensor(w)).all(
                    ), key


@pytest.mark.gpu
@pytest.mark.parametrize("preset", ["pvtol", "nbc_pvtol"])
def test_seed_batched_pvtol_update_on_the_card_matches_the_cpu(preset):
    """One full-width update of 3 stacked PVTOL-family seeds at different
    counters (seed 0 fits the NODE on 32768 rows, ascends and, for PVTOL,
    takes the backup branch; seed 1 does none of these; seed 2 does not
    update) on the card against the same update on the CPU: K1 seed-batched
    on PVTOL's three chained calls (and three more for the backup branch)
    or on the learned barrier's one call, each at 3 x 256 rows (6, 2), and
    on the fit at 3 x 32768; every metric at the update tolerance, the
    Adam moments as the unicycle's, seed 2's state unchanged on both."""
    _require_gpu()
    from nlbac_tpu_torch.agent import create_train_state, make_agent
    from nlbac_tpu_torch.agent.state import stack_states, unstack_state
    from nlbac_tpu_torch.envs import pvtol
    from nlbac_tpu_torch.parallel import state_arrays

    cfg = get_config(preset)
    n = cfg.sac.batch_size
    gen = torch.Generator().manual_seed(1)
    states = [create_train_state(cfg, gen, "cpu") for _ in range(3)]
    for ts, count in zip(states, (0, 3, 5)):
        ts.updates = count

    def obs(rows):
        s = torch.zeros(3, rows, 7)
        s[..., :2] = torch.rand(3, rows, 2, generator=gen) * 10 - 5
        s[..., 2] = torch.rand(3, rows, generator=gen) * 6.28 - 3.14
        s[..., 3:5] = torch.randn(3, rows, 2, generator=gen)
        s[..., 5] = torch.rand(3, rows, generator=gen) * 2
        s[..., 6] = s[..., 0] + 0.8 * torch.randn(3, rows, generator=gen)
        return pvtol.state_to_obs(s)

    def batch(rows):
        o, o1 = obs(rows), obs(rows)
        action = (torch.rand(3, rows, 2, generator=gen) * 2 - 1) * \
            torch.tensor([3.5, 15.0])
        return {"obs": o, "action": action,
                "reward": torch.randn(3, rows, generator=gen),
                "constraint": torch.rand(3, rows, generator=gen),
                "lyap_t": o, "lyap_t1": o1,
                "barrier_signal": -0.1 * (torch.rand(
                    3, rows, generator=gen) < 0.2).float(),
                "next_obs": o1,
                "mask": (torch.rand(3, rows, generator=gen) > 0.1).float(),
                "t": torch.zeros(3, rows),
                "next_t": torch.full((3, rows), 0.02)}

    b, nb = batch(n), batch(cfg.node.max_batch)
    noise = {k: torch.randn(3, n, 2, generator=gen)
             for k in ("next", "pi", "backup")}
    # a resample draw per chain step, the seeds stacked inside each
    resamples = 2 if preset == "pvtol" else 1
    noise.update({k: torch.randn(resamples, 3, n, 2, generator=gen)
                  for k in ("resample", "backup_resample")})
    seeds = [True, True, False]

    def run(device):
        ts = stack_states(cfg, [_to_device(s, cfg, device) for s in states])
        moved = {k: {name: v.to(device) for name, v in d.items()}
                 for k, d in (("b", b), ("nb", nb))}
        fits = []
        ts, m = make_agent(cfg, device).update_core(
            ts, moved["b"], lambda fit: fits.append(fit) or moved["nb"],
            None, 0, noise={k: v.to(device) for k, v in noise.items()},
            seeds=seeds)
        assert fits == [[True, False, False]] and ts.updates == [1, 4, 5]
        return ts, {k: v.cpu() for k, v in m.items()}

    before = nk.launch_counts["node_euler"]
    by_rows = dict(nk.launches_by_rows)
    ts_dev, m_dev = run("cuda")
    chain = 6 if preset == "pvtol" else 1  # with the backup branch
    assert nk.launch_counts["node_euler"] == before + chain + 1
    assert nk.launches_by_rows[3 * n] == by_rows.get(3 * n, 0) + chain
    assert nk.launches_by_rows[3 * 32768] == by_rows.get(3 * 32768, 0) + 1
    ts_cpu, m_cpu = run("cpu")
    for k, v in m_cpu.items():
        torch.testing.assert_close(m_dev[k], v, rtol=1e-3, atol=1e-4,
                                   msg=k)
    for group in ts_cpu.opt:
        for a, bb in zip(ts_dev.opt[group].moments(),
                         ts_cpu.opt[group].moments()):
            for x, y in zip(a, bb):
                gap = (x.cpu() - y).norm() / y.norm().clamp_min(1e-30)
                assert gap <= 2e-3, (group, float(gap))
    start = state_arrays(states[2])
    for ts in (ts_dev, ts_cpu):
        got = state_arrays(unstack_state(cfg, ts, 2))
        for key, want in start.items():
            if key == "updates":
                assert got[key] == want == 5
            else:
                assert len(got[key]) == len(want), key
                for g, w in zip(got[key], want):
                    assert (torch.as_tensor(g) == torch.as_tensor(w)).all(
                    ), key
