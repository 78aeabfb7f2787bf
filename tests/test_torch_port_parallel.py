"""The port's parallel modes (``nlbac_tpu_torch.parallel``) on the CPU, on
gloo gangs of 2 ranks spawned with a time limit each (``run_gang``):

- the dp=2 ``update_from_batch`` of unicycle and PVTOL against the JAX
  package's ``make_dp_update`` on a 2-device slice of the virtual CPU
  mesh, with the same weights, batches and injected draws as
  ``test_torch_port_gates.py`` and its single-update tolerances, the
  multiplier ascent on from the first update so that the constraint term
  (whose means the ranks sum inside the forward pass) is active;
- under ``--node_solver dopri5``, both forms: the dp=2
  ``update_from_batch`` against JAX's ``make_dp_update`` (metrics rtol
  1e-5 / atol 1e-6, the state rtol 1e-4 / atol 1e-6, the NODE's Adam
  moments within ``NODE_GRAD_FRAC`` of each leaf's largest entry: the
  larger of the gates' and ``test_torch_port_ode.py``'s tolerances), the
  ranks bit-equal with the same count of trial steps; the solver's
  reductions over two ranks' row halves against one rank's (the error
  norm rtol 1e-6, the scan form's trial errors rtol 1e-5, the adjoint's
  gradients summed over the ranks rtol 1e-4 / atol 1e-7, so counted
  once); and ``--dp 2``/``--tp 2`` with dopri5 through the CLI;
- 3 episodes of dp=2 and of tp=2 training (2 episodes of dp=2 ``while``
  and of tp=2 under both dopri5 forms) against the port's own run of
  one rank, at ``tests/test_parallel.py``'s tolerances (reward rtol 2e-4
  / atol 1e-4, the state atol 5e-4 / rtol 2e-3), the ranks' states
  bit-equal to each other after the same count of trial steps, tp's
  weight files those of a run of one;
- the tp layouts against the JAX package's ``_tp_param_specs`` and
  ``shard_state_tp``, and a wide state's shards under half its bytes;
- the async seed runner: each seed bit-equal to its standalone run,
  with a worker process per seed and with workers that hold two;
- a 2-process ``--coordinator/--num_processes/--process_id`` CLI gang
  (rank 0 alone writes files) against the CLI's own spawned ``--dp 2``
  gang, and ``--n_seeds 2 --dp 2`` against ``--n_seeds 2``.
"""

import dataclasses
import glob
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec

import torch_gang_workers as workers
from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state as j_create_train_state
from nlbac_tpu.parallel import make_dp_update as j_make_dp_update
from nlbac_tpu.parallel import make_mesh as j_make_mesh
from nlbac_tpu.parallel import mesh as jmesh
from nlbac_tpu.parallel import shard_state_tp as j_shard_state_tp
from nlbac_tpu.parallel import statistics_scalar as j_statistics_scalar
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import from_reference
from nlbac_tpu_torch.nn import make_field, node_init
from nlbac_tpu_torch.ode import odeint_adjoint
from nlbac_tpu_torch.ode import solvers as tsolvers
from nlbac_tpu_torch.parallel import seeds as seeds_lib
from nlbac_tpu_torch.parallel.tp import _tp_param_specs
from nlbac_tpu_torch.train import cli
from nlbac_tpu_torch.train.driver import create_replays, make_episode_runner
from nlbac_tpu_torch.tree import tree_leaves, tree_unflatten
from test_torch_port_gates import TOL, batches, gated_cfg, out_of_band_key
from test_torch_port_ode import NODE_GRAD_FRAC, close_scaled

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GANG_TIMEOUT = 240  # seconds, for each gang of this file
EPISODES = 3


def dp_cfg(mod, preset):
    """The gates test's tiny config with the multiplier ascent on every
    update from the first (no warm-up)."""
    cfg = gated_cfg(mod, preset)
    return dataclasses.replace(cfg, constraint=dataclasses.replace(
        cfg.constraint, lambda_update_interval=1,
        lagrangian_warmup_episodes=0))


def tiny_cfg():
    """``tests/test_parallel.py``'s training config, in the port."""
    cfg = tconfig.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=10),
        sac=dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=8,
                                updates_per_step=1, start_steps=4),
        node=dataclasses.replace(cfg.node, hidden_dim=8, f_hidden_layers=1,
                                 g_hidden_layers=1, max_batch=8,
                                 update_interval=2),
        replay=tconfig.ReplayConfig(capacity=64, node_capacity=64))


def load_ranks(out, world):
    results = []
    for r in range(world):
        with open(os.path.join(out, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


def _arrays(state, key):
    """The arrays of one entry of ``workers.state_arrays`` (an Adam
    group's (mu, nu) pairs flattened)."""
    return [a for x in state[key]
            for a in (x if isinstance(x, tuple) else (x,))]


def assert_states_equal(a, b):
    assert a.keys() == b.keys() and a["updates"] == b["updates"]
    for key in a:
        if key != "updates":
            got, want = _arrays(a, key), _arrays(b, key)
            assert len(got) == len(want), key
            for u, v in zip(got, want):
                assert np.array_equal(u, v), key


def assert_states_close(got, want, rtol, atol):
    assert got["updates"] == want["updates"]
    for key in want:
        if key == "updates" or key.startswith("adam/") and not got[key]:
            continue  # an Adam group that never stepped holds no moments
        assert len(got[key]) == len(want[key]), key
        for u, v in zip(_arrays(got, key), _arrays(want, key)):
            np.testing.assert_allclose(u, v, rtol=rtol, atol=atol,
                                       err_msg=key)


def jax_dp_case(name, preset, cfg_j, cfg_t):
    """Two updates of JAX's ``make_dp_update`` on a (1, 2) CPU mesh from
    a fresh state: the case the gang's ``workers.dp_updates`` replays
    (the initial arrays, and each update's whole batches and draws) and
    what JAX reached (the state as port arrays, each update's metrics)."""
    n_u = cfg_j.action_dim
    place, dp_update = j_make_dp_update(cfg_j, j_make_mesh((1, 2)))
    ts_j = j_create_train_state(cfg_j, jax.random.PRNGKey(0))
    init = parallel.state_arrays(
        from_reference(jax.tree.map(np.asarray, ts_j), cfg_t, "cpu"))
    # a port run of one rank alongside picks each update's draws
    port = from_reference(jax.tree.map(np.asarray, ts_j), cfg_t, "cpu")
    agent = make_agent(cfg_t, "cpu")
    rng = np.random.default_rng(1)
    updates, metrics = [], []
    for k in range(2):
        batch, node_batch = batches(preset, rng)
        tb = {n: torch.tensor(v) for n, v in batch.items()}
        tnb = {n: torch.tensor(v) for n, v in node_batch.items()}
        key, noise = out_of_band_key(port, tb, preset, k, n_u)
        port, _ = agent.update_core(port, tb, lambda: tnb, None, 0,
                                    noise=noise)
        ts_p, b_p, nb_p, k_p = place(ts_j, batch, node_batch, key)
        ts_j, m_j = dp_update(ts_p, b_p, nb_p, k_p, jnp.int32(0))
        metrics.append({n: float(m_j[n]) for n in METRIC_NAMES})
        updates.append((tb, tnb, noise, 0))
    want = parallel.state_arrays(from_reference(
        jax.tree.map(np.asarray, ts_j), cfg_t, "cpu"))
    return ({"name": name, "cfg": cfg_t, "init": init, "updates": updates},
            (want, metrics))


def run_dp_cases(cases, tmp_path):
    """``workers.dp_updates`` over a gang of 2 ranks: rank 0's results,
    after checking that rank 1's states, metrics and trial counts equal
    them."""
    inputs = tmp_path / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(cases))
    parallel.run_gang(workers.dp_updates, 2, (str(inputs), str(tmp_path)),
                      timeout=GANG_TIMEOUT)
    r0, r1 = load_ranks(tmp_path, 2)
    for case in cases:
        got, other = r0[case["name"]], r1[case["name"]]
        assert_states_equal(got["state"], other["state"])
        assert got["metrics"] == other["metrics"]
        assert got["trials"] == other["trials"]
    return r0


def test_dp_update_matches_jax_make_dp_update(tmp_path):
    """Two dp=2 updates per preset: the first with the NODE fit (its
    16384-row share on each rank in a full-width run) and the backup
    branch, both with the ascent on; metrics, multipliers and every
    parameter, target and Adam moment against JAX's dp update; the two
    ranks bit-equal."""
    cases, expect = [], {}
    for preset in ("unicycle", "pvtol"):
        case, expect[preset] = jax_dp_case(preset, preset,
                                           dp_cfg(jconfig, preset),
                                           dp_cfg(tconfig, preset))
        cases.append(case)
    r0 = run_dp_cases(cases, tmp_path)
    for preset, (want, metrics_j) in expect.items():
        metric_rtol, atol = TOL[preset]
        got = r0[preset]
        for k, (m_t, m_j) in enumerate(zip(got["metrics"], metrics_j)):
            for name in METRIC_NAMES:
                np.testing.assert_allclose(
                    m_t[name], m_j[name], rtol=metric_rtol, atol=1e-6,
                    err_msg=f"{preset} update {k} {name}")
        # the constraint means moved the multipliers; unicycle's CBF
        # columns are active too, so its loss term (nonlinear in the
        # means) is live (PVTOL's CBFs are not, and its balance ratio
        # zeroes the CLF term)
        assert np.abs(got["state"]["lag"][0]).max() > 0, preset
        if preset == "unicycle":
            assert all(m["constraint_loss"] for m in got["metrics"])
        assert_states_close(got["state"], want, rtol=1e-4, atol=atol)


def dopri5_cfg(cfg, impl):
    return dataclasses.replace(cfg, node=dataclasses.replace(
        cfg.node, solver="dopri5", adaptive_impl=impl))


@pytest.mark.parametrize("impl", ["while", "scan"])
def test_dp_dopri5_update_matches_jax_make_dp_update(impl, tmp_path):
    """Under ``--node_solver dopri5`` (``impl``), two dp=2 unicycle
    updates, the NODE fit on in the first and off in the second, against
    JAX's dp update (whose GSPMD norms span the whole batch): the ranks
    bit-equal with the same trial counts; metrics rtol 1e-5 / atol 1e-6;
    parameters, targets and Adam moments rtol 1e-4 / atol 1e-6, but the
    NODE's moments, which hold the fit's gradient through the adaptive
    solve: within ``NODE_GRAD_FRAC[impl]`` of each leaf's largest entry
    (the larger of ``TOL`` and ``test_update_core_dopri5_matches_jax``'s
    tolerances)."""
    case, (want, metrics_j) = jax_dp_case(
        "unicycle", "unicycle", dopri5_cfg(dp_cfg(jconfig, "unicycle"), impl),
        dopri5_cfg(dp_cfg(tconfig, "unicycle"), impl))
    got = run_dp_cases([case], tmp_path)["unicycle"]
    assert [m["node_loss"] > 0 for m in got["metrics"]] == [True, False]
    assert all(n > 0 for n in got["trials"])
    for k, (m_t, m_j) in enumerate(zip(got["metrics"], metrics_j)):
        assert m_t["short_integrations"] == 0
        for name in METRIC_NAMES:
            np.testing.assert_allclose(m_t[name], m_j[name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{k} {name}")
    for key in want:
        if key == "adam/node":
            for u, v in zip(_arrays(got["state"], key), _arrays(want, key)):
                close_scaled(v, u, NODE_GRAD_FRAC[impl], msg=key)
        elif key != "updates":
            for u, v in zip(_arrays(got["state"], key), _arrays(want, key)):
                np.testing.assert_allclose(u, v, rtol=1e-4, atol=1e-6,
                                           err_msg=key)


def test_dopri5_norms_span_the_dp_group(tmp_path):
    """The solver's reductions over two dp ranks, each holding half of 16
    rows (unicycle's NODE at width 12, dopri5 over dt = 0.02): the
    reduced ``_err_norm`` of a trial equals the one-rank norm over all
    rows (rtol 1e-6: only the sum's order differs); the scan form's
    trial errors are the one-rank solve's (rtol 1e-5); and the adjoint's
    parameter gradients, summed over the ranks as the update's ``step``
    sums them, are the one-rank gradients (rtol 1e-4 / atol 1e-7, as
    ``test_torch_port_ode.py``'s), so the NODE's gradient is counted
    once, with the one-rank solve's trial count; the ranks agree bit for
    bit."""
    ncfg = dataclasses.replace(
        tconfig.get_config("unicycle").node, hidden_dim=12,
        f_hidden_layers=2, g_hidden_layers=2, solver="dopri5")
    params = node_init(torch.Generator().manual_seed(3), ncfg)
    rng = np.random.default_rng(4)
    y = torch.tensor(rng.normal(size=(16, 5)).astype(np.float32))
    y5 = y + torch.tensor(rng.normal(size=(16, 5)).astype(np.float32))
    case = {"cfg": ncfg, "params": params, "dt": 0.02, "y": y, "y5": y5,
            "y4": y5 + 1e-6 * torch.tensor(
                rng.normal(size=(16, 5)).astype(np.float32)),
            "x": torch.tensor(rng.normal(size=(16, 3)).astype(np.float32)),
            "u": torch.tensor(rng.uniform(-3, 3, (16, 2)).astype(
                np.float32))}
    inputs = tmp_path / "inputs.pkl"
    inputs.write_bytes(pickle.dumps(case))
    parallel.run_gang(workers.dopri5_halves, 2,
                      (str(inputs), str(tmp_path)), timeout=GANG_TIMEOUT)
    r0, r1 = load_ranks(tmp_path, 2)
    assert r0["err"] == r1["err"] and r0["trials"] == r1["trials"]
    assert r0["scan_errs"] == r1["scan_errs"]
    err = tsolvers._err_norm(case["y5"], case["y4"], case["y"], 1e-5, 1e-7)
    np.testing.assert_allclose(r0["err"], float(err), rtol=1e-6)

    field = make_field(ncfg)
    s0 = torch.cat([case["x"], case["u"]], dim=-1)
    trace = []
    tsolvers.solve_adaptive(field, params, s0, 0.0, 0.02, impl="scan",
                            max_steps=16, trace=trace)
    want = [float(e) for e, _, active in trace if active]
    np.testing.assert_allclose(r0["scan_errs"], want, rtol=1e-5)
    leaves = [p.clone().requires_grad_(True) for p in tree_leaves(params)]
    plain_trial = tsolvers._trial
    counter = workers.count_trials()
    try:
        s1 = odeint_adjoint(field, tree_unflatten(params, leaves), s0, 0.0,
                            0.02, method="dopri5")
        loss = torch.mean(torch.square(s1[:, :ncfg.state_dim]))
        grads = torch.autograd.grad(loss, leaves)
    finally:
        tsolvers._trial = plain_trial
    assert r0["trials"] == counter[0] > 0
    np.testing.assert_allclose(r0["loss"] + r1["loss"], loss.item(),
                               rtol=1e-6)
    for a, b, g in zip(r0["grads"], r1["grads"], grads):
        np.testing.assert_allclose(a + b, g.numpy(), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("layout", ["dp", "tp", "dp_dopri5_while",
                                    "tp_dopri5_while", "tp_dopri5_scan"])
def test_gang_training_matches_one_rank(layout, tmp_path):
    """3 episodes (2 under dopri5) of dp=2 or tp=2 against the port's run
    of one rank:
    rewards, update counts, the whole state and the replays; every rank
    holds the same (whole) state, after the same count of adaptive trial
    steps under ``--node_solver dopri5``; under tp the first gather gives
    back the initial state exactly, each rank holds less than the whole,
    and rank 0's weight files (made from the gathered state) are those of
    a run of one."""
    cfg, episodes = tiny_cfg(), EPISODES
    if "dopri5" in layout:
        cfg, episodes = dopri5_cfg(cfg, layout.rsplit("_", 1)[1]), 2
    dp, tp = (2, 1) if layout.startswith("dp") else (1, 2)
    parallel.run_gang(workers.train_episodes, 2,
                      (cfg, dp, tp, episodes, str(tmp_path)),
                      timeout=GANG_TIMEOUT)
    ranks = load_ranks(tmp_path, 2)
    rewards, ts1, rl1 = workers.one_rank_run(cfg, episodes)
    want = parallel.state_arrays(ts1)
    for r in ranks:
        np.testing.assert_allclose(r["rewards"], rewards, rtol=2e-4,
                                   atol=1e-4)
        assert r["updates"][-1] == ts1.updates > 0
        np.testing.assert_allclose(r["replay"], rl1.data.numpy(), atol=1e-5)
    assert_states_equal(ranks[0]["state"], ranks[1]["state"])
    assert np.array_equal(ranks[0]["replay"], ranks[1]["replay"])
    assert ranks[0]["trials"] == ranks[1]["trials"]
    assert (ranks[0]["trials"] > 0) == ("dopri5" in layout)
    assert_states_close(ranks[0]["state"], want, rtol=2e-3, atol=5e-4)
    with open(tmp_path / "weights" / "actor.pkl", "rb") as f:
        actor = pickle.load(f)
    leaves = tree_leaves(actor)
    assert [a.shape for a in leaves] == [a.shape for a in want["policy"]]
    for a, b in zip(leaves, want["policy"]):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=5e-4)
    fresh = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    whole_bytes = parallel.shard_bytes(fresh)
    if tp > 1:
        assert_states_equal(ranks[0]["first"], parallel.state_arrays(fresh))
        assert all(r["shard_bytes"] < whole_bytes for r in ranks)
    else:
        assert all(r["shard_bytes"] == whole_bytes for r in ranks)


def _spec_tree(ts_j, shard):
    """(path, spec) of every leaf of a JAX state sharded by
    ``j_shard_state_tp``, parameters and targets only."""
    flat, _ = jax.tree_util.tree_flatten_with_path(shard)
    return {jax.tree_util.keystr(p): tuple(x.sharding.spec)
            for p, x in flat}


@pytest.mark.parametrize("ntp", [2, 4])
def test_tp_layouts_match_jax(ntp):
    """Every MLP dict's specs equal the JAX package's ``_tp_param_specs``
    (PartitionSpecs as tuples), and rank 0's shard of every parameter,
    target and Adam moment has the shape of the JAX device 0's shard."""
    cfg_j = jconfig.get_config("unicycle")
    cfg_j = dataclasses.replace(cfg_j, sac=dataclasses.replace(
        cfg_j.sac, hidden_dim=24))
    cfg_t = dataclasses.replace(tconfig.get_config("unicycle"),
                                sac=dataclasses.replace(
                                    tconfig.get_config("unicycle").sac,
                                    hidden_dim=24))
    ts_j = j_create_train_state(cfg_j, jax.random.PRNGKey(0))
    for name in ("policy", "critic", "lyap", "barrier", "node"):
        tree = getattr(ts_j, name)
        nets = ([tree["trunk"], tree["mean"], tree["log_std"]]
                if name == "policy" else
                [tree["q1"], tree["q2"]] if name == "critic" else
                [tree["f"], tree["g"]] if name == "node" else [tree])
        for net in nets:
            want = jmesh._tp_param_specs(net, ntp, "tp")
            got = _tp_param_specs(
                {"w": [torch.zeros(w.shape) for w in net["w"]],
                 "b": [torch.zeros(b.shape) for b in net["b"]]}, ntp)
            assert got == {k: [tuple(s) for s in v]
                           for k, v in want.items()}
            assert all(isinstance(s, PartitionSpec) for s in want["w"])
    mesh = j_make_mesh((1, ntp), ("dp", "tp"))
    sharded_j = j_shard_state_tp(ts_j, mesh)
    port = from_reference(jax.tree.map(np.asarray, ts_j), cfg_t, "cpu",
                          grid=parallel.ProcessGrid.local(1, ntp, 0))
    for name in ("policy", "backup_policy", "critic", "critic_target",
                 "lyap", "lyap_target", "barrier", "barrier_target", "node"):
        for a, b in zip(jax.tree.leaves(getattr(sharded_j, name)),
                        tree_leaves(getattr(port, name))):
            assert tuple(b.shape) == a.addressable_shards[0].data.shape
    for net, layer in (("q1", 0), ("q1", 1), ("q2", 2)):
        mu = sharded_j.opt["critic"][0].mu[net]["w"][layer]
        p = port.critic[net]["w"][layer]
        assert tuple(port.opt["critic"].state[p]["exp_avg"].shape) == \
            mu.addressable_shards[0].data.shape


def test_tp_shards_hold_under_half_the_bytes():
    """As ``test_tp_param_memory_shards``: at hidden 512 (NODE 64) and
    tp=8, a hidden x hidden weight and its Adam moments hold 1/8 on a
    rank, and a rank's parameters, targets and moments under half the
    whole state's."""
    cfg = tconfig.get_config("unicycle")
    cfg = dataclasses.replace(
        cfg, sac=dataclasses.replace(cfg.sac, hidden_dim=512),
        node=dataclasses.replace(cfg.node, hidden_dim=64))
    ts = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    for opt in ts.opt.values():  # moments as after a first step
        for p in opt.param_groups[0]["params"]:
            opt.state[p] = {"step": torch.tensor(1.0),
                            "exp_avg": torch.zeros_like(p),
                            "exp_avg_sq": torch.zeros_like(p)}
    shard = parallel.shard_state_tp(ts, parallel.ProcessGrid.local(1, 8, 3))
    w, w_full = shard.critic["q1"]["w"][1], ts.critic["q1"]["w"][1]
    assert w.numel() * 8 == w_full.numel()
    assert shard.opt["critic"].state[w]["exp_avg"].shape == w.shape
    assert parallel.shard_bytes(shard) < 0.5 * parallel.shard_bytes(ts)


@pytest.mark.parametrize("cores", [
    pytest.param(None, id="processes"),
    pytest.param(2, id="shared_workers")])
def test_async_seed_runner_reproduces_standalone_runs(cores, monkeypatch):
    """``--n_seeds``' runner on the CPU, ``block=False``: each seed's
    rewards, K1 launch counts and final state are bit-equal to its
    standalone run (seed ``base + i``, the generator used as ``train()``
    uses it), with a worker process per seed and with fewer cores than
    seeds (two workers, the first holding seeds 0 and 2)."""
    if cores is not None:
        monkeypatch.setattr(seeds_lib, "_cores", lambda: cores)
    cfg = tiny_cfg()
    n_seeds, base = 3, 7
    init_fn, step_fn = parallel.make_async_seed_runner(
        cfg, devices=["cpu"], n_seeds=n_seeds)
    try:
        states = init_fn(base)
        assert len(step_fn._procs) == min(n_seeds, cores or n_seeds)
        results = []
        for ep in range(2):
            states, futures = step_fn(states, ep, block=False)
            results.append([f.result() for f in futures])
        got = [step_fn.fetch(i) for i in range(n_seeds)]
    finally:
        step_fn.close()
    for i in range(n_seeds):
        seeded = dataclasses.replace(cfg, run=dataclasses.replace(
            cfg.run, seed=base + i))
        gen = torch.Generator().manual_seed(seeded.run.seed)
        ts = create_train_state(seeded, gen, "cpu")
        rl, node = create_replays(seeded, "cpu")
        run = make_episode_runner(seeded, "cpu")
        total = 0
        for ep in range(2):
            ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
            assert float(m.reward) == results[ep][i]["reward"]
            assert ts.updates == results[ep][i]["updates"]
            # the CPU's wrapper counts no launch, in a worker as here
            assert results[ep][i]["kernel_launches"] == 0
        arrays, rl_rows, node_rows, got_total = got[i]
        assert_states_equal(arrays, parallel.state_arrays(ts))
        assert np.array_equal(rl_rows, rl.data.numpy())
        assert np.array_equal(node_rows, node.data.numpy())
        assert got_total == total


def test_statistics_scalar_matches_reference():
    x = [1.0, 2.0, 3.0, 6.0]
    got = parallel.statistics_scalar(x, with_min_and_max=True)
    want = j_statistics_scalar(jnp.asarray(x), with_min_and_max=True)
    np.testing.assert_allclose(got, [float(v) for v in want], rtol=1e-6)


def test_grid_needs_a_world_and_nccl_a_card():
    """A grid larger than the world raises as JAX's ``make_mesh``; NCCL
    is refused for a rank without a card before any group forms."""
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        parallel.make_mesh((2, 1))
    grid = parallel.make_mesh((1, 1))
    assert (grid.dp, grid.tp, grid.dp_index, grid.tp_index) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        parallel.init_distributed("localhost:1", 2, 0, backend="nccl",
                                  device="cpu")
    assert not torch.distributed.is_initialized()
    local = parallel.ProcessGrid.local(2, 2, 3)
    assert (local.dp_index, local.tp_index) == (1, 1)


def test_init_distributed_takes_the_card_unless_told():
    """Without a ``device`` a gang's rank takes the card, as every other
    entry point does: with no GPU it raises before any group forms (the
    CPU only when named); one process joins nothing either way."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed("localhost:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.init_distributed("localhost:1", 2, 0, backend="gloo")
    parallel.init_distributed()
    assert not torch.distributed.is_initialized()


BASE = ["--preset", "unicycle", "--cpu", "--quiet", "--max_episode_steps",
        "6", "--batch_size", "4", "--start_steps", "2", "--replay_size",
        "512", "--hidden_size", "16"]
KNOBS = BASE + ["--max_episodes", "2"]


def progress(out):
    (path,) = glob.glob(os.path.join(str(out), "*-run*", "*", "*_s*",
                                     "progress.txt"))
    header, *rows = open(path).read().splitlines()
    cols = np.array([[float(v) for v in r.split("\t")] for r in rows])
    return dict(zip(header.split("\t"), cols.T))


def test_multihost_cli_gang_writes_on_rank0_only(tmp_path):
    """Two processes joined by --coordinator/--num_processes/--process_id
    train --dp 2 (rank 0 alone makes the run directory and its files;
    rank 1 prints ``-> None``) and match the CLI's own spawned --dp 2
    gang column for column."""
    port = parallel.free_port()
    gang_out = tmp_path / "gang"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    procs = [subprocess.Popen(
        [sys.executable, "-m", "nlbac_tpu_torch.train.cli", *KNOBS,
         "--dp", "2", "--coordinator", f"localhost:{port}",
         "--num_processes", "2", "--process_id", str(pid),
         "--output", str(gang_out)],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    try:
        outs = [p.communicate(timeout=GANG_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {pid}:\n{out[-3000:]}"
    assert "rank=1/2 -> None" in outs[1]
    (run,) = glob.glob(os.path.join(str(gang_out), "*-run*", "*", "*_s*"))
    for name in ("progress.txt", "config.json", "actor.pkl", "critic.pkl",
                 "checkpoint.npz"):
        assert os.path.exists(os.path.join(run, name)), name
    assert len(glob.glob(os.path.join(str(gang_out), "*-run*"))) == 1
    cols = progress(gang_out)
    assert cols["updates"][-1] > 0 and np.all(np.isfinite(cols["qf1_loss"]))

    cli.main(KNOBS + ["--dp", "2", "--output", str(tmp_path / "spawned")])
    ref = progress(tmp_path / "spawned")
    for k in ("reward_train", "qf1_loss", "qf2_loss", "lf_loss",
              "policy_loss", "node_loss", "episode_steps", "updates"):
        np.testing.assert_allclose(cols[k], ref[k], rtol=2e-4, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("flags", [
    ["--dp", "2"], ["--tp", "2", "--node_adaptive_impl", "scan"]],
    ids=["dp_while", "tp_scan"])
def test_cli_gangs_train_dopri5(flags, tmp_path):
    """``--node_solver dopri5`` trains in a spawned gang, as the JAX CLI
    takes it (the 32768-row NODE fit skipped: its dopri5 solve takes
    minutes on the CPU); rank 0 writes progress.txt with updates and
    finite losses."""
    cli.main(KNOBS + ["--node_solver", "dopri5", "--NODE_fit_episode_limit",
                      "-1", *flags, "--output", str(tmp_path)])
    cols = progress(tmp_path)
    assert cols["updates"][-1] > 0
    for k in ("qf1_loss", "policy_loss", "lf_loss"):
        assert np.all(np.isfinite(cols[k])), k


def test_seeds_over_dp_groups_match_seeds_alone(tmp_path):
    """``--n_seeds 2 --dp 2`` (both seeds on one group of 2 CPU ranks)
    against ``--n_seeds 2`` in one process: each seed's progress.txt
    within the dp tolerances."""
    flags = KNOBS + ["--n_seeds", "2"]
    cli.main(flags + ["--dp", "2", "--output", str(tmp_path / "dp")])
    cli.main(flags + ["--output", str(tmp_path / "one")])
    for seed in (12345, 12346):
        got, want = [dict(zip(*_cols(tmp_path / d, seed)))
                     for d in ("dp", "one")]
        for k in ("reward_train", "qf1_loss", "updates", "episode_steps"):
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4,
                                       atol=1e-4, err_msg=f"{seed} {k}")


def _cols(out, seed):
    (path,) = glob.glob(os.path.join(str(out), "*-run*", f"s{seed}",
                                     "progress.txt"))
    header, *rows = open(path).read().splitlines()
    cols = np.array([[float(v) for v in r.split("\t")] for r in rows])
    return header.split("\t"), cols.T


def test_dp_resume_continues_the_run(tmp_path):
    """``--dp 2 --resume`` (every rank restores the checkpoint rank 0
    wrote, then takes rank 0's state) continues a 1-episode --dp 2 run
    into the second episode of an unbroken 2-episode --dp 2 run."""
    flags = BASE
    cli.main(flags + ["--dp", "2", "--max_episodes", "2",
                      "--output", str(tmp_path / "whole")])
    cli.main(flags + ["--dp", "2", "--max_episodes", "1",
                      "--output", str(tmp_path / "first")])
    (ckpt,) = glob.glob(os.path.join(str(tmp_path / "first"), "*-run*",
                                     "*", "*_s*", "checkpoint.npz"))
    cli.main(flags + ["--dp", "2", "--max_episodes", "2", "--resume", ckpt,
                      "--output", str(tmp_path / "resumed")])
    whole, resumed = progress(tmp_path / "whole"), progress(
        tmp_path / "resumed")
    assert list(resumed["Episode"]) == [1.0]
    for k, v in resumed.items():
        np.testing.assert_allclose(v, whole[k][1:], rtol=1e-6, atol=1e-7,
                                   err_msg=k)
