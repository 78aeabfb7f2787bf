"""The lockstep seed runner under ``--node_solver dopri5`` and with a
constraint builder that does not declare ``SEED_AXIS``, on the CPU, against
each seed's standalone run (tests/test_torch_port_lockstep_dopri5.py holds
the solver, the adjoint and one update against ``jax.vmap``):

(e) S unicycle seeds under each form for 2 episodes, each seed's
    episodes, state, rings and generator against its standalone run, its
    count of short integrations included;
(e') the per-seed count of short integrations of one seed-batched update
    whose seeds have different gates, against each seed's one-seed update;
(f) unicycle's builder registered without ``SEED_AXIS`` (called once per
    seed), under Euler and dopri5, against the built-in kind.

Tolerances: the runner tests' (tests/test_torch_port_lockstep.py) rtol
1e-4 / atol 1e-5, the counts of steps, updates and short integrations
equal; under dopri5 the NODE's parameters and Adam moments, which hold
the fits' gradients through the adaptive solve, within ``NODE_GRAD_FRAC``
of each leaf's largest entry (the float32 noise of those gradients,
tests/test_torch_port_ode.py): a batched product need not round as the
one-seed product, and the adaptive steps carry that into the gradient.
"""

import dataclasses

import numpy as np
import pytest
import torch

from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state as t_create
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.state import stack_states, unstack_state
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.ops import node_kernel as nk
from test_torch_port_lockstep import (
    FIRST_AXIS_BUILDER,
    _builder,
    check_seed_against_standalone,
    run_lockstep,
    runner_cfg,
)
from test_torch_port_lockstep_dopri5 import (
    BATCH,
    NODE_BATCH,
    S,
    dopri5_cfg,
    one_thread,  # noqa: F401 (the autouse fixture)
)
from test_torch_port_ode import NODE_GRAD_FRAC
from test_torch_port_update import make_batch

# ---------------------------------------------------------------------------
# (e) the runner against each seed's standalone run; (f) a builder without
# SEED_AXIS
# ---------------------------------------------------------------------------

EPISODES = 2


def short_cfg(cfg):
    """The runner tests' config cut to 2 episodes of 16 steps (updates
    from step 9, a fit every 5th), the policy acting from the second."""
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, max_episode_steps=16),
        sac=dataclasses.replace(cfg.sac, start_steps=16))


def dopri5_runner_cfg(impl):
    """The runner tests' config under dopri5 (the scan form's 16 trial
    steps a solve: 4 leave most of this run's solves short)."""
    return short_cfg(dopri5_cfg(tconfig, impl, base=lambda _: runner_cfg()))


@pytest.mark.parametrize("impl", ["while", "scan"])
def test_dopri5_runner_matches_standalone_runs(impl):
    """S = 3 unicycle seeds under dopri5 for 2 episodes: each seed's
    episodes (its short_integrations included), state, rings and generator
    against its standalone run."""
    cfg, base = dopri5_runner_cfg(impl), 11
    results, ts, rl, node, gens, total = run_lockstep(cfg, base,
                                                      episodes=EPISODES)
    assert min(ts.updates) > 0
    for i in range(S):
        check_seed_against_standalone(cfg, i, base, results, ts, rl, node,
                                      gens, total, NODE_GRAD_FRAC[impl])


def test_short_integrations_are_counted_per_seed_gate():
    """With one trial step a solve (adaptive_scan_steps=1) every solve ends
    short. A seed-batched update with seed 0 fitting, seed 1 not, and seed
    2 sitting out counts for each seed the flags of the calls whose gate
    it had on, as its one-seed update counts them: seed 0 its rollout, its
    backup branch's and its fit's, seed 1 the first two, seed 2 none."""
    cfg = dopri5_runner_cfg("scan")
    cfg = dataclasses.replace(cfg, node=dataclasses.replace(
        cfg.node, adaptive_scan_steps=1, max_batch=NODE_BATCH),
        sac=dataclasses.replace(cfg.sac, batch_size=BATCH))
    gens = [torch.Generator().manual_seed(30 + i) for i in range(S)]
    states = [t_create(cfg, g, "cpu") for g in gens]
    for one, n in zip(states, (0, 1, 2)):  # a fit every 5th update
        one.updates = n
    ts = stack_states(cfg, states)  # copies
    rng = np.random.default_rng(9)
    batches = [make_batch(rng, BATCH) for _ in range(S)]
    node_batches = [make_batch(rng, NODE_BATCH) for _ in range(S)]

    def stacked(bs):
        return {k: torch.stack([torch.tensor(b[k]) for b in bs])
                for k in bs[0]}

    agent = t_make_agent(cfg, "cpu")
    on = [True, True, False]
    _, m = agent.update_core(ts, stacked(batches),
                             lambda fit: stacked(node_batches), gens, 0,
                             seeds=on)
    want = []
    for i in range(S):
        if not on[i]:
            want.append(0)
            continue
        _, m1 = agent.update_core(
            states[i], {k: torch.tensor(v) for k, v in batches[i].items()},
            lambda: {k: torch.tensor(v) for k, v in node_batches[i].items()},
            torch.Generator().manual_seed(30 + i), 0)
        want.append(int(m1["short_integrations"]))
    assert want == [3, 2, 0]
    assert m["short_integrations"].tolist() == want


@pytest.mark.parametrize("solver", ["euler", "dopri5"])
def test_builder_without_seed_axis_matches_built_in_kind(solver):
    """unicycle's builder registered again without SEED_AXIS: the runner
    calls it once per seed (K1 once per seed and call under Euler, the
    fit still one seed-batched launch) and each seed's episode and state
    match the built-in kind's seed-batched call."""
    cfg = runner_cfg() if solver == "euler" else dopri5_runner_cfg("scan")
    cfg = short_cfg(cfg)
    nk.reset_launch_counts()
    want, want_ts, *_ = run_lockstep(cfg, 5, episodes=1)
    got, got_ts, *_ = run_lockstep(
        _builder(cfg, "unicycle_first_axis", FIRST_AXIS_BUILDER), 5,
        episodes=1)
    assert got_ts.updates == want_ts.updates and min(got_ts.updates) > 0
    assert nk.launch_counts["node_euler"] == 0  # the CPU runs the plain step
    for i in range(S):
        for k in ("steps", "updates_done"):
            assert got[0][i][k] == want[0][i][k]
        for k in ("reward", "short_integrations"):
            np.testing.assert_allclose(got[0][i][k], want[0][i][k],
                                       rtol=1e-4, atol=1e-5)
        for k in METRIC_NAMES:
            np.testing.assert_allclose(got[0][i]["train"][k],
                                       want[0][i]["train"][k], rtol=1e-4,
                                       atol=1e-5, err_msg=k)
        a = parallel.state_arrays(unstack_state(cfg, got_ts, i))
        b = parallel.state_arrays(unstack_state(cfg, want_ts, i))
        for key in b:
            if key != "updates":
                for x, y in zip(a[key], b[key]):
                    np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                               rtol=1e-4, atol=1e-5,
                                               err_msg=key)
