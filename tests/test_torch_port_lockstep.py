"""The lockstep seed runner (``nlbac_tpu_torch.parallel.lockstep``) and its
seed-batched parts, on the CPU, against the JAX package and against the
port's own one-seed path:

(a) one seed-batched update against ``jax.vmap`` of JAX's
    ``update_from_batch``, three seeds at different counters (one fits
    the NODE and ascends, one does neither, one ascends only), the
    states carried across by ``from_reference_stacked``;
(b) K1's seed-batched plain version against one call per seed and
    against ``jax.vmap`` of JAX's ``predict_next_state``, forward and
    gradients;
(c) the runner against each seed's standalone ``make_episode_runner``
    run (generator ``base + i``);
(d) masking: seeds whose episodes end at different steps, a finished
    seed's state, rings and generator bit-equal while the others run;
(e) ``tests/test_parallel.py``'s assertions on JAX's runner;
(f) what the runner refused and takes since (dopri5, a builder without
    ``SEED_AXIS``, several devices, a stacked twin-Q state) and the
    refusals that stay (seeds that do not split evenly over the devices,
    seeds in different twin-Q layouts);
(g) ``SeedAdam`` against ``torch.optim.Adam`` seed by seed, masks
    included.

Tolerances. (a): the single-update tests' (metrics rtol 1e-5 / atol
1e-6; parameters, moments and the Lagrangian state rtol 1e-4 / atol
1e-6), the samples kept below pre-tanh 3 as ``test_torch_port_gates.py``
keeps them. (b): rtol 1e-5 / atol 1e-6 against JAX, rtol 1e-6 / atol
1e-7 against the port's one-seed calls (a batched product need not round
as the one-seed product). (c), (d): the runner's seeds against their
standalone runs over 3 episodes: steps, updates and replay sizes equal;
rewards, the last update's metrics, replay rows and the whole state
within rtol 1e-4 / atol 1e-5 (float32 rounding of the batched products,
carried through 3 episodes of training; the largest gap seen is below
1e-5). (g): rtol 1e-6 / atol 1e-9, and a masked-off seed bit for bit.

(c) and (d), and every runner held against its seeds' standalone runs in
the other lockstep modules, run both sides under ``squash="torch"``
(``RUN_SQUASH``). Under the default XLA-form squash, one ulp of a sample
near saturation moves the squash term by up to 0.27 nats (``torch.tanh``'s
by 2.1e-3), so the batched products' rounding leaves these tolerances:
nbc_unicycle's standalone run with every network's initial weights one ulp
up leaves them by 5 to 8 times (under ``torch.tanh`` it moves 0.008-0.020
of them). The squash's own plumbing through the
runner is held in ``test_torch_port_squash_xla.py``.
"""

import dataclasses
import hashlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu.config import NodeConfig as JNodeConfig
from nlbac_tpu.nn import node_init as j_node_init
from nlbac_tpu.nn import predict_next_state as j_predict_next_state
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state as t_create
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.state import stack_states, unstack_state
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.constraints import register_builder
from nlbac_tpu_torch.constraints import unicycle as t_unicycle_builder
from nlbac_tpu_torch.envs import register_env
from nlbac_tpu_torch.envs import unicycle as t_unicycle
from nlbac_tpu_torch.experimental import stack_twin_q_state
from nlbac_tpu_torch.interop import (
    from_reference,
    from_reference_stacked,
    to_reference_stacked,
)
from nlbac_tpu_torch.nn import SeedAdam
from nlbac_tpu_torch.ops import node_kernel as nk
from nlbac_tpu_torch.train import create_replays, make_episode_runner
from nlbac_tpu_torch.train.driver import episode_to_host
from nlbac_tpu_torch.tree import tree_leaves, tree_map
from test_torch_port_gates import out_of_band_key
from test_torch_port_presets import leaves_with_paths
from test_torch_port_update import make_batch

S = 3
BATCH, NODE_BATCH = 6, 8
DT = 0.02
# each seed's updates before the compared one: its gates there (fit every
# 3rd update, ascent every 4th, target every 2nd) are seed 0 fit, ascent
# and target; seed 1 none; seed 2 ascent and target
COUNTERS = (0, 1, 4)


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as the dopri5 tests run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gated_cfg(mod):
    cfg = mod.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, max_batch=NODE_BATCH,
                                 update_interval=3),
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH,
                                target_update_interval=2),
        constraint=dataclasses.replace(cfg.constraint,
                                       lambda_update_interval=4),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def as_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def stack_trees(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def take(tree, i):
    return jax.tree.map(lambda x: x[i], tree)


# ---------------------------------------------------------------------------
# (a) the seed-batched update against jax.vmap(update_from_batch)
# ---------------------------------------------------------------------------

def test_seed_batched_update_matches_jax_vmap():
    cfg_j, cfg_t = gated_cfg(jconfig), gated_cfg(tconfig)
    update = jax.jit(make_agent(cfg_j).update_from_batch)
    vupdate = jax.jit(jax.vmap(make_agent(cfg_j).update_from_batch,
                               in_axes=(0, 0, 0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    ts = jax.vmap(lambda k: create_train_state(cfg_j, k))(keys)
    rng = np.random.default_rng(2)
    seeds = []
    for i, n in enumerate(COUNTERS):  # seed i after n updates of its own
        ts_i = take(ts, i)
        for k in range(n):
            ts_i, _ = update(ts_i, make_batch(rng, BATCH),
                             make_batch(rng, NODE_BATCH),
                             jax.random.PRNGKey(50 + 10 * i + k),
                             jnp.int32(0))
        seeds.append(ts_i)
    ts = stack_trees(seeds)
    assert np.asarray(ts.updates).tolist() == list(COUNTERS)

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
    lam_before = port.lag.lam.clone()
    port, m_t = agent.update_from_batch(port, tb, tnb, None, 1, noise=noise)

    # the gates differ across the seeds as planned
    assert (np.asarray(m_j["node_loss"]) > 0).tolist() == [True, False,
                                                            False]
    ascended = [not torch.equal(port.lag.lam[i], lam_before[i])
                for i in range(S)]
    assert ascended == [True, False, True]
    assert port.updates == [n + 1 for n in COUNTERS]
    for k in METRIC_NAMES:
        assert m_t[k].shape == (S,), k
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    expect = as_numpy(ts_j)
    got = to_reference_stacked(port, expect, cfg_t)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb and a.shape == b.shape, pa
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=pa)


# ---------------------------------------------------------------------------
# (b) K1's seed-batched plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dims", [(3, 2), (6, 2)])
def test_seed_batched_plain_kernel_matches_seed_calls_and_jax(dims):
    n_s, n_u = dims
    nk.reset_launch_counts()
    cfg = JNodeConfig(form="control_affine", state_dim=n_s, action_dim=n_u,
                      hidden_dim=12, f_hidden_layers=4, g_hidden_layers=3)
    rng = np.random.default_rng(5)
    params = stack_trees([jax.tree.map(
        lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
        j_node_init(jax.random.PRNGKey(i), cfg)) for i in range(S)])
    rows = 9
    x = rng.normal(size=(S, rows, n_s)).astype(np.float32)
    u = rng.normal(size=(S, rows, n_u)).astype(np.float32)
    cot = rng.normal(size=(S, rows, n_s)).astype(np.float32)

    def loss_j(p, xx, uu):
        y = jax.vmap(lambda pp, a, b: j_predict_next_state(cfg, pp, a, b,
                                                           DT))(p, xx, uu)
        return jnp.sum(y * cot), y

    (_, y_j), (gp_j, gx_j, gu_j) = jax.value_and_grad(
        loss_j, argnums=(0, 1, 2), has_aux=True)(params, x, u)

    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                             requires_grad=True), params)
    xt = torch.tensor(x, requires_grad=True)
    ut = torch.tensor(u, requires_grad=True)
    for step in (nk.node_euler_step_plain, nk.node_euler_step):
        y_t = step(tp, xt, ut, DT)
        grads = torch.autograd.grad((y_t * torch.tensor(cot)).sum(),
                                    [xt, ut] + tree_leaves(tp))
        np.testing.assert_allclose(y_t.detach().numpy(), np.asarray(y_j),
                                   rtol=1e-5, atol=1e-6)
        for a, b in zip([gx_j, gu_j] + jax.tree.leaves(gp_j), grads):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-6)
        for i in range(S):  # against the one-seed plain call
            one = tree_map(lambda p: p[i].detach(), tp)
            xi = xt[i].detach().requires_grad_(True)
            ui = ut[i].detach().requires_grad_(True)
            y_1 = nk.node_euler_step_plain(one, xi, ui, DT)
            torch.testing.assert_close(y_t[i], y_1, rtol=1e-6, atol=1e-7)
            g_1 = torch.autograd.grad((y_1 * torch.tensor(cot[i])).sum(),
                                      [xi, ui])
            torch.testing.assert_close(grads[0][i], g_1[0], rtol=1e-6,
                                       atol=1e-7)
            torch.testing.assert_close(grads[1][i], g_1[1], rtol=1e-6,
                                       atol=1e-7)
    # the CPU path launches no kernel, and the stacked form is validated
    # as the kernel would take it
    assert nk.launch_counts["node_euler"] == 0
    stacked = tree_map(lambda p: p.detach(), tp)
    nk.validate(stacked, xt.detach(), ut.detach())
    with pytest.raises(ValueError, match="do not chain"):
        nk.validate(stacked, xt[0].detach(), ut[0].detach())
    with pytest.raises(ValueError, match=r"\(S, B, n_s\)"):
        nk.validate(stacked, xt.detach(), ut[:2].detach())


# ---------------------------------------------------------------------------
# (c)-(e) the runner
# ---------------------------------------------------------------------------

EPISODES, STEPS = 3, 24


def runner_cfg(env_name="unicycle"):
    cfg = tconfig.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, name=env_name,
                                max_episode_steps=STEPS),
        sac=dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=8,
                                start_steps=STEPS),
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, max_batch=16,
                                 update_interval=5),
        constraint=dataclasses.replace(cfg.constraint,
                                       lambda_update_interval=3),
        supervisor=dataclasses.replace(cfg.supervisor,
                                       enable_after_episodes=1, min_steps=4,
                                       window=4, trap_count=2,
                                       trap_threshold=0.5),
        replay=tconfig.ReplayConfig(capacity=40, node_capacity=50))


# the policy's squash of every run held against its standalone runs (the
# module's note)
RUN_SQUASH = "torch"


def standalone(cfg, seed, episodes, prepare=None):
    """``train()``'s single-seed loop for ``seed`` (its state passed
    through ``prepare(cfg, ts)`` where given): each episode's host
    metrics and the final state, rings, total and generator."""
    gen = torch.Generator().manual_seed(seed)
    ts = t_create(cfg, gen, "cpu")
    if prepare is not None:
        ts = prepare(cfg, ts)
    rl, node = create_replays(cfg, "cpu")
    run = make_episode_runner(cfg, "cpu", squash=RUN_SQUASH)
    total, out = 0, []
    for ep in range(episodes):
        ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
        out.append(dict(episode_to_host(m), updates_done=m.updates_done))
    return out, ts, rl, node, total, gen


def close(a, b, what):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-5, err_msg=what)


def close_to_largest(a, b, frac, what):
    """max |a - b| <= frac * max |b| (+ 1e-7 for all-zero leaves)."""
    a, b = np.asarray(a), np.asarray(b)
    gap, scale = np.abs(a - b).max(), np.abs(b).max()
    assert gap <= frac * scale + 1e-7, f"{what}: max gap {gap} vs {scale}"


def check_seed_against_standalone(cfg, i, base, results, ts, rl, node, gens,
                                  total, node_frac=None, prepare=None):
    """Seed i of a lockstep run against its standalone run. ``node_frac``
    holds the NODE's parameters and Adam moments within that fraction of
    each leaf's largest entry instead (a dopri5 fit's gradient through
    the adaptive solve is float32 noise at that scale; see
    tests/test_torch_port_ode.py's NODE_GRAD_FRAC)."""
    rings = [parallel.lockstep.replay_lib.unstack_replay(r, i)
             for r in (rl, node)]
    check_fetched_against_standalone(
        cfg, i, base, [ep[i] for ep in results],
        (parallel.state_arrays(unstack_state(cfg, ts, i)),
         *((r.data.numpy(), r.position, r.size, r.total) for r in rings),
         total[i], gens[i].get_state().numpy()), node_frac, prepare)


def check_fetched_against_standalone(cfg, i, base, episodes, fetched,
                                     node_frac=None, prepare=None):
    """Seed i's episodes (its host metrics, one per episode) and its state
    on the host, ``fetched`` in ``ShardedSeedRunner.fetch``'s form
    (``(state_arrays, rl ring, node ring, total, generator state)``),
    against its standalone run (``check_seed_against_standalone``)."""
    arrays, rl_ring, node_ring, total_i, gen_state = fetched
    want, ts1, rl1, node1, total1, gen1 = standalone(
        cfg, base + i, len(episodes), prepare)
    for ep, (got, want_ep) in enumerate(zip(episodes, want)):
        assert got["steps"] == want_ep["steps"], (i, ep)
        assert got["updates_done"] == want_ep["updates_done"], (i, ep)
        assert got["short_integrations"] == \
            want_ep["short_integrations"], (i, ep)
        for k in ("reward", "num_violations", "safety_cost",
                  "backup_steps"):
            close(got[k], want_ep[k], f"seed {i} episode {ep} {k}")
        for k in METRIC_NAMES:
            close(got["train"][k], want_ep["train"][k],
                  f"seed {i} episode {ep} train {k}")
    assert total_i == total1
    a, b = arrays, parallel.state_arrays(ts1)
    assert a["updates"] == b["updates"]
    for key in b:
        if key == "updates":
            continue
        assert len(a[key]) == len(b[key]), key
        for j, (x, y) in enumerate(zip(a[key], b[key])):
            if node_frac is not None and key in ("node", "adam/node"):
                for k, (xk, yk) in enumerate(zip(*(
                        (v,) if key == "node" else v for v in (x, y)))):
                    close_to_largest(xk, yk, node_frac,
                                     f"seed {i} {key}[{j}] {k}")
            else:
                close(x, y, f"seed {i} {key}")
    for (data, position, size, pushes), plain in ((rl_ring, rl1),
                                                  (node_ring, node1)):
        assert (position, size, pushes) == \
            (plain.position, plain.size, plain.total)
        # a fetched ring holds its valid rows, an unstacked one all
        close(data, plain.data.numpy()[:len(data)], f"seed {i} ring")
    # the generator has made the standalone run's draws, no more
    assert np.array_equal(gen_state, gen1.get_state().numpy())


def run_lockstep(cfg, base, episodes=EPISODES, new_episode=None):
    init_fn, run_fn = parallel.make_seed_parallel_runner(
        cfg, S, "cpu", squash=RUN_SQUASH)
    ts, rl, node, gens, total = init_fn(base)
    results = []
    for ep in range(episodes):
        if new_episode is not None:
            new_episode(rl, node)
        ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, ep, total)
        assert m.reward.shape == (S,) and len(m.steps) == S
        results.append(parallel.episode_to_host_seeds(m))
    return results, ts, rl, node, gens, total


def test_runner_matches_standalone_runs():
    """S = 3 unicycle seeds for 3 episodes (the policy acts from the
    second, the supervisor from the second, updates from step 9, a fit
    every 5th update): each seed's episodes, state, rings and generator
    against its standalone run."""
    cfg, base = runner_cfg(), 11
    results, ts, rl, node, gens, total = run_lockstep(cfg, base)
    # updates from the first step whose ring holds more than a batch
    assert ts.updates == [2 * (EPISODES * STEPS - cfg.sac.batch_size - 1)
                          ] * S
    for i in range(S):
        check_seed_against_standalone(cfg, i, base, results, ts, rl, node,
                                      gens, total)


def test_runner_meets_the_jax_runner_assertions():
    """``tests/test_parallel.py``'s checks of JAX's runner: rewards shaped
    (S,), different seeds give different rewards, total == steps."""
    cfg = runner_cfg()
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, S, "cpu")
    ts, rl, node, gens, total = init_fn(0)
    ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, 0, total)
    assert m.reward.shape == (S,)
    assert len(np.unique(np.round(m.reward.numpy(), 4))) > 1
    assert total == m.steps


def _near_goal_reset(device, gen=None,
                     max_episode_steps=t_unicycle.SPEC.max_episode_steps):
    """The unicycle's reset, but a draw from ``gen`` puts half the episodes
    at the goal, where the first step ends them."""
    st, obs = t_unicycle.reset(device, max_episode_steps=max_episode_steps)
    if float(torch.rand((), generator=gen)) < 0.5:
        x = torch.tensor([2.47, 2.5, 0.0], device=device)
        st = st._replace(x=x, last_goal_dist=torch.linalg.vector_norm(
            t_unicycle.constants(torch.device(device))["goal"] - x[:2]))
        obs = t_unicycle.get_obs(x)
    return st, obs


NEAR_GOAL_ENV = types.SimpleNamespace(
    SPEC=t_unicycle.SPEC._replace(name="unicycle_near_goal"),
    reset=_near_goal_reset, step=t_unicycle.step,
    obs_to_state=t_unicycle.obs_to_state,
    state_to_obs=t_unicycle.state_to_obs)


class WatchedAgent:
    """The runner's agent, with ``seen(ts, gens, acting)`` called as each
    update and each action begins; the calls pass through."""

    def __init__(self, agent, seen):
        self.agent, self.seen = agent, seen

    def update(self, ts, rl, node, gens, *args, **kwargs):
        self.seen(ts, gens, False)
        return self.agent.update(ts, rl, node, gens, *args, **kwargs)

    def select_action(self, ts, obs, gens, *args, **kwargs):
        self.seen(ts, gens, True)
        return self.agent.select_action(ts, obs, gens, *args, **kwargs)


def _bytes(x):
    if isinstance(x, (list, tuple)):
        return b"".join(_bytes(v) for v in x)
    return np.asarray(x).tobytes()


def test_finished_seed_stays_frozen_while_others_run(monkeypatch):
    """A registered env whose reset puts some seeds at the goal: their
    episodes end at the first step while the others run on. From its
    last step on, a finished seed's state, rings and generator stay bit
    for bit as they were (its digest is taken as every later update and
    action begins, through a watched agent), and every seed still
    matches its standalone run."""
    register_env("unicycle_near_goal", NEAR_GOAL_ENV)
    cfg, base = runner_cfg("unicycle_near_goal"), 3
    rings, records = [], []  # records: per episode, (steps done, digests)

    def digest(ts, gens, i):
        rl, node = rings
        one = parallel.state_arrays(unstack_state(cfg, ts, i))
        return hashlib.sha256(b"".join(
            [_bytes(one[k]) for k in sorted(one)]
            + [_bytes(r.data[i].numpy()) + _bytes(
                [r.position[i], r.size[i], r.total[i]]) for r in (rl, node)]
            + [_bytes(gens[i].get_state().numpy())])).digest()

    def seen(ts, gens, acting):
        episode = records[-1]
        done = sum(a for _, _, a in episode)  # the actions so far
        episode.append((done, [digest(ts, gens, i) for i in range(S)],
                        acting))

    real = parallel.lockstep.make_agent
    monkeypatch.setattr(parallel.lockstep, "make_agent",
                        lambda cfg, device, **kw: WatchedAgent(
                            real(cfg, device, **kw), seen))

    def new_episode(rl, node):
        rings[:] = [rl, node]
        records.append([])

    results, ts, rl, node, gens, total = run_lockstep(
        cfg, base, new_episode=new_episode)
    steps = [[r["steps"] for r in ep] for ep in results]
    # seeds end at different steps, and a trained seed sat out steps in
    # which the others updated
    assert any(len(set(s)) > 1 for s in steps[1:]), steps
    checks = 0
    for episode, ends in zip(records, steps):
        for i, end in enumerate(ends):
            # from the first update or action after seed i's last step on
            after = [d[i] for done, d, _ in episode if done >= end]
            assert all(d == after[0] for d in after), (i, end)
            checks += max(len(after) - 1, 0)
    assert checks >= STEPS, (steps, checks)
    for i in range(S):
        check_seed_against_standalone(cfg, i, base, results, ts, rl, node,
                                      gens, total)


class CountDraws(TorchDispatchMode):
    """Counts the random draws (each one kernel launch on the card)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).split(".")[1] in ("randn", "randint", "rand",
                                       "random_", "normal_", "uniform_"):
            self.n += 1
        return func(*args, **(kwargs or {}))


def test_draws_per_update_and_action_are_counted():
    """The seed-batched update draws each updating seed's share at every
    draw site, as one seed's update draws it: the RL indices and the TD,
    policy and backup samples (4), and the NODE sample for a seed that
    fits (1); an acting seed draws 2 for its action (policy and backup),
    a warm-up seed 1, a finished seed none."""
    cfg = runner_cfg()
    gen = torch.Generator().manual_seed(2)
    states = [t_create(cfg, gen, "cpu") for _ in range(S)]
    for ts, n in zip(states, (0, 3, 7)):
        ts.updates = n  # seed 0 fits (every 5th), seed 1 does not
    ts = stack_states(cfg, states)
    rl = parallel.lockstep.replay_lib.stack_replays(
        [create_replays(cfg, "cpu")[0] for _ in range(S)])
    node = parallel.lockstep.replay_lib.stack_replays(
        [create_replays(cfg, "cpu")[1] for _ in range(S)])
    rl.size = node.size = [20] * S
    gens = [torch.Generator().manual_seed(i) for i in range(S)]
    agent = t_make_agent(cfg, "cpu")
    with CountDraws() as stacked:
        agent.update(ts, rl, node, gens, 0, seeds=[True, True, False])
    assert stacked.n == 4 * 2 + 1
    one, one_rl = states[0], create_replays(cfg, "cpu")
    one_rl[0].size = one_rl[1].size = 20
    with CountDraws() as single:
        agent.update(one, one_rl[0], one_rl[1], gen, 0)
    assert single.n == 4 + 1
    obs = torch.zeros(S, cfg.obs_dim)
    with CountDraws() as acting:
        agent.select_action(ts, obs, gens, [False, True, False],
                            torch.zeros(S, dtype=torch.bool),
                            seeds=[True, True, False])
    assert acting.n == 2 + 1


# ---------------------------------------------------------------------------
# (f) refusals
# ---------------------------------------------------------------------------

def _node(cfg, **kw):
    return dataclasses.replace(cfg, node=dataclasses.replace(cfg.node, **kw))


def _builder(cfg, kind, module):
    register_builder(kind, module)
    return dataclasses.replace(cfg, constraint=dataclasses.replace(
        cfg.constraint, kind=kind))


# unicycle's builder registered again, without and with SEED_AXIS: one
# written for (B, .) rows only may index the seed axis as its rows
FIRST_AXIS_BUILDER = types.SimpleNamespace(
    terms=t_unicycle_builder.terms, NUM_PRIMARY=t_unicycle_builder.NUM_PRIMARY,
    NUM_BACKUP=t_unicycle_builder.NUM_BACKUP)
SEED_AXIS_BUILDER = types.SimpleNamespace(**vars(FIRST_AXIS_BUILDER),
                                          SEED_AXIS=True)

# the configs the runner refused before it took the adaptive solver and
# builders without SEED_AXIS (tests/test_torch_port_lockstep_dopri5.py
# trains them against their standalone runs)
FORMERLY_REFUSED = {
    "dopri5": lambda: _node(runner_cfg(), solver="dopri5"),
    "dopri5_while": lambda: _node(runner_cfg(), solver="dopri5",
                                  adaptive_impl="while"),
    "builder_without_seed_axis": lambda: _builder(
        runner_cfg(), "unicycle_first_axis", FIRST_AXIS_BUILDER),
}


@pytest.mark.parametrize("name", sorted(FORMERLY_REFUSED))
def test_formerly_refused_configs_are_taken(name):
    init_fn, _ = parallel.make_seed_parallel_runner(FORMERLY_REFUSED[name](),
                                                    2, "cpu")
    ts, rl, node, gens, total = init_fn(0)
    assert ts.seeds == 2 and len(gens) == 2 and total == [0, 0]


def test_registered_builder_with_seed_axis_is_taken():
    """A registered builder that declares SEED_AXIS trains in the runner:
    unicycle's builder under another kind, one episode of S seeds, bit
    for bit as the built-in kind's."""
    cfg = runner_cfg()
    want, want_ts, *_ = run_lockstep(cfg, 5, episodes=1)
    got, got_ts, *_ = run_lockstep(_builder(cfg, "unicycle_seed_axis",
                                            SEED_AXIS_BUILDER), 5,
                                   episodes=1)
    assert got_ts.updates == want_ts.updates and min(got_ts.updates) > 0
    np.testing.assert_equal(got, want)
    for i in range(S):
        np.testing.assert_equal(
            parallel.state_arrays(unstack_state(cfg, got_ts, i)),
            parallel.state_arrays(unstack_state(cfg, want_ts, i)))


def test_several_devices_are_taken():
    """A list of two devices makes the sharded runner: a seed a shard, each
    in its own worker, seed i made from base seed + i
    (tests/test_torch_port_lockstep_cards.py trains it against the
    standalone runs)."""
    cfg = runner_cfg()
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, 2,
                                                         ["cpu", "cpu"])
    assert isinstance(run_fn, parallel.ShardedSeedRunner)
    assert run_fn.shards == [[0], [1]]
    try:
        assert init_fn(4) == [0, 0]
        for i in range(2):
            arrays, rl, node, total, gen_state = run_fn.fetch(i)
            want = t_create(cfg, torch.Generator().manual_seed(4 + i),
                            "cpu")
            np.testing.assert_equal(arrays, parallel.state_arrays(want))
            assert rl[1:] == node[1:] == (0, 0, 0) and total == 0
    finally:
        run_fn.close()


def test_stacked_twin_q_state_is_taken():
    """Seeds in the stacked twin-Q layout stack to (S, 2, in, out) and
    (S, 2, out) critic leaves with a SeedAdam over them
    (tests/test_torch_port_lockstep_cards.py trains and updates them)."""
    cfg = runner_cfg()
    gen = torch.Generator().manual_seed(0)
    states = [stack_twin_q_state(cfg, t_create(cfg, gen, "cpu"))
              for _ in range(2)]
    ts = stack_states(cfg, states)
    assert ts.seeds == 2 and "q1" not in ts.critic
    for stacked, plain in zip(tree_leaves(ts.critic),
                              tree_leaves(states[0].critic)):
        assert stacked.shape == (2,) + plain.shape and plain.shape[0] == 2
    assert isinstance(ts.opt["critic"], SeedAdam)


def test_uneven_seed_count_over_devices_is_refused():
    """As JAX's device_put refuses a seed axis that does not split evenly
    over the mesh."""
    with pytest.raises(ValueError, match="do not split evenly"):
        parallel.make_seed_parallel_runner(runner_cfg(), 3, ["cpu", "cpu"])


def test_mixed_twin_q_layouts_are_refused():
    cfg = runner_cfg()
    gen = torch.Generator().manual_seed(0)
    states = [t_create(cfg, gen, "cpu"),
              stack_twin_q_state(cfg, t_create(cfg, gen, "cpu"))]
    with pytest.raises(ValueError, match="different twin-Q layouts"):
        stack_states(cfg, states)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_seed_parallel_runner(runner_cfg(), 2)


# ---------------------------------------------------------------------------
# (g) SeedAdam against torch.optim.Adam
# ---------------------------------------------------------------------------

MASKS = ([1, 1, 1], [1, 0, 1], [0, 0, 1], [1, 1, 0], [0, 1, 1], [1, 1, 1])


def test_seed_adam_matches_torch_adam_seed_by_seed():
    gen = torch.Generator().manual_seed(0)
    shapes = [(4, 5), (5,), (1,)]
    stacked = [torch.randn((S,) + s, generator=gen).requires_grad_(True)
               for s in shapes]
    adam = SeedAdam(stacked, lr=3e-4)
    per_seed = [[p[i].detach().clone().requires_grad_(True)
                 for p in stacked] for i in range(S)]
    refs = [torch.optim.Adam(ps, lr=3e-4) for ps in per_seed]
    for mask in MASKS:
        grads = [torch.randn((S,) + s, generator=gen) for s in shapes]
        before = [p.detach().clone() for p in stacked]
        moments = [t.clone() for t in (adam.exp_avg, adam.exp_avg_sq)]
        adam.step(grads, torch.tensor(mask, dtype=torch.bool))
        for i in range(S):
            if mask[i]:
                for p, g in zip(per_seed[i], grads):
                    p.grad = g[i]
                refs[i].step()
            else:  # a masked-off seed, bit for bit
                for p, b in zip(stacked, before):
                    assert torch.equal(p[i], b[i])
                assert torch.equal(adam.exp_avg[i], moments[0][i])
                assert torch.equal(adam.exp_avg_sq[i], moments[1][i])
    mus, nus = adam.moments()
    for i in range(S):
        state = refs[i].state
        assert int(adam.step_count[i]) == int(state[per_seed[i][0]]["step"])
        for j, p in enumerate(per_seed[i]):
            torch.testing.assert_close(stacked[j][i].detach(), p.detach(),
                                       rtol=1e-6, atol=1e-9)
            torch.testing.assert_close(mus[j][i], state[p]["exp_avg"],
                                       rtol=1e-6, atol=1e-9)
            torch.testing.assert_close(nus[j][i], state[p]["exp_avg_sq"],
                                       rtol=1e-6, atol=1e-9)
    # unmasked: every seed steps
    adam.step([torch.ones((S,) + s) for s in shapes])
    assert adam.step_count.tolist() == [5.0, 5.0, 6.0]


def test_stack_and_unstack_states_round_trip():
    cfg = runner_cfg()
    gen = torch.Generator().manual_seed(1)
    states = [t_create(cfg, gen, "cpu") for _ in range(S)]
    ts = stack_states(cfg, states)
    assert ts.seeds == S and ts.updates == [0] * S
    for i in range(S):
        a = parallel.state_arrays(unstack_state(cfg, ts, i))
        b = parallel.state_arrays(states[i])
        for key in b:
            vals_a = a[key] if key != "updates" else [a[key]]
            vals_b = b[key] if key != "updates" else [b[key]]
            for x, y in zip(vals_a, vals_b):
                assert np.array_equal(np.asarray(x), np.asarray(y)), key


def test_lockstep_modules_import_no_jax():
    """A fresh process that imports the lockstep runner, the module its
    sharded workers start in (``parallel.seeds``, whose ``_serve`` a
    spawned worker runs) and every module it puts on the seed axis (the
    stacked twin-Q layout, the seed Adam, the fields, the adaptive
    solver and its adjoint, K1's wrapper, the update and the state, the
    replay, the supervisor, ``train.driver``'s helpers, the constraint builders
    and the envs) holds no JAX and nothing of the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    modules = ("parallel", "parallel.lockstep", "parallel.seeds",
               "experimental", "nn.critics", "nn.adam", "nn.node", "nn.mlp",
               "ode.solvers", "ode.adjoint",
               "ops.node_kernel", "agent.update", "agent.state", "interop",
               "replay.buffer", "train.supervisor", "train.driver",
               "constraints.cars", "constraints.pvtol",
               "constraints.learned_barrier", "constraints.common",
               "envs.cars", "envs.pvtol", "envs.quadrotor")
    repo = Path(__file__).resolve().parent.parent
    code = ("import sys\n"
            + "".join(f"import nlbac_tpu_torch.{m}\n" for m in modules)
            + "bad = sorted(m for m in sys.modules if m in ('jax', 'optax',"
            " 'nlbac_tpu') or m.startswith(('jax.', 'nlbac_tpu.')))\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(repo)
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
