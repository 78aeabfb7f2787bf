"""The lockstep seed runner over several devices
(``parallel.make_seed_parallel_runner(cfg, n, [d0, d1, ...])``, a
``ShardedSeedRunner``: one worker process a shard) and with the critic in
the stacked twin-Q layout, on the CPU, against the JAX package and the
port's own one-seed and one-device paths:

(a) placement: JAX's runner on a (2, 1) mesh of the forced CPU devices
    puts its seed blocks where the port's ``["cpu", "cpu"]`` runner puts
    its shards; both refuse 3 seeds on 2 devices;
(b) ``tests/test_parallel.py``'s assertions on JAX's runner, on the
    sharded runner;
(c) each seed of a 2-shard run (S = 4, 3 episodes) against its standalone
    run, and each shard against the one-device lockstep of its seed block;
(d) failures: shards on a card this host lacks fail at ``init_fn``, a
    shard that fails in an episode fails ``run_fn``, each with the
    worker's traceback, and the runner ends every worker; an env
    registered at run time reaches the workers through ``setup``;
(e) the stacked twin-Q layout with a seed axis: its apply against
    ``jax.vmap`` of JAX's, one seed-batched update against ``jax.vmap``
    of JAX's ``update_from_batch`` of ``stack_twin_q_state``'d states, the
    stack/unstack round trip, and one runner episode (one device and two
    shards) against each seed's standalone stacked-layout run.

Tolerances. (c): ``check_seed_against_standalone``'s (rtol 1e-4 / atol
1e-5: a batched product need not round as the one-seed product does);
a shard against the one-device lockstep of its seeds bit for bit (the
same code on the same shapes on the CPU: a worker process computes what
the parent would). (e): the apply rtol 1e-5 / atol 1e-6; the update
``test_seed_batched_update_matches_jax_vmap``'s (metrics rtol 1e-5 /
atol 1e-6, the state rtol 1e-4 / atol 1e-6), TF32 off (the CPU has none);
the round trip bit for bit; the episode ``check_seed_against_standalone``'s.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu import experimental as jexp
from nlbac_tpu import nn as jnn
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu.parallel import make_mesh
from nlbac_tpu.parallel import make_seed_parallel_runner as j_runner
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import nn as tnn
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state as t_create
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.state import stack_states, unstack_state
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.experimental import stack_twin_q_state
from nlbac_tpu_torch.interop import (
    from_reference,
    from_reference_stacked,
    to_reference_stacked,
)
from nlbac_tpu_torch.tree import tree_leaves
from test_parallel import tiny_cfg
from test_torch_port_gates import out_of_band_key
from test_torch_port_lockstep import (
    BATCH,
    COUNTERS,
    NODE_BATCH,
    RUN_SQUASH,
    as_numpy,
    check_fetched_against_standalone,
    check_seed_against_standalone,
    gated_cfg,
    one_thread,  # noqa: F401 (the autouse fixture)
    runner_cfg,
    stack_trees,
    take,
)
from test_torch_port_presets import leaves_with_paths
from test_torch_port_update import make_batch
from torch_gang_workers import drop_a_seed, register_unicycle_alias

SEEDS, DEVICES = 4, ["cpu", "cpu"]
EPISODES, BASE = 3, 11
HOST_KEYS = ("reward", "num_violations", "safety_cost", "reached",
             "goal_met", "backup_steps", "short_integrations",
             "viol_breakdown", "cost_breakdown", "train", "steps",
             "updates_done")


def sharded_episodes(cfg, base, episodes, prepare=None):
    """A 2-shard run of SEEDS seeds: each episode's metrics, the totals,
    each seed's fetched state and the runner's shards and start-up
    seconds (its workers ended)."""
    init_fn, run_fn = parallel.make_seed_parallel_runner(
        cfg, SEEDS, DEVICES, prepare=prepare, squash=RUN_SQUASH)
    try:
        total = init_fn(base)
        results = []
        for ep in range(episodes):
            metrics, total = run_fn(ep)
            results.append(metrics)
        fetched = [run_fn.fetch(i) for i in range(SEEDS)]
    finally:
        run_fn.close()
    return dict(results=results, total=total, fetched=fetched,
                shards=run_fn.shards, start_seconds=run_fn.start_seconds)


@pytest.fixture(scope="module")
def sharded():
    """One 2-shard run (S = 4, 3 episodes) the tests (b) and (c) share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return sharded_episodes(runner_cfg(), BASE, EPISODES)
    finally:
        torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# (a) placement
# ---------------------------------------------------------------------------

def test_shards_hold_jax_seed_blocks():
    """JAX's ``NamedSharding(mesh, P("seed", ...))`` puts seeds 2d, 2d + 1
    on the mesh's device d (every leaf alike); the port's shard d on
    ``devices[d]`` holds the same seeds."""
    mesh = make_mesh((2, 1))
    init_fn, _ = j_runner(tiny_cfg(), mesh, n_seeds=SEEDS)
    ts, rl, node, keys, total = init_fn(0)
    devices = list(mesh.devices.flat)
    blocks = set()
    for leaf in jax.tree.leaves((ts, rl, node, keys, total)):
        blocks.add(tuple(sorted(
            (devices.index(sh.device),
             tuple(range(SEEDS))[sh.index[0]])
            for sh in leaf.addressable_shards)))
    assert len(blocks) == 1
    jax_blocks = [list(seeds) for _, seeds in sorted(blocks.pop())]
    assert jax_blocks == [[0, 1], [2, 3]]

    _, run_fn = parallel.make_seed_parallel_runner(runner_cfg(), SEEDS,
                                                   DEVICES)
    assert run_fn.shards == jax_blocks
    assert [str(d) for d in run_fn.devices] == DEVICES


def test_uneven_seeds_are_refused_by_both():
    with pytest.raises(ValueError):
        j_runner(tiny_cfg(), make_mesh((2, 1)), n_seeds=3)[0](0)
    with pytest.raises(ValueError, match="do not split evenly"):
        parallel.make_seed_parallel_runner(runner_cfg(), 3, DEVICES)


# ---------------------------------------------------------------------------
# (b), (c) the sharded run
# ---------------------------------------------------------------------------

def test_sharded_runner_meets_the_jax_runner_assertions(sharded):
    """``tests/test_parallel.py``'s checks of JAX's runner: rewards shaped
    (S,), different seeds give different rewards, total == steps; and
    each seed's K1 launches are its shard's (none on the CPU)."""
    first = sharded["results"][0]
    reward = np.array([m["reward"] for m in first])
    assert reward.shape == (SEEDS,)
    assert len(np.unique(np.round(reward, 4))) > 1
    steps = np.sum([[m["steps"] for m in ep] for ep in sharded["results"]],
                   axis=0)
    assert sharded["total"] == steps.tolist()
    assert all(m["kernel_launches"] == 0 for ep in sharded["results"]
               for m in ep)
    assert len(sharded["start_seconds"]) == len(DEVICES)


@pytest.mark.parametrize("i", range(SEEDS))
def test_sharded_seed_matches_standalone_run(sharded, i):
    """Seed i of the 2-shard run: its episodes, whole state, rings and
    generator against its standalone run (seed BASE + i)."""
    cfg = runner_cfg()
    episodes = [ep[i] for ep in sharded["results"]]
    assert episodes[-1]["updates"] > 0
    check_fetched_against_standalone(cfg, i, BASE, episodes,
                                     sharded["fetched"][i])


@pytest.mark.parametrize("d", range(len(DEVICES)))
def test_shard_equals_one_device_lockstep(sharded, d):
    """Shard d against the one-device lockstep of its seed block (base
    seed BASE + its first seed), bit for bit: the same code on the same
    shapes, in a worker process."""
    cfg = runner_cfg()
    seeds = sharded["shards"][d]
    init_fn, run_fn = parallel.make_seed_parallel_runner(
        cfg, len(seeds), "cpu", squash=RUN_SQUASH)
    ts, rl, node, gens, total = init_fn(BASE + seeds[0])
    for ep in range(EPISODES):
        ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, ep, total)
        host = parallel.episode_to_host_seeds(m)
        for j, i in enumerate(seeds):
            got = sharded["results"][ep][i]
            np.testing.assert_equal({k: got[k] for k in HOST_KEYS}, host[j])
            assert got["updates"] == ts.updates[j]
    for j, i in enumerate(seeds):
        np.testing.assert_equal(sharded["fetched"][i],
                                parallel.lockstep.seed_on_host(
                                    cfg, (ts, rl, node, gens, total), j))


# ---------------------------------------------------------------------------
# (d) failures
# ---------------------------------------------------------------------------

def test_unavailable_card_fails_at_init():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    init_fn, run_fn = parallel.make_seed_parallel_runner(
        runner_cfg(), 2, ["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="(?s)seed worker failed.*"
                       "no CUDA device is available"):
        init_fn(0)
    with pytest.raises(RuntimeError, match="no workers"):
        run_fn(0)


def test_failing_shard_fails_run_fn():
    """A shard whose state is one seed short (a ``prepare`` hook) raises
    in its worker at the first episode: ``run_fn`` raises the worker's
    traceback and ends both workers."""
    init_fn, run_fn = parallel.make_seed_parallel_runner(
        runner_cfg(), SEEDS, DEVICES, prepare=drop_a_seed)
    try:
        init_fn(0)
        procs = [p.proc for p in run_fn._procs]
        with pytest.raises(RuntimeError, match="(?s)seed worker failed.*"
                           "run_fn takes the 2 seeds of init_fn"):
            run_fn(0)
        assert not any(p.is_alive() for p in procs)
        with pytest.raises(RuntimeError, match="no workers"):
            run_fn.fetch(0)
    finally:
        run_fn.close()


def test_setup_registers_an_env_in_each_worker(sharded):
    """An env registered at run time is in no worker's registry (a
    spawned process holds what it registered): the shards fail at init
    with the worker's message. A ``setup`` hook registers it in each
    worker: unicycle under another name trains seeds BASE, BASE + 1 as
    the shared run's seeds 0 and 1 did, bit for bit."""
    cfg = runner_cfg()
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, name="unicycle_alias"))
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, 2, DEVICES)
    with pytest.raises(RuntimeError, match="unknown env 'unicycle_alias'"):
        init_fn(BASE)
    init_fn, run_fn = parallel.make_seed_parallel_runner(
        cfg, 2, DEVICES, setup=register_unicycle_alias, squash=RUN_SQUASH)
    try:
        init_fn(BASE)
        metrics, total = run_fn(0)
    finally:
        run_fn.close()
    np.testing.assert_equal(metrics, sharded["results"][0][:2])


# ---------------------------------------------------------------------------
# (e) the stacked twin-Q layout with a seed axis
# ---------------------------------------------------------------------------

S3 = 3


def test_seed_stacked_twin_q_apply_matches_jax_vmap():
    """``twin_q_apply`` on (S, 2, in, out) leaves and (S, B, .) inputs
    against ``jax.vmap`` of JAX's stacked apply and each seed's one-seed
    stacked apply; ``twin_q_stack``/``twin_q_unstack`` keep the seed axis
    in front, as ``jax.vmap`` of JAX's do."""
    rng = np.random.default_rng(3)
    plain = stack_trees([jnn.twin_q_init(jax.random.PRNGKey(i), 5, 2, 8)
                         for i in range(S3)])
    stacked_j = jax.vmap(jnn.twin_q_stack)(plain)
    obs = rng.normal(size=(S3, 7, 5)).astype(np.float32)
    act = rng.normal(size=(S3, 7, 2)).astype(np.float32)
    q_j = jax.vmap(jnn.twin_q_apply)(stacked_j, obs, act)

    to_t = lambda tree: jax.tree.map(lambda a: torch.tensor(np.asarray(a)),
                                     tree)
    stacked = tnn.twin_q_stack(to_t(plain))
    for a, b in zip(tree_leaves(stacked), jax.tree.leaves(stacked_j)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tree_leaves(tnn.twin_q_unstack(stacked)),
                    jax.tree.leaves(plain)):
        assert np.array_equal(a.numpy(), np.asarray(b))
    q_t = tnn.twin_q_apply(stacked, torch.tensor(obs), torch.tensor(act))
    for a, b in zip(q_t, q_j):
        assert a.shape == (S3, 7, 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    for i in range(S3):
        one = jax.tree.map(lambda x: torch.tensor(np.asarray(x)[i]),
                           stacked_j)
        q_1 = tnn.twin_q_apply(one, torch.tensor(obs[i]),
                               torch.tensor(act[i]))
        for a, b in zip(q_t, q_1):
            torch.testing.assert_close(a[i], b, rtol=1e-5, atol=1e-6)


def test_stacked_twin_q_seed_batched_update_matches_jax_vmap():
    """One seed-batched update of S = 3 seeds in the stacked twin-Q layout
    at different counters (the gates of
    ``test_seed_batched_update_matches_jax_vmap``) against ``jax.vmap(
    update_from_batch)`` of JAX's ``stack_twin_q_state``'d states, the
    states carried across by ``from_reference_stacked`` and back by
    ``to_reference_stacked``, with the same injected draws."""
    cfg_j, cfg_t = gated_cfg(jconfig), gated_cfg(tconfig)
    update = jax.jit(make_agent(cfg_j).update_from_batch)
    vupdate = jax.jit(jax.vmap(make_agent(cfg_j).update_from_batch,
                               in_axes=(0, 0, 0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(1), S3)
    ts = jax.vmap(lambda k: jexp.stack_twin_q_state(
        cfg_j, create_train_state(cfg_j, k)))(keys)
    rng = np.random.default_rng(4)
    seeds = []
    for i, n in enumerate(COUNTERS):  # seed i after n updates of its own
        ts_i = take(ts, i)
        for k in range(n):
            ts_i, _ = update(ts_i, make_batch(rng, BATCH),
                             make_batch(rng, NODE_BATCH),
                             jax.random.PRNGKey(70 + 10 * i + k),
                             jnp.int32(0))
        seeds.append(ts_i)
    ts = stack_trees(seeds)
    assert "q1" not in ts.critic and ts.critic["w"][0].shape[:2] == (S3, 2)

    batches = [make_batch(rng, BATCH) for _ in range(S3)]
    node_batches = [make_batch(rng, NODE_BATCH) for _ in range(S3)]
    ref = as_numpy(ts)
    draws, step_keys = [], []
    for i in range(S3):  # each seed's key keeps its samples out of the band
        port_i = from_reference(take(ref, i), cfg_t, "cpu")
        tb = {k: torch.tensor(v) for k, v in batches[i].items()}
        key, noise = out_of_band_key(port_i, tb, "unicycle", i, 2)
        step_keys.append(key)
        draws.append(noise)
    ts_j, m_j = vupdate(ts, stack_trees(batches), stack_trees(node_batches),
                        jnp.stack(step_keys), jnp.int32(1))

    port = from_reference_stacked(ref, cfg_t, S3, "cpu")
    assert "q1" not in port.critic and port.updates == list(COUNTERS)
    assert port.critic["w"][0].shape[:2] == (S3, 2)
    agent = t_make_agent(cfg_t, "cpu")
    tb = {k: torch.stack([torch.tensor(b[k]) for b in batches])
          for k in batches[0]}
    tnb = {k: torch.stack([torch.tensor(b[k]) for b in node_batches])
           for k in node_batches[0]}
    noise = {k: torch.stack([d[k] for d in draws]) for k in draws[0]}
    target_before = [t.clone() for t in tree_leaves(port.critic_target)]
    port, m_t = agent.update_from_batch(port, tb, tnb, None, 1, noise=noise)

    # seed 1's gates are off: its critic target (rank 4 and 3 leaves)
    # keeps its values bit for bit while seeds 0 and 2 average
    moved = [[not torch.equal(t[i], b[i]) for t, b in
              zip(tree_leaves(port.critic_target), target_before)]
             for i in range(S3)]
    assert [all(m) for m in moved] == [True, False, True]
    assert not any(moved[1])
    for k in METRIC_NAMES:
        assert m_t[k].shape == (S3,), k
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    expect = as_numpy(ts_j)
    got = to_reference_stacked(port, expect, cfg_t)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb and a.shape == b.shape, pa
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=pa)


def test_stacked_twin_q_states_round_trip():
    """``stack_states`` of seeds in the stacked twin-Q layout, some trained
    (Adam moments and step counts of their own), and ``unstack_state``
    back: each seed's state bit for bit, its critic's Adam over the
    stacked leaves; ``stack_twin_q_state`` of a seed-stacked state equals
    stacking each seed's ``stack_twin_q_state``."""
    cfg = runner_cfg()
    gen = torch.Generator().manual_seed(6)
    plain = [t_create(cfg, gen, "cpu") for _ in range(S3)]
    states = [stack_twin_q_state(cfg, ts) for ts in plain]
    ts = stack_states(cfg, states)
    agent = t_make_agent(cfg, "cpu")
    rl = parallel.lockstep.replay_lib.stack_replays(
        [parallel.lockstep.create_replays(cfg, "cpu")[0]
         for _ in range(S3)])
    node = parallel.lockstep.replay_lib.stack_replays(
        [parallel.lockstep.create_replays(cfg, "cpu")[1]
         for _ in range(S3)])
    rl.size = node.size = [20] * S3
    gens = [torch.Generator().manual_seed(20 + i) for i in range(S3)]
    for on in ([True, True, False], [True, False, False]):
        ts, _ = agent.update(ts, rl, node, gens, 0, seeds=on)
    assert ts.updates == [2, 1, 0]
    again = stack_states(cfg, [unstack_state(cfg, ts, i)
                               for i in range(S3)])
    for i in range(S3):
        one = unstack_state(cfg, ts, i)
        assert "q1" not in one.critic
        assert isinstance(one.opt["critic"], torch.optim.Adam)
        assert one.opt["critic"].param_groups[0]["params"] == \
            tree_leaves(one.critic)
        np.testing.assert_equal(
            parallel.state_arrays(unstack_state(cfg, again, i)),
            parallel.state_arrays(one))
    np.testing.assert_equal(
        parallel.state_arrays(unstack_state(cfg, ts, 2)),
        parallel.state_arrays(states[2]))

    batched = stack_twin_q_state(cfg, stack_states(cfg, plain))
    one_by_one = stack_states(cfg, [stack_twin_q_state(cfg, p)
                                    for p in plain])
    for i in range(S3):
        np.testing.assert_equal(
            parallel.state_arrays(unstack_state(cfg, batched, i)),
            parallel.state_arrays(unstack_state(cfg, one_by_one, i)))


@pytest.mark.parametrize("devices", ["cpu", "cpu,cpu"])
def test_stacked_twin_q_runner_matches_standalone_runs(devices):
    """One episode of SEEDS seeds whose critics take the stacked layout
    (``prepare=stack_twin_q_state``), on one device and in two shards:
    each seed against its standalone stacked-layout run."""
    cfg = dataclasses.replace(runner_cfg(), sac=dataclasses.replace(
        runner_cfg().sac, start_steps=12))
    base = 7
    if devices == "cpu":
        init_fn, run_fn = parallel.make_seed_parallel_runner(
            cfg, SEEDS, "cpu", prepare=stack_twin_q_state,
            squash=RUN_SQUASH)
        ts, rl, node, gens, total = init_fn(base)
        assert "q1" not in ts.critic
        ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, 0, total)
        assert min(ts.updates) > 0
        results = [parallel.episode_to_host_seeds(m)]
        for i in range(SEEDS):
            check_seed_against_standalone(cfg, i, base, results, ts, rl,
                                          node, gens, total,
                                          prepare=stack_twin_q_state)
        return
    run = sharded_episodes(cfg, base, 1, prepare=stack_twin_q_state)
    for i in range(SEEDS):
        assert run["results"][0][i]["updates"] > 0
        # the stacked layout's critic leaves: (2, in, out) and (2, out)
        assert run["fetched"][i][0]["critic"][0].shape[0] == 2
        check_fetched_against_standalone(
            cfg, i, base, [run["results"][0][i]], run["fetched"][i],
            prepare=stack_twin_q_state)
