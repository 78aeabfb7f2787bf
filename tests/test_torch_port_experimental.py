"""The port's experimental levers (``nlbac_tpu_torch.experimental``) and the
stacked twin-Q layout, against the JAX package's on the CPU, with the same
weights, batches and injected draws as ``test_torch_port_gates.py``:

- the stacked twin-Q apply against the plain layout and JAX's stacked
  apply (rtol 1e-5 / atol 1e-6, float32 sums in another order), and the
  stack/unstack round trip bit for bit (JAX ``tests/test_nn.py:199-224``);
- three lockstep updates of a stacked state (``from_reference`` of JAX's
  ``stack_twin_q_state``) against JAX's stacked updates, and an episode
  of a stacked state against the plain layout's (``tests/test_nn.py``'s
  tolerances: reward rtol 1e-4 / atol 1e-5);
- the decoupled agent's three facts (JAX ``tests/test_agent.py:510-549``)
  and its update against JAX's decoupled update;
- the fused RL gather: given the same index draws, its batches and its
  episodes equal the default path's bit for bit;
- the stacked state's weight files, full checkpoint and tp layout.

Update tolerances are the single-update ones of ``test_torch_port_gates``
(metrics rtol 1e-5 / atol 1e-6, parameters and Adam moments rtol 1e-4 /
atol 1e-6).
"""

import dataclasses
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu import experimental as jexp
from nlbac_tpu import nn as jnn
from nlbac_tpu.agent import create_train_state as j_create_train_state
from nlbac_tpu.agent import make_agent as j_make_agent
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import experimental as texp
from nlbac_tpu_torch import nn as tnn
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.agent.state import OPT_GROUPS
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.replay import buffer as replay_buffer
from nlbac_tpu_torch.train.checkpoint import (
    checkpoint_arrays,
    load_model_weights,
    restore_checkpoint,
    save_model_weights,
    write_checkpoint,
)
from nlbac_tpu_torch.train.driver import create_replays, make_episode_runner
from nlbac_tpu_torch.tree import tree_leaves, tree_unflatten
from test_torch_port_gates import batches, gated_cfg, out_of_band_key
from test_torch_port_presets import leaves_with_paths

METRIC_RTOL, ATOL = 1e-5, 1e-6
STATE_RTOL = 1e-4


def to_torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def tiny_cfg(updates_per_step=1, steps=30):
    """A unicycle run small enough for a few CPU episodes."""
    cfg = tconfig.get_config("unicycle")
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=steps),
        sac=dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=8,
                                updates_per_step=updates_per_step,
                                start_steps=10),
        node=dataclasses.replace(cfg.node, hidden_dim=8, f_hidden_layers=1,
                                 g_hidden_layers=1, max_batch=16,
                                 update_interval=3),
        replay=tconfig.ReplayConfig(capacity=256, node_capacity=256))


def state_leaves(ts):
    """Every parameter, target and Adam moment of a port state, with the
    critic's in the plain layout, as numpy arrays."""
    out = [t.detach().numpy().copy() for name in (
        "policy", "backup_policy", "lyap", "lyap_target", "barrier",
        "barrier_target", "node", "log_alpha", "backup_log_alpha")
        for t in tree_leaves(getattr(ts, name))]
    for name in ("critic", "critic_target"):
        out += [t.detach().numpy().copy() for t in
                tree_leaves(tnn.twin_q_unstack(getattr(ts, name)))]
    for group, field in OPT_GROUPS.items():
        params = getattr(ts, field)
        state = ts.opt[group].state
        for k in ("exp_avg", "exp_avg_sq"):
            moments = [state[p][k] if p in state else torch.zeros_like(p)
                       for p in tree_leaves(params)]
            tree = tree_unflatten(params, moments)
            if group == "critic":
                tree = tnn.twin_q_unstack(tree)
            out += [m.numpy().copy() for m in tree_leaves(tree)]
    return out


def lockstep(cfg_j, cfg_t, ts_j, port, update_j, agent, n, check):
    """``n`` updates of JAX's ``update_j`` and the port's ``agent`` from
    the same state, batches and draws; ``check(k, m_j, m_t)`` after each.
    Returns both final states (JAX's as numpy)."""
    rng = np.random.default_rng(1)
    for k in range(n):
        batch, node_batch = batches("unicycle", rng)
        tb = {name: torch.tensor(v) for name, v in batch.items()}
        tnb = {name: torch.tensor(v) for name, v in node_batch.items()}
        key, noise = out_of_band_key(port, tb, "unicycle", k,
                                     cfg_j.action_dim)
        ts_j, m_j = update_j(ts_j, batch, node_batch, key, jnp.int32(0))
        port, m_t = agent.update_core(port, tb, lambda: tnb, None, 0,
                                      noise=noise)
        check(k, m_j, m_t)
    return jax.tree.map(np.asarray, ts_j), port


def metrics_close(k, m_j, m_t):
    for name in METRIC_NAMES:
        np.testing.assert_allclose(float(m_t[name]), float(m_j[name]),
                                   rtol=METRIC_RTOL, atol=ATOL,
                                   err_msg=f"update {k} {name}")


def states_close(expect, port):
    got = to_reference(port, expect)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb
        np.testing.assert_allclose(b, a, rtol=STATE_RTOL, atol=ATOL,
                                   err_msg=pa)


def test_stacked_twin_q_matches_plain_and_jax():
    """The stacked layout stores the same numbers as JAX's: its forward
    matches the plain layout's and JAX's stacked forward, and
    stack/unstack round-trip bit for bit."""
    plain_j = jnn.twin_q_init(jax.random.PRNGKey(8), 7, 2, 32)
    stacked_j = jnn.twin_q_stack(plain_j)
    plain = to_torch(plain_j)
    stacked = tnn.twin_q_stack(plain)
    for a, b in zip(jax.tree.leaves(stacked_j), tree_leaves(stacked)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    rng = np.random.default_rng(1)
    obs = rng.normal(size=(64, 7)).astype(np.float32)
    act = rng.normal(size=(64, 2)).astype(np.float32)
    q_j = jnn.twin_q_apply(stacked_j, obs, act)
    q_p = tnn.twin_q_apply(plain, torch.tensor(obs), torch.tensor(act))
    q_s = tnn.twin_q_apply(stacked, torch.tensor(obs), torch.tensor(act))
    for a, b, c in zip(q_j, q_p, q_s):
        np.testing.assert_allclose(c.numpy(), np.asarray(a),
                                   rtol=METRIC_RTOL, atol=ATOL)
        np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=METRIC_RTOL,
                                   atol=ATOL)
    for a, b in zip(tree_leaves(tnn.twin_q_stack(
            tnn.twin_q_unstack(stacked))), tree_leaves(stacked)):
        assert torch.equal(a, b)
    assert tnn.twin_q_unstack(plain) is plain
    assert tnn.twin_q_stack(stacked) is stacked


def test_stacked_state_updates_match_jax():
    """Three lockstep unicycle updates (the NODE fit and the backup
    branch in the first) of a stacked state made by ``from_reference`` of
    JAX's ``stack_twin_q_state``, against JAX's updates of that state;
    and the port's stacked updates against its plain-layout ones."""
    cfg_j, cfg_t = gated_cfg(jconfig, "unicycle"), gated_cfg(tconfig,
                                                             "unicycle")
    ts_j = jexp.stack_twin_q_state(
        cfg_j, j_create_train_state(cfg_j, jax.random.PRNGKey(0)))
    port = from_reference(jax.tree.map(np.asarray, ts_j), cfg_t, "cpu")
    assert "q1" not in port.critic and port.critic["w"][0].shape[0] == 2
    update_j = jax.jit(j_make_agent(cfg_j).update_from_batch)
    expect, port = lockstep(cfg_j, cfg_t, ts_j, port, update_j,
                            make_agent(cfg_t, "cpu"), 3, metrics_close)
    states_close(expect, port)

    plain_j = j_create_train_state(cfg_j, jax.random.PRNGKey(0))
    plain = from_reference(jax.tree.map(np.asarray, plain_j), cfg_t, "cpu")
    _, plain = lockstep(cfg_j, cfg_t, plain_j, plain, update_j,
                        make_agent(cfg_t, "cpu"), 3, lambda *_: None)
    for a, b in zip(state_leaves(port), state_leaves(plain)):
        np.testing.assert_allclose(a, b, rtol=STATE_RTOL, atol=ATOL)


def test_stacked_state_episode_matches_plain():
    """Two episodes (updates from step 11) of a stacked state from
    ``stack_twin_q_state`` against the plain layout from the same seed:
    the layout is a pure layout change (reward rtol 1e-4 / atol 1e-5, as
    JAX's test; the critic within the state tolerance rtol 1e-4 / atol
    1e-6)."""
    cfg = tiny_cfg()
    out = {}
    for stacked in (False, True):
        gen = torch.Generator().manual_seed(3)
        ts = create_train_state(cfg, gen, "cpu")
        if stacked:
            ts = texp.stack_twin_q_state(cfg, ts)
            assert ts.opt["critic"].param_groups[0]["params"] == \
                tree_leaves(ts.critic)
        rl, node = create_replays(cfg, "cpu")
        run = make_episode_runner(cfg, "cpu")
        total, rewards = 0, []
        for ep in range(2):
            ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
            rewards.append(float(m.reward))
        out[stacked] = (rewards, ts)
    assert out[True][1].updates == out[False][1].updates > 0
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-4,
                               atol=1e-5)
    for a, b in zip(tree_leaves(tnn.twin_q_unstack(out[True][1].critic)),
                    tree_leaves(out[False][1].critic)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=STATE_RTOL, atol=ATOL)


def test_decoupled_agent_semantics():
    """The decoupled agent's policy losses read the function
    approximators from before the update. (1) Its TD losses are the
    default agent's; (2) its policy update differs from the default's and
    still trains; (3) with the TD optimizers frozen (critic_lr=0 covers
    the critic, Lyapunov net and barrier) and the NODE fit gated off, the
    two agents' updates are the same, bit for bit here (JAX's test allows
    compiler rounding). Against JAX's decoupled update with the same
    draws: every metric and the whole state after three updates."""
    cfg_j, cfg_t = gated_cfg(jconfig, "unicycle"), gated_cfg(tconfig,
                                                             "unicycle")
    ts_j = j_create_train_state(cfg_j, jax.random.PRNGKey(0))

    def port_state(cfg):
        return from_reference(jax.tree.map(np.asarray, ts_j), cfg, "cpu")

    def one_update(cfg, agent):
        rng = np.random.default_rng(1)
        batch, node_batch = batches("unicycle", rng)
        tb = {n: torch.tensor(v) for n, v in batch.items()}
        tnb = {n: torch.tensor(v) for n, v in node_batch.items()}
        ts = port_state(cfg)
        _, noise = out_of_band_key(ts, tb, "unicycle", 0, cfg.action_dim)
        return agent.update_core(ts, tb, lambda: tnb, None, 0, noise=noise)

    ts_c, m_c = one_update(cfg_t, make_agent(cfg_t, "cpu"))
    ts_d, m_d = one_update(cfg_t, texp.make_decoupled_agent(cfg_t, "cpu"))
    for k in ("qf1_loss", "qf2_loss", "lf_loss", "node_loss"):
        assert float(m_c[k]) == float(m_d[k]), k
    start = port_state(cfg_t)
    changed = [not torch.equal(a, b) for a, b in
               zip(tree_leaves(ts_c.policy), tree_leaves(ts_d.policy))]
    assert any(changed)
    assert any(not torch.equal(a, b) for a, b in
               zip(tree_leaves(start.policy), tree_leaves(ts_d.policy)))

    frozen = dataclasses.replace(
        cfg_t, sac=dataclasses.replace(cfg_t.sac, critic_lr=0.0),
        node=dataclasses.replace(cfg_t.node, fit_episode_limit=-1))
    ts_c, _ = one_update(frozen, make_agent(frozen, "cpu"))
    ts_d, _ = one_update(frozen, texp.make_decoupled_agent(frozen, "cpu"))
    for a, b in zip(state_leaves(ts_c), state_leaves(ts_d)):
        np.testing.assert_array_equal(a, b)

    update_j = jax.jit(j_make_agent(cfg_j,
                                    _decoupled_updates=True).update_from_batch)
    expect, port = lockstep(cfg_j, cfg_t, ts_j, port_state(cfg_t), update_j,
                            texp.make_decoupled_agent(cfg_t, "cpu"), 3,
                            metrics_close)
    states_close(expect, port)


def test_decoupled_episode_runner_trains():
    """``make_decoupled_episode_runner`` runs an episode of the default
    runner's length with updates on the decoupled agent, its metrics
    finite."""
    cfg = tiny_cfg(steps=12)
    out = {}
    for name, make in (("default", make_episode_runner),
                       ("decoupled", texp.make_decoupled_episode_runner)):
        gen = torch.Generator().manual_seed(5)
        ts = create_train_state(cfg, gen, "cpu")
        rl, node = create_replays(cfg, "cpu")
        ts, rl, node, m, _ = make(cfg, "cpu")(ts, rl, node, gen, 0, 0)
        out[name] = (ts, m)
    assert out["decoupled"][1].updates_done == 3
    for k in METRIC_NAMES:
        assert torch.isfinite(out["decoupled"][1].train[k]), k
    assert out["decoupled"][0].updates == out["default"][0].updates == 3


class IndexQueues:
    """Index draws that do not depend on how they are grouped: the k-th
    index drawn from a replay is the k-th of a fixed list (one list per
    replay, in the order the replays are first sampled), whether it is
    drawn alone, in a batch of B or in one of 2B."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.lists, self.used = {}, {}

    def __call__(self, replay, gen, n):
        key = id(replay)
        if key not in self.lists:
            self.lists[key] = self.rng.integers(0, 2 ** 31, 100000)
            self.used[key] = 0
        at = self.used[key]
        self.used[key] = at + n
        raw = torch.tensor(self.lists[key][at:at + n])
        return raw % max(replay.size, 1)


def test_fused_gather_equals_default_given_the_same_index_draws(
        monkeypatch):
    """Two updates a step: given the same index draws (``IndexQueues`` in
    place of ``sample_indices``), every batch the fused gather unpacks,
    its two episodes' metrics, the whole state and both replays equal the
    default path's bit for bit. (With the real generator the fused draw
    takes both updates' indices before update 0's noise, so the stream,
    and the trajectory, differ from the default path's: ROADMAP.md Queue
    3.) A step of one update has nothing to fuse and is refused."""
    cfg = tiny_cfg(updates_per_step=2)
    with pytest.raises(ValueError, match="nothing to fuse"):
        texp.fused_gather_update_step(tiny_cfg())
    unpack = replay_buffer.unpack_rows
    out = {}
    for fused in (False, True):
        seen = []

        def recorded(layout, rows):
            seen.append(rows.clone())
            return unpack(layout, rows)

        monkeypatch.setattr(replay_buffer, "sample_indices",
                            IndexQueues(11))
        monkeypatch.setattr(replay_buffer, "unpack_rows", recorded)
        run = make_episode_runner(
            cfg, "cpu", _update_step=(texp.fused_gather_update_step(cfg)
                                      if fused else None))
        gen = torch.Generator().manual_seed(2)
        ts = create_train_state(cfg, gen, "cpu")
        rl, node = create_replays(cfg, "cpu")
        total, metrics = 0, []
        for ep in range(2):
            ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
            metrics.append([float(m.reward), m.updates_done]
                           + [float(m.train[k]) for k in METRIC_NAMES])
        out[fused] = (seen, metrics, state_leaves(ts), rl.data.clone(),
                      node.data.clone())
    (seen_f, *rest_f), (seen_d, *rest_d) = out[True], out[False]
    assert len(seen_f) == len(seen_d) > 0 and rest_f[0][-1][1] > 0
    assert all(torch.equal(a, b) for a, b in zip(seen_f, seen_d))
    assert rest_f[0] == rest_d[0]
    for a, b in zip(rest_f[1], rest_d[1]):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(rest_f[2], rest_d[2])
    assert torch.equal(rest_f[3], rest_d[3])


def test_stacked_state_files_and_checkpoint(tmp_path):
    """A stacked state writes the plain state's weight files byte for
    byte (critic.pkl in the reference's {'q1','q2'} layout) and loads
    them back; its full checkpoint round-trips into a fresh stacked
    state, and a plain state refuses it by name."""
    cfg = tiny_cfg()
    plain = create_train_state(cfg, torch.Generator().manual_seed(4), "cpu")
    stacked = texp.stack_twin_q_state(cfg, plain)
    save_model_weights(str(tmp_path / "plain"), plain)
    save_model_weights(str(tmp_path / "stacked"), stacked)
    for name in ("actor.pkl", "critic.pkl", "lyapunov.pkl",
                 "node_model.pkl"):
        assert (tmp_path / "plain" / name).read_bytes() == \
            (tmp_path / "stacked" / name).read_bytes(), name
    with open(tmp_path / "stacked" / "critic.pkl", "rb") as f:
        assert set(pickle.load(f)) == {"q1", "q2"}
    fresh = texp.stack_twin_q_state(cfg, create_train_state(
        cfg, torch.Generator().manual_seed(9), "cpu"))
    load_model_weights(str(tmp_path / "stacked"), fresh)
    for a, b in zip(tree_leaves(fresh.critic), tree_leaves(stacked.critic)):
        assert torch.equal(a, b)

    # a trained stacked state, so that its critic's Adam holds moments
    gen = torch.Generator().manual_seed(6)
    rl, node = create_replays(cfg, "cpu")
    ts, rl, node, _, total = make_episode_runner(cfg, "cpu")(
        stacked, rl, node, gen, 0, 0)
    path = str(tmp_path / "ckpt.npz")
    write_checkpoint(path, checkpoint_arrays(ts, rl, node, gen, total, 0))
    back = texp.stack_twin_q_state(cfg, create_train_state(
        cfg, torch.Generator().manual_seed(9), "cpu"))
    rl2, node2 = create_replays(cfg, "cpu")
    gen2 = torch.Generator()
    assert restore_checkpoint(path, back, rl2, node2, gen2) == (total, 0)
    assert back.updates == ts.updates > 0
    for a, b in zip(state_leaves(back), state_leaves(ts)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(gen2.get_state(), gen.get_state())
    other = create_train_state(cfg, torch.Generator().manual_seed(9), "cpu")
    with pytest.raises(ValueError, match="stacked twin-Q layout"):
        restore_checkpoint(path, other, *create_replays(cfg, "cpu"),
                           torch.Generator())


def test_tp_refuses_a_stacked_critic():
    cfg = tiny_cfg()
    stacked = texp.stack_twin_q_state(cfg, create_train_state(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    with pytest.raises(ValueError, match="stacked twin-Q critic"):
        parallel.shard_state_tp(stacked, parallel.ProcessGrid.local(1, 2))
