"""The port's host-loop mode against the JAX package, on the CPU:
``runtime_native`` (the native ring and TSV writer, built from the same
``runtime/host_buffer.cpp``), ``envs/host_adapter`` and ``envs/host_shim``,
the host checkpoints and ``AsyncCheckpointer``, ``MetricsSink`` and
``train/host_loop.train_host_env``.

The ring's rows and the TSV bytes must be identical. Env steps: rtol 1e-5
/ atol 1e-6 (float32 both sides). A host-loop run against JAX's: with a
scripted env whose transitions do not depend on the action, every ring
and NODE-replay column but the action is identical, and so are the
counters (the random streams, hence the actions, differ by design).
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import runtime_native as jrn
from nlbac_tpu.config import EnvConfig as JEnvConfig
from nlbac_tpu.config import NodeConfig as JNodeConfig
from nlbac_tpu.config import ReplayConfig as JReplayConfig
from nlbac_tpu.config import SupervisorConfig as JSupervisorConfig
from nlbac_tpu.config import get_config as j_get_config
from nlbac_tpu.envs import as_host_env as j_as_host_env
from nlbac_tpu.envs import unicycle as j_unicycle
from nlbac_tpu.envs.base import EnvSpec as JEnvSpec
from nlbac_tpu.envs.host_adapter import HostEnvAdapter as JHostEnvAdapter
from nlbac_tpu.train import host_loop as jhl
from nlbac_tpu.train.logging import EpochLogger as JEpochLogger
from nlbac_tpu_torch import runtime_native as rn
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.config import EnvConfig, NodeConfig, ReplayConfig
from nlbac_tpu_torch.config import SupervisorConfig, get_config
from nlbac_tpu_torch.envs import as_host_env, unicycle
from nlbac_tpu_torch.envs.base import EnvSpec
from nlbac_tpu_torch.envs.host_adapter import HostEnvAdapter
from nlbac_tpu_torch.train import checkpoint as ck
from nlbac_tpu_torch.train import host_loop as hl
from nlbac_tpu_torch.train.driver import create_replays
from nlbac_tpu_torch.train.logging import EpochLogger, MetricsSink
from nlbac_tpu_torch.tree import tree_leaves

WIDTH = 9


def _pushes(rng, n):
    return rng.normal(size=(n, WIDTH)).astype(np.float32)


def test_host_replay_samples_as_the_jax_packages():
    rng = np.random.default_rng(0)
    rows = _pushes(rng, 50)
    ours, theirs = rn.HostReplay(32, WIDTH, seed=7), \
        jrn.HostReplay(32, WIDTH, seed=7)
    for i, row in enumerate(rows):
        if i % 3:
            ours.push(row)
            theirs.push(row)
        else:
            ours.push_many(row[None])
            theirs.push_many(row[None])
        if i % 10 == 9:
            np.testing.assert_array_equal(ours.sample(17), theirs.sample(17))
    assert (ours.size, ours.total) == (theirs.size, theirs.total) == (32, 50)
    np.testing.assert_array_equal(ours.sample(64, max_index=5),
                                  theirs.sample(64, max_index=5))
    out = np.empty((8, WIDTH), np.float32)
    assert ours.sample(8, out=out) is out
    np.testing.assert_array_equal(out, theirs.sample(8))
    with pytest.raises(ValueError, match="record"):
        ours.push(np.zeros(WIDTH + 1, np.float32))


def test_host_replay_snapshot_round_trips():
    rng = np.random.default_rng(1)
    ring = rn.HostReplay(16, WIDTH, seed=3)
    for row in _pushes(rng, 21):
        ring.push(row)
    data, meta = ring.snapshot()
    expect = ring.sample(40)
    other = rn.HostReplay(16, WIDTH, seed=99)
    other.restore(data, meta)
    assert (other.size, other.total) == (16, 21)
    np.testing.assert_array_equal(other.sample(40), expect)
    np.testing.assert_array_equal(other.snapshot()[0], data)


@pytest.mark.parametrize("field,value", [(0, 16), (1, 17), (2, 3)])
def test_host_replay_restore_rejects_a_bad_cursor(field, value):
    """position >= capacity, size > capacity, total < size: each would
    send the native ring out of bounds, so restore refuses it before the
    native call."""
    ring = rn.HostReplay(16, WIDTH, seed=3)
    for row in _pushes(np.random.default_rng(2), 5):
        ring.push(row)
    data, meta = ring.snapshot()
    bad = meta.copy()
    bad[field] = value
    with pytest.raises(ValueError, match="cursor"):
        ring.restore(data, bad)
    with pytest.raises(ValueError, match="shape"):
        ring.restore(data[:4], meta)
    assert (ring.size, ring.total) == (5, 5)


ROWS = [[0, 1.5, -2.25e-7, 123456789.0, float("nan"), 16777217.0],
        [1, -0.0, 1e300, 3.0, 2.0 / 3.0, float("inf")]]


def test_native_tsv_writer_bytes_match_the_jax_packages(tmp_path):
    for mod, name in ((rn, "ours.txt"), (jrn, "theirs.txt")):
        w = mod.NativeTsvWriter(str(tmp_path / name))
        w.header(["a", "b", "c", "d", "e", "f"])
        for row in ROWS:
            w.row(list(row))
        w.close()
    ours = (tmp_path / "ours.txt").read_bytes()
    assert ours == (tmp_path / "theirs.txt").read_bytes()
    assert ours.count(b"\n") == 3


def test_epoch_logger_writes_progress_through_the_native_writer(tmp_path):
    """The default logger writes through the native writer, byte for byte
    as the Python writer and as the JAX package's logger."""
    outs = {}
    for key, make in (("native", lambda d: EpochLogger(d, quiet=True)),
                      ("python", lambda d: EpochLogger(d, quiet=True,
                                                       native=False)),
                      ("jax", lambda d: JEpochLogger(d, quiet=True))):
        d = str(tmp_path / key)
        logger = make(d)
        for ep in range(3):
            logger.store(reward=ep * 0.1 + 1e-3, loss=1.0 / (ep + 3))
            logger.log_tabular("Episode", ep)
            logger.log_tabular("reward")
            logger.log_tabular("loss")
            logger.log_tabular("updates", 16777217 + ep)
            logger.dump_tabular()
        if key != "jax":
            assert logger.writer == key
        logger.close()
        outs[key] = open(os.path.join(d, "progress.txt"), "rb").read()
    assert outs["native"] == outs["python"] == outs["jax"]


def test_host_env_adapter_marshals_like_the_jax_packages():
    class Env:
        def reset(self):
            return [0.5, -1.0]

        def step(self, a):
            info = {"num_safety_violation_obstacles": 1.0,
                    "num_safety_violation_y": 2.0,
                    "safety_cost_x": 0.25, "goal_met": True,
                    "reached": 1.0}
            return ([float(a[0]), 2.0], 1.5, 0.5, [0.1, 0.2], [0.3, 0.4],
                    False, info)

    spec = EnvSpec(name="identity", obs_dim=2, action_dim=1, state_dim=2,
                   lyap_dim=2, dt=0.1, max_episode_steps=8,
                   action_low=(-1.0,), action_high=(1.0,))
    ours = HostEnvAdapter(Env(), spec)
    theirs = JHostEnvAdapter(Env(), JEnvSpec(*spec))
    np.testing.assert_array_equal(ours.host_reset(), theirs.host_reset())
    a = np.array([0.75], np.float32)
    for x, y in zip(ours.host_step(a), theirs.host_step(a)):
        np.testing.assert_array_equal(x, y)
        assert np.asarray(x).dtype == np.asarray(y).dtype
    state, out = ours.step(0, torch.tensor(a))
    assert state == 1 and float(out.num_violations) == 3.0
    assert float(out.safety_cost) == 0.25 and bool(out.goal_met)
    assert out.viol_breakdown.tolist() == [3.0, 0.0, 0.0, 0.0]


def test_as_host_env_steps_unicycle_as_the_jax_shim():
    """From the same injected state, the port's shim and JAX's step the
    unicycle alike through the host gym API."""
    ours = as_host_env(unicycle, seed=4, max_episode_steps=20)
    theirs = j_as_host_env(j_unicycle, seed=4, max_episode_steps=20)
    assert ours.obs_to_state is unicycle.obs_to_state
    assert ours.SPEC.max_episode_steps == 20
    np.testing.assert_allclose(ours.host_reset(), theirs.host_reset(),
                               rtol=1e-5, atol=1e-6)
    x = np.array([0.3, -0.7, 1.1], np.float32)
    ours.env.state = unicycle.UnicycleState(
        x=torch.tensor(x), step=3, last_goal_dist=torch.tensor(3.0))
    theirs.env._state = j_unicycle.UnicycleState(
        x=jnp.asarray(x), step=jnp.int32(3),
        last_goal_dist=jnp.float32(3.0))
    rng = np.random.default_rng(5)
    for _ in range(6):
        a = rng.uniform([-3.5, -12], [3.5, 12]).astype(np.float32)
        for x1, y1 in zip(ours.host_step(a), theirs.host_step(a)):
            np.testing.assert_allclose(np.asarray(x1, np.float64),
                                       np.asarray(y1, np.float64),
                                       rtol=1e-5, atol=1e-6)


# -- train_host_env -----------------------------------------------------------

class Scripted:
    """A host env whose transitions do not depend on the action."""

    def __init__(self, max_steps=8):
        self.max_steps = max_steps
        self.k = 0
        self.episode = -1

    def reset(self):
        self.k = 0
        self.episode += 1
        return self._obs()

    def _obs(self):
        s = 0.1 * self.k + 0.37 * self.episode
        return np.array([np.sin(s), np.cos(2 * s)], np.float32)

    def step(self, a):
        self.k += 1
        obs = self._obs()
        barrier = -1.0 if obs[0] > 0.5 else 0.0
        info = {"num_safety_violation": float(barrier < 0),
                "safety_cost": max(0.0, float(obs[0]) - 0.5),
                "reached": float(self.k % 3 == 0)}
        return (obs, float(obs[1]), abs(float(obs[0])), barrier, obs.copy(),
                obs * 0.5, self.k >= self.max_steps, info)


def _cfg(mods, max_steps=8, batch_size=4, start_steps=4,
         supervisor=None, use_backup=False):
    """The JAX tests' tiny host-loop config (tests/test_runtime_native.py:
    the point-mass one), in the package ``mods`` = (get_config, EnvConfig,
    NodeConfig, ReplayConfig, SupervisorConfig)."""
    get, env_c, node_c, replay_c, sup_c = mods
    cfg = get("nbc_unicycle")
    return dataclasses.replace(
        cfg,
        env=env_c(name="identity", dt=0.1, max_episode_steps=max_steps,
                  barrier_signals=True),
        sac=dataclasses.replace(cfg.sac, hidden_dim=8,
                                batch_size=batch_size, updates_per_step=1,
                                start_steps=start_steps),
        node=node_c(form="mlp", state_dim=2, action_dim=1, hidden_dim=8,
                    mlp_hidden_layers=1, max_batch=8, update_interval=2),
        constraint=dataclasses.replace(cfg.constraint,
                                       use_backup=use_backup),
        supervisor=supervisor or sup_c(kind="none"),
        replay=replay_c(capacity=64, node_capacity=64),
        obs_dim=2, action_dim=1, lyap_dim=2)


PORT = (get_config, EnvConfig, NodeConfig, ReplayConfig, SupervisorConfig)
JAXP = (j_get_config, JEnvConfig, JNodeConfig, JReplayConfig,
        JSupervisorConfig)
SPEC = dict(name="identity", obs_dim=2, action_dim=1, state_dim=2,
            lyap_dim=2, dt=0.1, max_episode_steps=8, action_low=(-1.0,),
            action_high=(1.0,))


def _port_adapter(env=None):
    return HostEnvAdapter(env or Scripted(), EnvSpec(**SPEC),
                          has_barrier_signal=True)


def _spy(monkeypatch, module):
    box = {}
    real = module.HostRings

    class Spy(real):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            box["rings"] = self

    monkeypatch.setattr(module, "HostRings", Spy)
    return box


def test_host_loop_fills_the_replays_as_the_jax_package(monkeypatch):
    ours_box, theirs_box = _spy(monkeypatch, hl), _spy(monkeypatch, jhl)
    ts, hist = hl.train_host_env(_cfg(PORT), _port_adapter(), episodes=3,
                                 seed=0, device="cpu")
    jts, jhist = jhl.train_host_env(
        _cfg(JAXP), JHostEnvAdapter(Scripted(), JEnvSpec(**SPEC),
                                    has_barrier_signal=True),
        episodes=3, seed=0)
    ours, theirs = ours_box["rings"], theirs_box["rings"]
    action = [(off, w) for name, off, w in ours.layout if name == "action"]
    (a0, aw), = action
    keep = np.r_[0:a0, a0 + aw:ours.width]
    d_o, m_o = ours.rl.snapshot()
    d_t, m_t = theirs.rl.snapshot()
    np.testing.assert_array_equal(m_o[:3], m_t[:3])
    np.testing.assert_array_equal(d_o[:, keep], d_t[:, keep])
    node_o = ours.node_replay
    node_t = theirs.node_replay
    assert node_o.size == int(node_t.size) == 24
    np.testing.assert_array_equal(node_o.data[:, keep].numpy(),
                                  np.asarray(node_t.data)[:, keep])
    assert ts.updates == int(jts.updates) == hist[-1]["updates"] == \
        jhist[-1]["updates"]
    for a, b in zip(hist, jhist):
        assert list(a) == list(b)
        for k in ("Episode", "episode_steps", "reward_train", "cost_train",
                  "safety_cost_train", "reached", "updates",
                  "backup_steps"):
            assert a[k] == pytest.approx(b[k], rel=1e-6), k


def test_host_loop_backup_semantics(monkeypatch):
    """The trap machine engages the backup controller from
    ``enable_after_episodes`` on; backup-active transitions skip the RL
    ring but reach the device NODE replay (tests/test_runtime_native.py:
    325 for the JAX package)."""
    sup = SupervisorConfig(kind="trap", enable_after_episodes=1, window=4,
                           min_steps=2, trap_threshold=100.0, trap_count=2,
                           backup_max_steps=3, escape_distance_sq=1e9)
    cfg = _cfg(PORT, start_steps=0, supervisor=sup, use_backup=True)
    box = _spy(monkeypatch, hl)
    _, history = hl.train_host_env(cfg, _port_adapter(), episodes=3,
                                   seed=0, device="cpu")
    assert history[0]["backup_steps"] == 0
    engaged = sum(h["backup_steps"] for h in history[1:])
    assert engaged > 0
    rings = box["rings"]
    total = sum(h["episode_steps"] for h in history)
    assert rings.node_replay.size == total
    assert rings.rl.size == total - engaged
    assert history[-1]["updates"] > 0
    with pytest.raises(ValueError, match="never trained"):
        hl.train_host_env(dataclasses.replace(
            cfg, constraint=dataclasses.replace(cfg.constraint,
                                                use_backup=False)),
            _port_adapter(), episodes=1, device="cpu")


def test_host_loop_refuses_zero_updates_per_step():
    cfg = _cfg(PORT)
    cfg = dataclasses.replace(cfg, sac=dataclasses.replace(
        cfg.sac, updates_per_step=0))
    with pytest.raises(ValueError, match="updates_per_step"):
        hl.train_host_env(cfg, _port_adapter(), episodes=1, device="cpu")


def test_host_loop_resume_is_bit_exact(tmp_path):
    """Checkpointed after episode 1 and resumed, a run repeats the
    uninterrupted one bit for bit (the ring's sampler state, the NODE
    replay, the trainer's generator, the counters; this env has no
    generator, so its resets are replayed)."""
    ts_a, hist_a = hl.train_host_env(_cfg(PORT, start_steps=0),
                                     _port_adapter(), episodes=4, seed=3,
                                     device="cpu")
    path = str(tmp_path / "ck.npz")
    hl.train_host_env(_cfg(PORT, start_steps=0), _port_adapter(),
                      episodes=2, seed=3, checkpoint_path=path,
                      device="cpu")
    ts_b, hist_b = hl.train_host_env(_cfg(PORT, start_steps=0),
                                     _port_adapter(), episodes=4, seed=3,
                                     resume_path=path, device="cpu")
    assert [r["Episode"] for r in hist_b] == [2, 3]
    for ra, rb in zip(hist_a[2:], hist_b):
        assert {k: v for k, v in ra.items() if k != "wall_s"} == \
            {k: v for k, v in rb.items() if k != "wall_s"}
    assert ts_a.updates == ts_b.updates
    for field in ("policy", "critic", "lyap", "barrier", "node"):
        for x, y in zip(tree_leaves(getattr(ts_a, field)),
                        tree_leaves(getattr(ts_b, field))):
            assert torch.equal(x, y), field


def _fused_and_host_checkpoints(tmp_path):
    cfg = _cfg(PORT)
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(dataclasses.replace(
        get_config("unicycle"), replay=ReplayConfig(8, 8)), "cpu")
    fused = str(tmp_path / "fused.npz")
    ck.write_checkpoint(fused, ck.checkpoint_arrays(ts, rl, node, gen, 0, 0))
    host = str(tmp_path / "host.npz")
    rings = hl.HostRings(cfg, EnvSpec(**SPEC))
    node_h = create_replays(dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, name="unicycle")), "cpu")[1]
    ck.write_checkpoint(host, ck.host_checkpoint_arrays(
        ts, rings.rl, node_h, gen, None, 0, 0))
    return cfg, ts, rl, node, rings, node_h, gen, fused, host


@pytest.mark.parametrize("restore", ["fused", "host"])
def test_each_checkpoint_mode_refuses_the_other(tmp_path, restore):
    cfg, ts, rl, node, rings, node_h, gen, fused, host = \
        _fused_and_host_checkpoints(tmp_path)
    with np.load(host) as z:
        assert "host_loop" in bytes(z["extra"]).decode()
    if restore == "fused":
        with pytest.raises(ValueError, match="--host_loop"):
            ck.restore_checkpoint(host, ts, rl, node, gen)
    else:
        with pytest.raises(ValueError, match="not a host-loop"):
            ck.restore_host_checkpoint(fused, ts, rings.rl, node_h, gen,
                                       None)


def test_async_checkpointer_snapshots_before_save_returns(tmp_path):
    """The archive holds the values at save time, though the parameters
    change in place right after, and wait() re-raises a failed write."""
    cfg = _cfg(PORT)
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(dataclasses.replace(
        get_config("unicycle"), replay=ReplayConfig(8, 8)), "cpu")
    before = [p.detach().clone() for p in tree_leaves(ts.policy)]
    writer = ck.AsyncCheckpointer()
    path = str(tmp_path / "a.npz")
    writer.save(path, ck.checkpoint_arrays(ts, rl, node, gen, 5, 1))
    with torch.no_grad():
        for p in tree_leaves(ts.policy):
            p.add_(1.0)
    writer.wait()
    with np.load(path) as z:
        for i, p in enumerate(before):
            np.testing.assert_array_equal(z[f"ts.policy.{i}"], p.numpy())
    blocker = tmp_path / "file"
    blocker.write_text("")
    writer.save(str(blocker / "b.npz"), {"x": np.zeros(1)})
    with pytest.raises(RuntimeError, match="checkpoint write failed"):
        writer.wait()
    writer.wait()  # the failure is reported once


def test_metrics_sink_goes_on_without_wandb(monkeypatch, capsys):
    import builtins

    real_import = builtins.__import__

    def no_wandb(name, *a, **k):
        if name == "wandb":
            raise ImportError("No module named 'wandb'")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", no_wandb)
    sink = MetricsSink(use_wandb=True)
    out = capsys.readouterr().out
    assert out.count("\n") == 1 and "wandb unavailable" in out
    sink.log({"Episode Reward": 1.5})
    sink.close()
    assert sink.history == [{"Episode Reward": 1.5}]
