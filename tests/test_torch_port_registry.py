"""The port's extension surface against the JAX package's, on the CPU:
``register_env`` / ``register_builder`` (the contract checks and the
collision rule give JAX's errors), and the point-mass env of
``examples/torch_custom_env.py`` trained for a few short episodes both
through the registry (the CLI module's ``train``) and as an unregistered
``env_override`` of the episode runner; its learned-barrier variant
(``examples/torch_custom_barrier_env.py``, ``USES_BARRIER``) trains the
barrier critic. No tolerance: these tests compare error messages and
check that the losses are finite and the barrier's TD loss nonzero.
"""

import dataclasses
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import nlbac_tpu.constraints as jcons
import nlbac_tpu.envs as jenvs
import nlbac_tpu_torch.constraints as tcons
import nlbac_tpu_torch.envs as tenvs

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "examples"))
import torch_custom_barrier_env as nbc_example  # noqa: E402
import torch_custom_env as example  # noqa: E402

from nlbac_tpu_torch.agent import create_train_state  # noqa: E402
from nlbac_tpu_torch.train import create_replays  # noqa: E402
from nlbac_tpu_torch.train import make_episode_runner  # noqa: E402
from nlbac_tpu_torch.train.cli import train  # noqa: E402
from nlbac_tpu_torch.utils.plot import load_progress  # noqa: E402


def short(cfg, episodes=2, steps=25):
    """The example's config cut to a few short episodes at small widths."""
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=steps),
        sac=dataclasses.replace(cfg.sac, hidden_dim=16, batch_size=8,
                                start_steps=10),
        node=dataclasses.replace(cfg.node, hidden_dim=8, max_batch=16,
                                 update_interval=3),
        replay=dataclasses.replace(cfg.replay, capacity=128,
                                   node_capacity=128),
        run=dataclasses.replace(cfg.run, max_episodes=episodes))


def _message(fn, *args):
    """The error's text with the package name and the list of registered
    names (which other tests of the process may extend) normalized."""
    with pytest.raises(ValueError) as e:
        fn(*args)
    text = str(e.value).replace("nlbac_tpu_torch", "nlbac_tpu")
    return re.sub(r"options: \[[^]]*\]", "options: [...]", text)


class _Empty:
    pass


class _BadSpec:
    SPEC = (1, 2)
    reset = step = obs_to_state = state_to_obs = staticmethod(lambda: None)


@pytest.mark.parametrize("case", ["missing", "spec", "shadow_builtin",
                                  "builder_missing", "builder_shadow",
                                  "unknown_env", "unknown_builder"])
def test_registry_errors_match_reference(case):
    calls = {
        "missing": lambda m: m[0].register_env("bad_env", _Empty),
        "spec": lambda m: m[0].register_env("bad_spec", _BadSpec),
        "shadow_builtin": lambda m: m[0].register_env("unicycle", _Empty),
        "builder_missing": lambda m: m[1].register_builder("bad", _Empty),
        "builder_shadow": lambda m: m[1].register_builder("unicycle",
                                                          _Empty),
        "unknown_env": lambda m: m[0].get_env("no_such_env"),
        "unknown_builder": lambda m: m[1].get_builder("no_such_kind"),
    }[case]
    got = _message(calls, (tenvs, tcons))
    want = _message(calls, (jenvs, jcons))
    assert got == want
    assert "bad_spec" not in tenvs._ENVS and "bad" not in tcons._BUILDERS


def test_reregistering_the_same_object_is_a_no_op():
    example.register()
    example.register()  # the same objects again
    assert tenvs.get_env("pointmass") is example.PointMassEnv
    assert tcons.get_builder("pointmass") is example.PointMassConstraints
    assert not tcons.uses_barrier("pointmass")
    with pytest.raises(ValueError, match="already registered"):
        tenvs.register_env("pointmass", nbc_example.PointMassBarrierEnv)


def test_registered_env_trains_through_the_registry(tmp_path):
    example.register()
    cfg = short(example.make_config())
    ts, rl, _ = train(cfg, output_dir=str(tmp_path), quiet=True,
                      device="cpu")
    cols = load_progress(str(tmp_path / "progress.txt"))
    assert list(cols["Episode"]) == [0.0, 1.0]
    assert ts.updates > 0 and rl.size == 50
    for k in ("reward_train", "qf1_loss", "policy_loss", "node_loss"):
        assert np.all(np.isfinite(cols[k])), k
    assert "barrier_td_loss" not in cols


def test_unregistered_env_trains_through_env_override():
    example.register()  # the builder; the env stays out of the registry
    cfg = short(example.make_config(env_name="pointmass_unlisted"))
    with pytest.raises(ValueError, match="unknown env"):
        tenvs.get_env("pointmass_unlisted")
    env = example.PointMassEnv
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(cfg, "cpu", env_override=env)
    run = make_episode_runner(cfg, "cpu", env_override=env)
    total = 0
    for ep in range(2):
        ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
    assert total == 50 and rl.size == node.size == 50
    # updates start once the replay holds more than a batch (8 rows)
    assert ts.updates == (25 - 9) + 25
    assert all(np.isfinite(float(v)) for v in m.train.values())


def test_uses_barrier_builder_trains_the_barrier_critic(tmp_path):
    nbc_example.register()
    assert tcons.uses_barrier("pointmass_nbc")
    cfg = short(nbc_example.make_barrier_config(), steps=40)
    train(cfg, output_dir=str(tmp_path), quiet=True, device="cpu")
    cols = load_progress(str(tmp_path / "progress.txt"))
    assert (tmp_path / "barrier.pkl").is_file()
    assert np.all(np.isfinite(cols["barrier_td_loss"]))
    assert cols["barrier_td_loss"].max() > 0
