"""The port's evaluator (``nlbac_tpu_torch/utils/evaluate.py``) and the
CLI's ``--mode eval`` against the JAX package, on the CPU.

The weight files are shared: JAX's ``save_model_weights`` writes them and
the port's ``load_model_weights`` reads them (and the other way round,
compared array for array). ``run_policy``'s deterministic rollouts then
match JAX's on the same weights: the quadrotor from its deterministic
ground start and from a spawn on the curriculum arc, and the unicycle with
``reset`` replaced in both packages by one fixed state (a test-only
patch). Episodes are cut to 40 steps; return, length and violations agree
at rtol 1e-4 / atol 1e-4 (float32 on both sides, summed in different
orders, over 40 steps of the same dynamics). The CLI's eval refusals give
the JAX CLI's messages for the same flags, before any run directory
exists; errors, keys and the evaluation's printed numbers are compared
exactly (to their printed precision).
"""

import dataclasses
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state as j_create
from nlbac_tpu.envs import unicycle as juni
from nlbac_tpu.train import cli as jcli
from nlbac_tpu.train.checkpoint import load_model_weights as j_load
from nlbac_tpu.train.checkpoint import save_model_weights as j_save
from nlbac_tpu.utils import evaluate as jeval
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import create_train_state as t_create
from nlbac_tpu_torch.envs import unicycle as tuni
from nlbac_tpu_torch.train import cli as tcli
from nlbac_tpu_torch.train.checkpoint import load_model_weights as t_load
from nlbac_tpu_torch.train.checkpoint import save_model_weights as t_save
from nlbac_tpu_torch.utils import evaluate as teval

STEPS = 40
FIXED_UNICYCLE = np.array([-1.6, -0.9, 0.6], np.float32)


def tiny_cfg(mod, preset):
    cfg = mod.get_config(preset)
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=STEPS),
        sac=dataclasses.replace(cfg.sac, hidden_dim=24),
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, mlp_hidden_layers=2))


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def shared_weights(preset, tmp_path):
    """A JAX state's weights written by JAX, read by the port; then the
    port's files read back by JAX, array for array."""
    cfg_j, cfg_t = tiny_cfg(jconfig, preset), tiny_cfg(tconfig, preset)
    ts_j = j_create(cfg_j, jax.random.PRNGKey(1))
    j_save(str(tmp_path / "jax"), ts_j)
    ts_t = t_load(str(tmp_path / "jax"),
                  t_create(cfg_t, torch.Generator().manual_seed(5), "cpu"))
    t_save(str(tmp_path / "port"), ts_t)
    back = j_load(str(tmp_path / "port"),
                  j_create(cfg_j, jax.random.PRNGKey(9)))
    for name in ("policy", "critic", "lyap", "node"):
        for a, b in zip(leaves(getattr(ts_j, name)),
                        leaves(getattr(back, name))):
            np.testing.assert_array_equal(a, b, err_msg=name)
    return cfg_j, cfg_t, ts_j, ts_t


def test_aggregate_matches_reference():
    rng = np.random.default_rng(0)
    results = [{"return": float(rng.normal()), "length": int(n),
                "violations": float(rng.integers(0, 5))}
               for n in rng.integers(1, 100, size=7)]
    assert teval.aggregate(results) == jeval.aggregate(results)


@pytest.mark.parametrize("preset,spawn_alpha", [
    ("quadrotor", None), ("quadrotor", 0.5), ("unicycle", None)])
def test_run_policy_matches_reference(preset, spawn_alpha, tmp_path,
                                      monkeypatch):
    cfg_j, cfg_t, ts_j, ts_t = shared_weights(preset, tmp_path)
    if preset == "unicycle":
        def reset_j(key, max_episode_steps=STEPS):
            x = jnp.asarray(FIXED_UNICYCLE)
            st = juni.UnicycleState(
                x=x, step=jnp.int32(0),
                last_goal_dist=jnp.linalg.norm(juni.GOAL - x[:2]))
            return st, juni.get_obs(x)

        def reset_t(device, gen=None, max_episode_steps=STEPS):
            x = torch.tensor(FIXED_UNICYCLE, device=device)
            goal = tuni.constants(torch.device(device))["goal"]
            st = tuni.UnicycleState(
                x=x, step=0, last_goal_dist=torch.linalg.vector_norm(
                    goal - x[:2]))
            return st, tuni.get_obs(x)

        monkeypatch.setattr(juni, "reset", reset_j)
        monkeypatch.setattr(tuni, "reset", reset_t)
    want = jeval.run_policy(cfg_j, ts_j, episodes=2, seed=3,
                            spawn_alpha=spawn_alpha)
    got = teval.run_policy(cfg_t, ts_t, episodes=2, seed=3,
                           spawn_alpha=spawn_alpha)
    assert [r["length"] for r in got] == [r["length"] for r in want]
    for k in ("return", "violations"):
        np.testing.assert_allclose([r[k] for r in got],
                                   [r[k] for r in want], rtol=1e-4,
                                   atol=1e-4, err_msg=k)
    assert want[0]["length"] > 5


def test_stochastic_rollout_is_finite_and_seeded(tmp_path):
    _, cfg_t, _, ts_t = shared_weights("unicycle", tmp_path)
    a = teval.run_policy(cfg_t, ts_t, episodes=2, seed=0,
                         deterministic=False)
    b = teval.run_policy(cfg_t, ts_t, episodes=2, seed=0,
                         deterministic=False)
    assert a == b and all(np.isfinite(r["return"]) for r in a)


@pytest.mark.parametrize("preset,alpha", [("unicycle", 0.5),
                                          ("quadrotor", 0.1),
                                          ("quadrotor", 1.5)])
def test_spawn_alpha_validation_matches_reference(preset, alpha):
    errors = []
    for mod, ev in ((jconfig, jeval), (tconfig, teval)):
        with pytest.raises(ValueError) as e:
            ev.run_policy(tiny_cfg(mod, preset), None, episodes=1,
                          spawn_alpha=alpha)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_main_json_matches_reference(tmp_path):
    """Both evaluators' ``main`` on one run directory at the preset's full
    widths (the quadrotor, whose untrained policy crashes quickly)."""
    cfg = tconfig.get_config("quadrotor")
    t_save(str(tmp_path), t_create(cfg, torch.Generator().manual_seed(2),
                                   "cpu"), include_barrier=True)
    out = {}
    for name, ev in (("jax", jeval), ("port", teval)):
        path = tmp_path / f"{name}.json"
        ev.main([str(tmp_path), "--preset", "quadrotor", "--episodes", "2",
                 "--cpu", "--json", str(path)])
        out[name] = json.loads(path.read_text())
    j, t = out["jax"], out["port"]
    assert list(t) == list(j) == ["preset", "run_dir", "seed",
                                  "deterministic", "episodes", "mean"]
    assert [list(e) for e in t["episodes"]] == \
        [list(e) for e in j["episodes"]]
    assert list(t["mean"]) == list(j["mean"])
    for k in ("preset", "run_dir", "seed", "deterministic"):
        assert t[k] == j[k]
    for a, b in zip(t["episodes"], j["episodes"]):
        assert a["length"] == b["length"]
        np.testing.assert_allclose(a["return"], b["return"], rtol=1e-4)


EVAL_LINE = re.compile(r"eval ep (\d+): return=(\S+) len=(\d+) "
                       r"violations=(\S+)")


def test_mode_eval_through_the_cli_matches_reference(tmp_path, capsys):
    flags = ["--preset", "unicycle", "--cpu", "--max_episode_steps", "30",
             "--hidden_size", "16", "--seed", "4"]
    tcli.main(flags + ["--max_episodes", "1", "--batch_size", "8",
                       "--start_steps", "10", "--replay_size", "100",
                       "--quiet", "--output", str(tmp_path)])
    (run,) = tmp_path.glob("unicycle-run*/*/*_s4")
    before = sorted(p.name for p in run.iterdir())
    capsys.readouterr()
    lines = {}
    for name, mod in (("port", tcli), ("jax", jcli)):
        mod.main(flags + ["--mode", "eval", "--output", str(run)])
        lines[name] = EVAL_LINE.findall(capsys.readouterr().out)
    assert len(lines["port"]) == 5
    assert lines["port"] == lines["jax"]
    assert sorted(p.name for p in run.iterdir()) == before


REFUSALS = {
    "resume": ["--resume", "ckpt.npz"],
    "checkpoint": ["--checkpoint", "ckpt.npz"],
    "profile_dir": ["--profile_dir", "prof"],
    "wandb": ["--wandb"],
    "tensorboard": ["--tensorboard"],
    "n_seeds": ["--n_seeds", "2"],
    "dp": ["--dp", "2"],
    "tp": ["--tp", "2"],
    "num_processes": ["--num_processes", "2", "--coordinator",
                      "localhost:1234", "--process_id", "0"],
    "host_loop": ["--host_loop"],
}


@pytest.mark.parametrize("flag", sorted(REFUSALS))
def test_eval_refusals_match_reference(flag, tmp_path):
    out = tmp_path / "out"
    argv = ["--mode", "eval", "--cpu", "--output", str(out)] + \
        REFUSALS[flag]
    errors = []
    for mod in (jcli, tcli):
        with pytest.raises(SystemExit) as e:
            mod.main(argv)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert not out.exists()
