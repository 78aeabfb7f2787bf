"""The port's training CLI (``nlbac_tpu_torch.train.cli``) on the CPU:
for each of the six presets it writes ``progress.txt`` with the JAX CLI's
header (``barrier_td_loss`` last among the training columns of the
learned-barrier family, nonzero), the same ``config.json``, the
reference-layout weight files (which the JAX package's
``load_model_weights`` reads, with the port's deterministic action at rtol
1e-5; ``barrier.pkl`` too for the learned-barrier family, with the barrier
exactly as in the checkpoint) and ``checkpoint.npz``; ``--resume``
continues bit for bit (the quadrotor's with the spawn curriculum's draws);
the parallel flags refuse what the JAX CLI refuses, before any run
directory is made.
"""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu.agent import create_train_state as j_create_train_state
from nlbac_tpu.agent.state import action_spec
from nlbac_tpu.nn import gaussian_policy_sample as j_policy_sample
from nlbac_tpu.train import cli as jcli
from nlbac_tpu.train.checkpoint import load_model_weights as j_load_weights
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import ActionSpec, gaussian_policy_sample
from nlbac_tpu_torch.train import cli
from nlbac_tpu_torch.train.checkpoint import (
    load_model_weights,
    restore_checkpoint,
)
from nlbac_tpu_torch.train.driver import create_replays
from nlbac_tpu_torch.tree import tree_leaves

PRESETS = ("unicycle", "cars", "pvtol", "nbc_unicycle", "nbc_pvtol",
           "quadrotor")
NBC = ("nbc_unicycle", "nbc_pvtol", "quadrotor")
WEIGHTS = ("actor.pkl", "critic.pkl", "lyapunov.pkl", "node_model.pkl")


def tiny_args(preset, out, *extra):
    return ["--preset", preset, "--cpu", "--quiet", "--output", str(out),
            "--max_episodes", "1", "--max_episode_steps", "12",
            "--batch_size", "4", "--start_steps", "4", "--hidden_size",
            "16", "--replay_size", "100", "--NODE_model_update_interval",
            "5", *extra]


def run_dir(out):
    (found,) = glob.glob(os.path.join(str(out), "*-run*", "*", "*_s*"))
    return found


def read_lines(path):
    with open(path) as f:
        return f.read().splitlines()


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """One tiny CLI run of the port per preset: preset -> its --output."""
    root = tmp_path_factory.mktemp("port")
    for preset in PRESETS:
        cli.main(tiny_args(preset, root / preset))
    return {preset: root / preset for preset in PRESETS}


@pytest.mark.parametrize("preset", PRESETS)
def test_cli_writes_the_jax_clis_files(port_runs, preset, tmp_path):
    run = run_dir(port_runs[preset])
    for name in ("progress.txt", "config.json", "checkpoint.npz") + WEIGHTS:
        assert os.path.isfile(os.path.join(run, name)), name
    assert os.path.isfile(os.path.join(run, "barrier.pkl")) == \
        (preset in NBC)
    jcli.main(tiny_args(preset, tmp_path))
    jrun = run_dir(tmp_path)
    assert os.path.relpath(jrun, tmp_path) == \
        os.path.relpath(run, port_runs[preset])
    header, *rows = read_lines(os.path.join(run, "progress.txt"))
    assert header == read_lines(os.path.join(jrun, "progress.txt"))[0]
    assert len(rows) == 1
    values = dict(zip(header.split("\t"), map(float, rows[0].split("\t"))))
    assert values["episode_steps"] == 12 and values["updates"] > 0
    assert all(np.isfinite(v) for v in values.values())
    if preset in NBC:
        assert header.split("\t")[-3:] == ["barrier_td_loss", "updates",
                                           "backup_steps"]
        assert values["barrier_td_loss"] > 0
    else:
        assert "barrier_td_loss" not in values
    with open(os.path.join(run, "config.json")) as f, \
            open(os.path.join(jrun, "config.json")) as g:
        port_cfg, jax_cfg = json.load(f), json.load(g)
    # the same config but for the --output each run was given
    assert port_cfg["run"].pop("output") == str(port_runs[preset])
    assert jax_cfg["run"].pop("output") == str(tmp_path)
    assert port_cfg == jax_cfg


@pytest.mark.parametrize("preset", PRESETS)
def test_jax_reads_the_ports_weight_files(port_runs, preset):
    """JAX's load_model_weights reads the port's files into a TrainState
    whose deterministic action equals the port's final policy's (restored
    from the checkpoint, not from the files)."""
    run = run_dir(port_runs[preset])
    args = jcli.build_parser().parse_args(tiny_args(preset, "unused"))
    cfg_j = jcli.config_from_args(args)
    template = j_create_train_state(cfg_j, jax.random.PRNGKey(1))
    ts_j = j_load_weights(run, template, include_barrier=preset in NBC)
    for field in ("policy", "critic", "lyap", "node", "barrier"):
        assert jax.tree.structure(getattr(ts_j, field)) == \
            jax.tree.structure(getattr(template, field)), field
        for a, b in zip(jax.tree.leaves(getattr(ts_j, field)),
                        jax.tree.leaves(getattr(template, field))):
            assert np.shape(a) == np.shape(b), field

    cfg_t = cli.config_from_args(cli.build_parser().parse_args(
        tiny_args(preset, "unused")))
    gen = torch.Generator().manual_seed(0)
    ts_t = create_train_state(cfg_t, gen, "cpu")
    rl, node = create_replays(cfg_t, "cpu")
    restore_checkpoint(os.path.join(run, "checkpoint.npz"), ts_t, rl, node,
                       gen)
    # the barrier read from barrier.pkl is the checkpoint's; without the
    # file (the other presets) JAX keeps its template's
    barrier_t = [p.detach().numpy() for p in ts_t.barrier["w"]]
    for a, b, c in zip(ts_j.barrier["w"], barrier_t, template.barrier["w"]):
        np.testing.assert_array_equal(np.asarray(a),
                                      b if preset in NBC else np.asarray(c))

    obs = np.random.default_rng(0).normal(
        size=(8, cfg_j.obs_dim)).astype(np.float32)
    _, _, det_j = j_policy_sample(ts_j.policy, jnp.asarray(obs),
                                  jax.random.PRNGKey(0), action_spec(cfg_j))
    spec = get_env(cfg_t.env.name).SPEC
    _, _, det_t = gaussian_policy_sample(
        ts_t.policy, torch.tensor(obs),
        ActionSpec.from_bounds(spec.action_low, spec.action_high),
        noise=torch.zeros(8, cfg_t.action_dim))
    np.testing.assert_allclose(np.asarray(det_j), det_t.detach().numpy(),
                               rtol=1e-5, atol=0)


@pytest.mark.parametrize("preset,extra", [
    ("unicycle", []), ("cars", []), ("nbc_unicycle", []),
    ("quadrotor", ["--spawn_curriculum_episodes", "1",
                   "--spawn_curriculum_mode", "mix", "--kill_attitude",
                   "1.5", "--pretanh_reg", "0.001", "--probe_pretanh_reg",
                   "0.01"])])
def test_resume_is_bit_exact(preset, extra, tmp_path):
    """Two episodes straight == one episode, then --resume for one more:
    the same progress.txt rows and the same final checkpoint, array for
    array (parameters, Adam states, multipliers, replays, generator,
    counters). The quadrotor's second episode is past its one-episode
    anneal, so its spawn takes the mix's alpha draw as well as the
    jitter's, both from the restored generator."""
    common = ["--preset", preset, "--cpu", "--quiet",
              "--max_episode_steps", "12", "--batch_size", "4",
              "--start_steps", "4", "--hidden_size", "16",
              "--NODE_model_update_interval", "5", *extra]
    cli.main(common + ["--output", str(tmp_path / "a"), "--max_episodes",
                       "2"])
    cli.main(common + ["--output", str(tmp_path / "b"), "--max_episodes",
                       "1"])
    first = run_dir(tmp_path / "b")
    cli.main(common + ["--output", str(tmp_path / "c"), "--max_episodes",
                       "2", "--resume",
                       os.path.join(first, "checkpoint.npz")])
    straight, resumed = run_dir(tmp_path / "a"), run_dir(tmp_path / "c")

    rows = read_lines(os.path.join(straight, "progress.txt"))
    assert rows[:2] == read_lines(os.path.join(first, "progress.txt"))
    assert [rows[0], rows[2]] == \
        read_lines(os.path.join(resumed, "progress.txt"))
    with np.load(os.path.join(straight, "checkpoint.npz")) as a, \
            np.load(os.path.join(resumed, "checkpoint.npz")) as c:
        assert sorted(a.files) == sorted(c.files)
        for name in a.files:
            np.testing.assert_array_equal(a[name], c[name], err_msg=name)
        assert a["counters"][2] == 1  # the episode
        assert a["counters"][1] == sum(  # total steps
            float(r.split("\t")[1]) for r in rows[1:])


@pytest.mark.parametrize("preset", ["nbc_unicycle", "unicycle"])
def test_port_reads_its_weight_files(port_runs, preset):
    """The port's load_model_weights(..., include_barrier=True) restores
    the run's final weights (the checkpoint's), the barrier's from
    barrier.pkl where the run wrote one; without the file the barrier
    keeps its own values."""
    run = run_dir(port_runs[preset])
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        tiny_args(preset, "unused")))
    final = create_train_state(cfg, torch.Generator().manual_seed(0), "cpu")
    rl, node = create_replays(cfg, "cpu")
    restore_checkpoint(os.path.join(run, "checkpoint.npz"), final, rl, node,
                       torch.Generator().manual_seed(0))
    ts = create_train_state(cfg, torch.Generator().manual_seed(9), "cpu")
    own_barrier = [p.detach().clone() for p in tree_leaves(ts.barrier)]
    assert load_model_weights(run, ts, include_barrier=True) is ts
    fields = ["policy", "critic", "lyap", "node"]
    if preset in NBC:
        fields.append("barrier")
    else:
        for a, b in zip(tree_leaves(ts.barrier), own_barrier):
            assert torch.equal(a, b)
    for field in fields:
        for a, b in zip(tree_leaves(getattr(ts, field)),
                        tree_leaves(getattr(final, field))):
            assert torch.equal(a, b), field


def test_restore_checks_the_checkpoint_against_the_config(port_runs):
    ckpt = os.path.join(run_dir(port_runs["unicycle"]), "checkpoint.npz")
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        tiny_args("unicycle", "unused", "--hidden_size", "8")))
    gen = torch.Generator().manual_seed(0)
    ts = create_train_state(cfg, gen, "cpu")
    rl, node = create_replays(cfg, "cpu")
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(ckpt, ts, rl, node, gen)


@pytest.mark.parametrize("extra", [
    ["--num_processes", "2"],
    ["--n_seeds", "2", "--num_processes", "2", "--coordinator",
     "localhost:1234", "--process_id", "0"],
    ["--dp", "0"],
    ["--tp", "3"],
    ["--dp", "3", "--batch_size", "128"],
    ["--n_seeds", "2", "--resume", "ckpt.npz"],
    ["--n_seeds", "2", "--tensorboard"],
])
def test_unported_flags_fail_before_any_run_dir(extra, tmp_path):
    """The parallel flags (ported since; the name is kept) refuse what the
    JAX CLI refuses, with its message, and before the port makes any run
    directory or process group (the JAX CLI makes its run directory before
    the last two refusals, so it writes elsewhere)."""
    errors = []
    for mod, out in ((jcli, tmp_path / "jax"), (cli, tmp_path / "out")):
        with pytest.raises(SystemExit) as e:
            mod.main(tiny_args("unicycle", out, *extra))
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert not (tmp_path / "out").exists()


def test_cli_needs_a_gpu_unless_told_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = [a for a in tiny_args("unicycle", tmp_path / "out")
            if a != "--cpu"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)
    assert not (tmp_path / "out").exists()
