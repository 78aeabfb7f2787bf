"""The port's CLI modes on the CPU: the flags that once exited naming
their ROADMAP.md item (``--host_loop``, ``--wandb``,
``--tensorboard``, ``--node_solver dopri5`` and ``--node_adaptive_*``)
train and write ``progress.txt`` and a checkpoint of their mode;
``--resume`` under ``--host_loop`` continues bit for bit; ``--host_loop``
refuses what the JAX CLI refuses, before any run directory is made.
(Apart from ``tests/test_torch_port_cli.py`` so that the two files' runs
can share the test workers.)
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from nlbac_tpu_torch.train import cli


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


WEIGHTS = ("actor.pkl", "critic.pkl", "lyapunov.pkl", "node_model.pkl")


# the dopri5 runs skip the 32768-row NODE fit (its rollouts are dopri5
# all the same); tests/test_torch_port_ode.py holds the fit against JAX
NO_FIT = ["--NODE_fit_episode_limit", "-1"]


@pytest.fixture
def one_thread():
    """One intra-op thread: these runs are thousands of small ops, which
    other workers' threads slow down many times over (the dopri5 adjoint
    case took 3.7 s alone and 194 s in the 6-worker suite)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("extra", [
    ["--host_loop"], ["--wandb"], ["--tensorboard"],
    ["--node_solver", "dopri5"] + NO_FIT,
    ["--node_solver", "dopri5", "--node_adaptive_impl", "scan"] + NO_FIT,
    ["--node_solver", "dopri5", "--node_adaptive_impl", "scan",
     "--node_adaptive_scan_steps", "8", "--host_loop"] + NO_FIT,
], ids=["host_loop", "wandb", "tensorboard", "dopri5_while", "dopri5_scan",
        "dopri5_scan_host_loop"])
def test_ported_flags_train(extra, tmp_path, capsys, one_thread):
    """The flags that used to exit naming their ROADMAP.md item now train
    on the CPU; without the wandb package, --wandb prints one line and
    the run goes on with progress.txt."""
    # dopri5's updates are the dear part (an adjoint backward solve of
    # 65 trials a rollout, scripts/dopri5_probe.py), so its
    # episodes stop 2 steps after the first update
    steps = ["--max_episode_steps", "8"] if "dopri5" in extra else []
    cli.main(tiny_args("unicycle", tmp_path, "--max_episodes", "2",
                       *steps, *extra))
    run = run_dir(tmp_path)
    header, *rows = read_lines(os.path.join(run, "progress.txt"))
    assert len(rows) == 2 and "qf1_loss" in header.split("\t")
    assert float(rows[-1].split("\t")[header.split("\t").index(
        "updates")]) > 0
    for name in ("config.json", "checkpoint.npz") + WEIGHTS:
        assert os.path.isfile(os.path.join(run, name)), name
    with np.load(os.path.join(run, "checkpoint.npz")) as z:
        mode = json.loads(bytes(z["extra"]).decode())["mode"]
    assert mode == ("host_loop" if "--host_loop" in extra else "fused")
    out = capsys.readouterr().out
    if "--wandb" in extra and importlib.util.find_spec("wandb") is None:
        assert "wandb unavailable" in out
    if "--tensorboard" in extra and "tensorboard unavailable" not in out:
        assert os.listdir(os.path.join(run, "tb"))


@pytest.mark.parametrize("mode", [[], ["--host_loop"]],
                         ids=["fused", "host_loop"])
def test_short_integrations_warn_once_an_episode(mode, tmp_path, capsys,
                                                 one_thread):
    """With one trial step a solve, every scan-form dopri5 integration of
    an update ends short of dt: two a unicycle update (the primary and
    the backup loss's rollouts; the fit is off), and each driver adds
    them up from the updates' metrics into one warning line an episode."""
    cli.main(tiny_args("unicycle", tmp_path, "--max_episodes", "2",
                       "--max_episode_steps", "8", "--node_solver",
                       "dopri5", "--node_adaptive_impl", "scan",
                       "--node_adaptive_scan_steps", "1", *NO_FIT, *mode))
    header, *rows = read_lines(os.path.join(run_dir(tmp_path),
                                            "progress.txt"))
    col = header.split("\t").index("updates")
    updates = [int(float(r.split("\t")[col])) for r in rows]
    per_episode = [updates[0], updates[1] - updates[0]]
    assert per_episode[1] > 0
    warned = [line for line in capsys.readouterr().out.splitlines()
              if "ended short of dt" in line]
    assert warned == [f"\x1b[31mwarning: episode {i}: {2 * n} NODE "
                      "integrations ended short of dt (raise "
                      "--node_adaptive_scan_steps)\x1b[0m"
                      for i, n in enumerate(per_episode) if n > 0]


def test_host_loop_resume_continues_bit_for_bit(tmp_path):
    """cars under --host_loop (its resets draw from the shim's generator,
    which the checkpoint carries): 2 episodes then --resume for a third
    equal 3 uninterrupted episodes, row and state."""
    full, part = tmp_path / "full", tmp_path / "part"
    cli.main(tiny_args("cars", full, "--max_episodes", "3", "--host_loop"))
    cli.main(tiny_args("cars", part, "--max_episodes", "2", "--host_loop"))
    ckpt = os.path.join(run_dir(part), "checkpoint.npz")
    cli.main(tiny_args("cars", part, "--max_episodes", "3", "--host_loop",
                       "--resume", ckpt))
    runs = sorted(glob.glob(os.path.join(str(part), "*-run*", "*", "*_s*")))
    want = read_lines(os.path.join(run_dir(full), "progress.txt"))
    got = read_lines(os.path.join(runs[-1], "progress.txt"))
    assert got == [want[0], want[3]]
    with np.load(os.path.join(run_dir(full), "checkpoint.npz")) as a, \
            np.load(os.path.join(runs[-1], "checkpoint.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("extra,match", [
    (["--mode", "eval"], "training flag"),
    (["--dp", "2"], "single-seed, single-device"),
    (["--save_best", "reward"], "save_best"),
    (["--profile_dir", "trace"], "profile_dir"),
    (["--spawn_curriculum_episodes", "4"], "spawn curriculum"),
])
def test_host_loop_refusals(extra, match, tmp_path):
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match=match):
        cli.main(tiny_args("quadrotor", out, "--host_loop", *extra))
    assert not out.exists()
