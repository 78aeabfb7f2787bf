"""The port's small utilities against the JAX package's, on the CPU: the
renderer (frames pixel-equal to JAX's for the same states), the video
writer, the plotter on a port run, ``ExperimentGrid`` (the same variants
and names from the same axes; a tiny ``run_all``), the subprocess entry
point, and ``utils.math`` (rtol 1e-6 / atol 1e-6: float32 on both sides,
the same formulas). A fresh process that imports every new port module
has no ``jax``, ``jaxlib`` or ``nlbac_tpu*`` module loaded.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.envs import render as jrender
from nlbac_tpu.utils import grid as jgrid
from nlbac_tpu.utils import math as jmath
from nlbac_tpu.utils import plot as jplot
from nlbac_tpu.utils import run_entrypoint as jentry
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.envs import render as trender
from nlbac_tpu_torch.utils import grid as tgrid
from nlbac_tpu_torch.utils import math as tmath
from nlbac_tpu_torch.utils import plot as tplot
from nlbac_tpu_torch.utils import run_entrypoint as tentry

REPO = Path(__file__).resolve().parent.parent
RENDER_STATES = {
    "unicycle": np.array([-1.2, 0.4, 0.7], np.float32),
    "pvtol": np.array([1.5, -2.0, 0.3, 0.1, -0.2, 1.1, 1.0], np.float32),
    "cars": np.array([42.0, 3.1, 33.5, 2.9, 26.2, 3.0, 17.0, 3.3, 10.4, 2.7,
                      0.0, 0.0], np.float32),
    "quadrotor": np.array([-0.4, 0.2, 1.1, -0.1, 0.25, 0.0], np.float32),
}


def tiny_cfg(mod, preset="unicycle", episodes=1, steps=20):
    cfg = mod.get_config(preset)
    return dataclasses.replace(
        cfg,
        env=dataclasses.replace(cfg.env, max_episode_steps=steps),
        sac=dataclasses.replace(cfg.sac, hidden_dim=8, batch_size=8,
                                start_steps=10),
        node=dataclasses.replace(cfg.node, hidden_dim=8, f_hidden_layers=1,
                                 g_hidden_layers=1, max_batch=16),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64),
        run=dataclasses.replace(cfg.run, max_episodes=episodes))


@pytest.mark.parametrize("env", sorted(RENDER_STATES))
def test_render_frames_are_pixel_equal_to_reference(env):
    state = RENDER_STATES[env]
    traj = np.stack([state * (1.0 - 0.1 * i) for i in range(5)])
    got = trender.render(env, state, trajectory=traj)
    want = jrender.render(env, state, trajectory=traj)
    assert got.dtype == np.uint8 and got.ndim == 3 and got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="no renderer"):
        trender.render("pointmass", state)


def test_save_video_writes_a_gif(tmp_path):
    frames = [trender.render("unicycle", RENDER_STATES["unicycle"] + i)
              for i in range(3)]
    out = trender.save_video(frames, str(tmp_path / "clip.gif"), fps=5)
    assert out == str(tmp_path / "clip.gif") and os.path.getsize(out) > 0


def test_plot_reads_a_port_run(tmp_path):
    from nlbac_tpu_torch.train.cli import train

    for seed in (0, 1):
        cfg = tiny_cfg(tconfig, episodes=2)
        cfg = dataclasses.replace(cfg, run=dataclasses.replace(cfg.run,
                                                               seed=seed))
        train(cfg, output_dir=str(tmp_path / "runs" / f"s{seed}"),
              quiet=True, device="cpu")
    got = tplot.get_datasets(str(tmp_path / "runs"))
    want = jplot.get_datasets(str(tmp_path / "runs"))
    assert [d["dir"] for d in got] == [d["dir"] for d in want]
    for a, b in zip(got, want):
        assert a["exp_name"] == b["exp_name"]
        assert list(a["progress"]) == list(b["progress"])
        for k in a["progress"]:
            np.testing.assert_array_equal(a["progress"][k],
                                          b["progress"][k])
    out = tmp_path / "plot.png"
    tplot.main([str(tmp_path / "runs"), "--value", "reward_train",
                "--smooth", "2", "--out", str(out)])
    assert out.stat().st_size > 0


def _grid(mod):
    g = mod.ExperimentGrid("sweep", base="unicycle")
    g.add("constraint.gamma_b", [20.0, 50.0])
    g.add("sac.batch_size", [128, 256], shorthand="bs")
    g.add("sac.gamma", 0.98)
    return g


def test_experiment_grid_matches_reference():
    tg, jg = _grid(tgrid), _grid(jgrid)
    assert tg.variants() == jg.variants()
    got = [(n, c.to_dict()) for n, c in tg.variant_configs()]
    want = [(n, c.to_dict()) for n, c in jg.variant_configs()]
    assert got == want and len(got) == 4
    assert tg.print_table() == jg.print_table()
    for mod in (tgrid, jgrid):
        with pytest.raises(ValueError, match="already added"):
            _grid(mod).add("sac.gamma", [0.9])
        with pytest.raises(TypeError):
            mod.ExperimentGrid("x").add("sac.no_such_field", [1])


def test_run_all_trains_every_variant_on_the_cpu(tmp_path):
    g = tgrid.ExperimentGrid("tiny", base=tiny_cfg(tconfig))
    g.add("sac.gamma", [0.99, 0.9])
    results = g.run_all(output_dir=str(tmp_path), device="cpu")
    assert sorted(results) == ["tiny_gam0.9", "tiny_gam0.99"]
    for name in results:
        assert (tmp_path / name / "progress.txt").is_file()
    seen = g.run_all(run_fn=lambda cfg, output_dir, **kw: (cfg.sac.gamma,
                                                           output_dir, kw),
                     output_dir="o", quiet=True)
    assert seen["tiny_gam0.9"] == (0.9, os.path.join("o", "tiny_gam0.9"),
                                   {"quiet": True})


def test_run_entrypoint_round_trip_and_subprocess(tmp_path):
    cfg = tiny_cfg(tconfig)
    payload = tentry.encode_experiment(cfg, output_dir=str(tmp_path / "r"),
                                       device="cpu", quiet=True)
    back, kwargs = tentry.decode_experiment(payload)
    assert back == cfg and kwargs == {"output_dir": str(tmp_path / "r"),
                                      "device": "cpu", "quiet": True}
    jcfg, jkw = jentry.decode_experiment(jentry.encode_experiment(
        tiny_cfg(jconfig), output_dir="x"))
    assert jcfg.to_dict() == back.to_dict() and jkw == {"output_dir": "x"}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run(
        [sys.executable, "-m", "nlbac_tpu_torch.utils.run_entrypoint",
         payload], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert (tmp_path / "r" / "progress.txt").is_file()


def test_math_matches_reference():
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, size=(5, 2)).astype(np.float32)
    low, high = (-3.5, -12.0), (3.5, 12.0)
    theta = rng.uniform(-10, 10, size=5).astype(np.float32)
    vec = rng.normal(size=(5, 2)).astype(np.float32)
    ta, tt, tv = (torch.from_numpy(x) for x in (a, theta, vec))
    pairs = [
        (tmath.scale_action(ta, low, high), jmath.scale_action(a, low, high)),
        (tmath.unscale_action(ta * 3, low, high),
         jmath.unscale_action(a * 3, low, high)),
        (tmath.rot_2d(tt), jmath.rot_2d(theta)),
        (tmath.rotate(tv, tt), jmath.rotate(vec, theta)),
        (tmath.wrap_angle(tt), jmath.wrap_angle(theta)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)
    assert jnp.asarray(pairs[2][1]).shape == (5, 2, 2)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import nlbac_tpu_torch.utils, nlbac_tpu_torch.utils.evaluate\n"
        "import nlbac_tpu_torch.utils.export_policy\n"
        "import nlbac_tpu_torch.utils.grid, nlbac_tpu_torch.utils.plot\n"
        "import nlbac_tpu_torch.utils.run_entrypoint\n"
        "import nlbac_tpu_torch.utils.math, nlbac_tpu_torch.envs.render\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'jaxlib',"
        " 'optax') or m.startswith(('jax.', 'jaxlib.', 'nlbac_tpu.')))\n"
        "assert not bad, bad\n"
        "print('isolated')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "isolated"
