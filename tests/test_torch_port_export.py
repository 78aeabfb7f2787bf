"""The port's policy export (``nlbac_tpu_torch/utils/export_policy.py``)
against the policy's own heads and against the JAX package's exported
artifact on the same weights, on the CPU.

The deterministic head, exported with a symbolic batch and loaded back
with ``torch.export.load``, matches ``det_action`` (the third output of
the port's samplers) and JAX's ``jax.export`` artifact at batch 1, 5 and
33, for both policy types: against ``det_action`` at atol 1e-6 (the
same ops; they agree bit for bit), against JAX at atol 1e-6 / rtol 1e-6:
the two libraries sum each layer in a different order, and one float32
ulp of an action of magnitude 8-12 is 9.5e-7 (the largest gap seen is
1.43e-6 on an action of 5.06, 2.8e-7 relative). The stochastic head,
given the standard-normal draw that JAX's sampler takes from its key,
matches the port's sampler of its policy type exactly and JAX's
stochastic artifact at the same atol 1e-6 / rtol 1e-6, for both policy
types. The manifest, the CLI (symbolic and static
batch) and serving from a process that imports only torch are checked
too.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state as j_create
from nlbac_tpu.utils import export_policy as jexport
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import create_train_state as t_create
from nlbac_tpu_torch.envs import unicycle as tuni
from nlbac_tpu_torch.interop import from_reference
from nlbac_tpu_torch.nn import (
    ActionSpec,
    deterministic_policy_sample,
    gaussian_policy_sample,
)
from nlbac_tpu_torch.train.checkpoint import save_model_weights
from nlbac_tpu_torch.utils import export_policy as texport

REPO = Path(__file__).resolve().parent.parent
ATOL = 1e-6
JAX_RTOL = 1e-6


def tiny_cfg(mod, policy_type="gaussian"):
    cfg = mod.get_config("unicycle")
    return dataclasses.replace(
        cfg, sac=dataclasses.replace(cfg.sac, hidden_dim=24,
                                     policy_type=policy_type))


def states(policy_type):
    cfg_j, cfg_t = tiny_cfg(jconfig, policy_type), tiny_cfg(tconfig,
                                                           policy_type)
    ts_j = j_create(cfg_j, jax.random.PRNGKey(2))
    ts_t = from_reference(jax.tree.map(np.asarray, ts_j), cfg_t, "cpu")
    return cfg_j, cfg_t, ts_j, ts_t


def obs_batch(n, seed=0):
    return np.random.default_rng(seed).normal(
        scale=2.0, size=(n, 7)).astype(np.float32)


SPEC = ActionSpec.from_bounds(tuni.SPEC.action_low, tuni.SPEC.action_high)


@pytest.mark.parametrize("policy_type", ["gaussian", "deterministic"])
def test_deterministic_round_trip_matches_det_action_and_jax(policy_type,
                                                             tmp_path):
    cfg_j, cfg_t, ts_j, ts_t = states(policy_type)
    path = str(tmp_path / "policy.pt2")
    texport.export_policy(cfg_t, ts_t, path)
    act, manifest = texport.load_policy(path)
    jexport.export_policy(cfg_j, ts_j, str(tmp_path / "policy.nlbac"))
    jact, _ = jexport.load_policy(str(tmp_path / "policy.nlbac"))
    sample = (gaussian_policy_sample if policy_type == "gaussian"
              else deterministic_policy_sample)
    for n in (1, 5, 33):
        obs = obs_batch(n, seed=n)
        got = act(torch.from_numpy(obs)).detach().numpy()
        with torch.no_grad():
            det = sample(ts_t.policy, torch.from_numpy(obs), SPEC,
                         noise=torch.zeros(n, 2))[2].numpy()
        assert got.shape == (n, 2)
        np.testing.assert_allclose(got, det, rtol=0, atol=ATOL)
        np.testing.assert_allclose(got, np.asarray(jact(obs)),
                                   rtol=JAX_RTOL, atol=ATOL)
    assert manifest["policy_type"] == policy_type


@pytest.mark.parametrize("policy_type", ["gaussian", "deterministic"])
def test_stochastic_head_takes_the_draw(policy_type, tmp_path):
    cfg_j, cfg_t, ts_j, ts_t = states(policy_type)
    path = str(tmp_path / "policy.pt2")
    texport.export_policy(cfg_t, ts_t, path, deterministic=False)
    act, manifest = texport.load_policy(path)
    jexport.export_policy(cfg_j, ts_j, str(tmp_path / "s.nlbac"),
                          deterministic=False)
    jact, _ = jexport.load_policy(str(tmp_path / "s.nlbac"))
    assert manifest["deterministic"] is False
    for n in (1, 9):
        obs = obs_batch(n, seed=10 + n)
        key = jax.random.PRNGKey(n)
        # the draw JAX's sampler takes from its key
        noise = np.array(jax.random.normal(key, (n, 2), jnp.float32))
        got = act(torch.from_numpy(obs),
                  torch.from_numpy(noise)).detach().numpy()
        sample = (gaussian_policy_sample if policy_type == "gaussian"
                  else deterministic_policy_sample)
        with torch.no_grad():
            want = sample(ts_t.policy, torch.from_numpy(obs), SPEC,
                          noise=torch.from_numpy(noise))[0]
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_allclose(got, np.asarray(jact(obs, key)),
                                   rtol=JAX_RTOL, atol=ATOL)


@pytest.mark.parametrize("batch", [None, 4])
def test_manifest_matches_reference_fields(batch, tmp_path):
    cfg_j, cfg_t, ts_j, ts_t = states("gaussian")
    texport.export_policy(cfg_t, ts_t, str(tmp_path / "p.pt2"), batch=batch)
    jexport.export_policy(cfg_j, ts_j, str(tmp_path / "p.nlbac"),
                          batch=batch)
    got = json.loads((tmp_path / "p.pt2.json").read_text())
    want = json.loads((tmp_path / "p.nlbac.json").read_text())
    assert got.pop("torch_version") == torch.__version__
    want.pop("jax_version")
    assert got == want
    assert not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("squash", ["xla", "torch"])
def test_export_moves_with_its_weights(squash, tmp_path):
    """An export traced on the CPU runs on another device after ``.to``:
    the XLA-form tanh's dtype conversions leave no check of the tracing
    device in the program, which the card would fail (``meta`` stands in
    for the card's run here; it skips such checks)."""
    cfg = tconfig.get_config("unicycle")
    ts = t_create(cfg, torch.Generator().manual_seed(0), "cpu")
    path = str(tmp_path / "p.pt2")
    texport.export_policy(cfg, ts, path, squash=squash)
    act, _ = texport.load_policy(path)
    assert not [n for n in act.graph.nodes if n.target is
                torch.ops.aten._assert_tensor_metadata.default]
    out = act.to("meta")(torch.zeros(3, cfg.obs_dim, device="meta"))
    assert out.device.type == "meta" and out.shape == (3, cfg.action_dim)


def test_cli_exports_a_run_dir(tmp_path):
    """``main`` on a run directory at the preset's widths: the symbolic
    export takes any batch, the static one only its own."""
    cfg = tconfig.get_config("unicycle")
    ts = t_create(cfg, torch.Generator().manual_seed(0), "cpu")
    save_model_weights(str(tmp_path), ts)
    texport.main([str(tmp_path), "--preset", "unicycle", "--cpu"])
    act, manifest = texport.load_policy(str(tmp_path / "policy.pt2"))
    assert manifest["batch"] is None and manifest["obs_dim"] == 7
    obs = torch.from_numpy(obs_batch(3))
    with torch.no_grad():
        det = gaussian_policy_sample(ts.policy, obs, SPEC,
                                     noise=torch.zeros(3, 2))[2]
    torch.testing.assert_close(act(obs), det, rtol=0, atol=ATOL)
    texport.main([str(tmp_path), "--preset", "unicycle", "--cpu",
                  "--batch", "4", "-o", str(tmp_path / "b4.pt2")])
    act4, manifest4 = texport.load_policy(str(tmp_path / "b4.pt2"))
    assert manifest4["batch"] == 4
    assert act4(torch.zeros(4, 7)).shape == (4, 2)
    with pytest.raises(Exception):
        act4(torch.zeros(5, 7))


def test_serving_needs_only_torch(tmp_path):
    _, cfg_t, _, ts_t = states("gaussian")
    path = tmp_path / "policy.pt2"
    texport.export_policy(cfg_t, ts_t, str(path))
    obs = obs_batch(6)
    np.save(tmp_path / "obs.npy", obs)
    code = (
        "import sys, numpy as np, torch\n"
        f"act = torch.export.load({str(path)!r}).module()\n"
        f"a = act(torch.from_numpy(np.load({str(tmp_path / 'obs.npy')!r})))\n"
        f"np.save({str(tmp_path / 'act.npy')!r}, a.detach().numpy())\n"
        "bad = [m for m in sys.modules if m.startswith(('nlbac', 'jax'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    with torch.no_grad():
        det = gaussian_policy_sample(ts_t.policy, torch.from_numpy(obs),
                                     SPEC, noise=torch.zeros(6, 2))[2]
    np.testing.assert_allclose(np.load(tmp_path / "act.npy"), det.numpy(),
                               rtol=0, atol=ATOL)
