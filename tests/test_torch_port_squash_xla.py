"""The XLA-form squash (``squash="xla"``, ``nn/xla_float.py``), port against
the JAX package, on the CPU.

(a) ``xla_tanh`` equals ``jnp.tanh`` bit for bit on a float32 grid of
    2,000,001 points over [-10, 10], on every float32 in [7.9988, 7.9989]
    (where XLA's tanh reaches +-1, from 7.9988117) and within 5000 ulps of
    +-0.0004 (where it switches to x). Its Horner steps round the float64
    sum of an exact product once to float32; each equals an exact fused
    multiply-add (``fma_f32``) on 200,000 float32 drawn over [0.0003,
    8.5) here (all 124,434,094 of them in a one-off check on this CPU).
(b) Its gradient equals jitted ``jax.vjp(jnp.tanh)`` bit for bit on the
    same points, for seeded normal cotangents.
(c) One update of unicycle and of PVTOL at tiny widths, with the policies'
    mean heads biased so that 33-34 of each update's 36 samples lie at
    pre-tanh 5-10 (past XLA's saturation at 7.9988 for some), against
    JAX's jitted ``update_from_batch`` with the same draws. Tolerance:
    every metric within rtol 2e-3, every leaf of the state within 5e-3 of
    the leaf's largest entry. Measured: metrics 1.5e-4 (unicycle) and
    4.9e-4 (PVTOL), leaves 9.7e-4 and 1.2e-3: near saturation one ulp of
    a pre-tanh value moves XLA's squash term by up to 0.27 nats, and the
    two libraries' products round the pre-tanh values apart by ulps, which
    Adam's first step turns into whole steps on the smallest gradients.
    With ``torch.tanh`` the same update leaves JAX by 2.1e-2 and 3.0e-2
    (metrics) and 2.0 (leaves), which the case also checks.
(d) The squash is the port's default: a CLI run without ``--squash``
    trains under it and records it. ``--squash torch`` reaches the agent
    of the CLI's run, of an ``--n_seeds`` worker's seeds and of the
    lockstep; the run's checkpoint and weights record it, a ``--resume``
    under the other squash is refused, one under the same squash
    continues, and ``--mode eval`` refuses a squash other than the
    weights'. An archive and a weights directory that record no squash
    (as every one written before the default moved) read as ``torch``: the
    archive resumes only under ``--squash torch``, and evaluation (the
    CLI's and ``utils.evaluate``'s) and export follow the directory's
    record, or ``torch`` without one.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import from_reference, to_reference
from nlbac_tpu_torch.nn import DEFAULT_SQUASH, gaussian_policy_forward
from nlbac_tpu_torch.nn.xla_float import (
    XLA_TANH_CLAMP,
    XLA_TANH_TINY,
    _DENOMINATOR,
    _NUMERATOR,
    fma_f32,
    xla_tanh,
    xla_tanh_values,
)
from nlbac_tpu_torch.parallel import seeds as seeds_lib
from nlbac_tpu_torch.train import checkpoint as ckpt
from nlbac_tpu_torch.train import cli, driver
from nlbac_tpu_torch.utils import evaluate, export_policy
from test_torch_port_presets import leaves_with_paths, resample_draws
from test_torch_port_presets import make_batch as preset_batch
from test_torch_port_presets import tiny_cfg as preset_cfg
from test_torch_port_update import make_batch as unicycle_batch
from test_torch_port_update import tiny_cfg as unicycle_cfg

BATCH, NODE_BATCH = 6, 8
TINY_ULPS = 5000
METRIC_RTOL, LEAF_FRAC = 2e-3, 5e-3
# the policies' mean-head biases (the backup policy's negated): the
# samples' pre-tanh values then lie around +-7
MEAN_BIAS = (7.0, -7.5)


def bits(x):
    return np.asarray(x).view(np.int32)


def points():
    grid = np.linspace(-10.0, 10.0, 2000001, dtype=np.float32)
    sat = np.arange(np.float32(7.9988).view(np.int32),
                    np.float32(7.9989).view(np.int32) + 1,
                    dtype=np.int32).view(np.float32)
    t = np.float32(XLA_TANH_TINY).view(np.int32)
    tiny = np.arange(t - TINY_ULPS, t + TINY_ULPS + 1,
                     dtype=np.int32).view(np.float32)
    return np.concatenate([grid, sat, -sat, tiny, -tiny])


def test_forward_matches_jnp_tanh():
    x = points()
    want = np.asarray(jax.jit(jnp.tanh)(x))
    got = xla_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(got), bits(want))
    saturated = np.abs(x[np.abs(got) == 1.0])
    assert saturated.min() == np.float32(XLA_TANH_CLAMP)


def test_horner_steps_are_exact_fmas():
    rng = np.random.default_rng(0)
    lo, hi = (np.float32(v).view(np.int32) for v in (0.0003, 8.5))
    x = torch.from_numpy(rng.integers(lo, hi, 200000, dtype=np.int32)
                         .view(np.float32))

    def horner(x2, coefficients):
        p = torch.full_like(x2, coefficients[0])
        for c in coefficients[1:]:
            p = fma_f32(x2, p, torch.full_like(x2, c))
        return p

    xc = torch.clamp(x, -XLA_TANH_CLAMP, XLA_TANH_CLAMP)
    x2 = xc * xc
    exact = horner(x2, _NUMERATOR) * xc / horner(x2, _DENOMINATOR)
    exact = torch.where(x.abs() < XLA_TANH_TINY, x, exact)
    np.testing.assert_array_equal(bits(xla_tanh_values(x).numpy()),
                                  bits(exact.numpy()))


def test_gradient_matches_jitted_vjp():
    x = points()
    g = np.random.default_rng(1).standard_normal(x.size).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda x, g: jax.vjp(jnp.tanh, x)[1](g)[0])(x, g))
    xt = torch.from_numpy(x).requires_grad_()
    xla_tanh(xt).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(bits(xt.grad.numpy()), bits(want))


def saturated(ts):
    """``ts`` with both policies' mean-head biases at +-MEAN_BIAS."""
    def biased(policy, sign):
        n = policy["mean"]["b"][0].shape[0]
        b = jnp.asarray(sign * np.array(MEAN_BIAS[:n], np.float32))
        return {**policy, "mean": {"w": policy["mean"]["w"], "b": [b]}}

    return ts._replace(policy=biased(ts.policy, 1),
                       backup_policy=biased(ts.backup_policy, -1))


@pytest.mark.parametrize("preset", ["unicycle", "pvtol"])
def test_update_with_saturated_samples_matches_reference(preset):
    if preset == "unicycle":
        cfg_j, cfg_t = unicycle_cfg(jconfig), unicycle_cfg(tconfig)

        def batch_of(rng, n):
            return unicycle_batch(rng, n)
    else:
        cfg_j, cfg_t = preset_cfg(jconfig, preset), preset_cfg(tconfig,
                                                               preset)

        def batch_of(rng, n):
            return preset_batch(preset, rng, n)
    n_u = cfg_j.action_dim
    rng = np.random.default_rng(0)
    ts = saturated(create_train_state(cfg_j, jax.random.PRNGKey(0)))
    batch, node_batch = batch_of(rng, BATCH), batch_of(rng, NODE_BATCH)
    key = jax.random.PRNGKey(7)
    ts_j, m_j = jax.jit(make_agent(cfg_j).update_from_batch)(
        ts, batch, node_batch, key, jnp.int32(0))
    # the reference draws from split(key, 8): [2] the TD-target sample,
    # [3] the policy-loss sample, [4] the primary resamples, [5] the
    # backup-loss sample, [6] the backup resamples
    keys = jax.random.split(key, 8)
    noise = {name: torch.tensor(np.asarray(
        jax.random.normal(keys[i], (BATCH, n_u), jnp.float32)))
        for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    if preset == "pvtol":
        noise["resample"] = resample_draws(preset, keys[4], BATCH, n_u)
        noise["backup_resample"] = resample_draws(preset, keys[6], BATCH,
                                                  n_u)
    ref = jax.tree.map(np.asarray, ts)
    tb = {k: torch.tensor(v) for k, v in batch.items()}
    tnb = {k: torch.tensor(v) for k, v in node_batch.items()}
    expect = jax.tree.map(np.asarray, ts_j)

    gaps = {}
    for squash in ("xla", "torch"):
        port = from_reference(ref, cfg_t, "cpu")
        if squash == "xla":
            with torch.no_grad():
                u = torch.cat([
                    (m + torch.exp(s) * noise[name]).abs().flatten()
                    for policy, obs, name in (
                        (port.policy, tb["next_obs"], "next"),
                        (port.policy, tb["obs"], "pi"),
                        (port.backup_policy, tb["obs"], "backup"))
                    for m, s in [gaussian_policy_forward(policy, obs)]])
            assert int(((u >= 5) & (u <= 10)).sum()) >= 30, u
            assert float(u.max()) > XLA_TANH_CLAMP
        agent = t_make_agent(cfg_t, "cpu", squash=squash)
        port, m_t = agent.update_core(port, tb, lambda: tnb, None, 0,
                                      noise=noise)
        metric = max(abs(float(m_t[k]) - float(m_j[k]))
                     / (1e-6 + abs(float(m_j[k]))) for k in METRIC_NAMES)
        got = to_reference(port, expect)
        leaf = max(float(np.abs(b - a).max() / np.abs(a).max())
                   for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                               leaves_with_paths(got))
                   if a.size and np.abs(a).max() > 0)
        gaps[squash] = (metric, leaf)
    assert gaps["xla"][0] < METRIC_RTOL and gaps["xla"][1] < LEAF_FRAC, gaps
    assert gaps["torch"][1] > 20 * LEAF_FRAC, gaps


TINY = ["--preset", "unicycle", "--cpu", "--quiet", "--max_episode_steps",
        "20", "--batch_size", "8", "--start_steps", "6", "--hidden_size",
        "8", "--replay_size", "100"]


def watch_agents(monkeypatch):
    """The squash of every agent the driver makes, in order."""
    made = []
    real = driver.make_agent

    def watched(*args, **kw):
        agent = real(*args, **kw)
        made.append(agent.squash)
        return agent

    monkeypatch.setattr(driver, "make_agent", watched)
    return made


def only_run(root):
    (run,) = root.glob("*-run*/*/*_s*")
    return run


def test_default_squash_is_xla_and_recorded(tmp_path, monkeypatch):
    made = watch_agents(monkeypatch)
    assert DEFAULT_SQUASH == "xla"
    assert t_make_agent(unicycle_cfg(tconfig), "cpu").squash == "xla"
    cli.main(TINY + ["--max_episodes", "1", "--output", str(tmp_path)])
    run = only_run(tmp_path)
    assert made == ["xla"]
    assert json.loads((run / "squash.json").read_text()) == {"squash": "xla"}
    with np.load(run / "checkpoint.npz") as z:
        assert ckpt.checkpoint_squash(z) == "xla"


def test_squash_reaches_every_agent_and_the_records(tmp_path, monkeypatch):
    made = watch_agents(monkeypatch)
    cli.main(TINY + ["--max_episodes", "1", "--squash", "torch",
                     "--output", str(tmp_path / "a")])
    run = only_run(tmp_path / "a")
    assert made == ["torch"]
    assert ckpt.weights_squash(str(run)) == "torch"
    with np.load(run / "checkpoint.npz") as z:
        assert ckpt.checkpoint_squash(z) == "torch"
    with pytest.raises(ValueError, match="--squash torch, not xla"):
        cli.main(TINY + ["--max_episodes", "2", "--output",
                         str(tmp_path / "b"), "--resume",
                         str(run / "checkpoint.npz")])
    cli.main(TINY + ["--max_episodes", "2", "--squash", "torch", "--output",
                     str(tmp_path / "c"), "--resume",
                     str(run / "checkpoint.npz")])
    assert made[-1] == "torch"
    with pytest.raises(SystemExit, match="--squash torch"):
        cli.main(TINY + ["--mode", "eval", "--squash", "xla",
                         "--output", str(run)])

    # an --n_seeds worker's seeds (held in this process here) and the
    # lockstep
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        TINY + ["--max_episodes", "1"]))
    seeds_lib._Seeds(cfg, [(0, 3)], "torch").start(torch.device("cpu"))
    assert made[-1] == "torch"
    lockstep = []
    real_lockstep = parallel.lockstep.make_agent
    monkeypatch.setattr(parallel.lockstep, "make_agent",
                        lambda *a, **kw: lockstep.append(kw) or
                        real_lockstep(*a, **kw))
    parallel.make_seed_parallel_runner(
        dataclasses.replace(cfg), 2, "cpu", squash="torch")
    assert lockstep == [{"squash": "torch"}]
    with pytest.raises(ValueError, match="squash"):
        t_make_agent(cfg, "cpu", squash="tanh")
    assert json.loads((run / "squash.json").read_text()) == {
        "squash": "torch"}


def unrecord(run):
    """Strip ``run``'s squash records, as a run from before they were
    kept for ``torch`` left it."""
    (run / "squash.json").unlink()
    path = run / "checkpoint.npz"
    with np.load(path) as z:
        arrays = dict(z)
    extra = json.loads(bytes(arrays["extra"]).decode())
    del extra["squash"]
    arrays["extra"] = np.frombuffer(json.dumps(extra).encode(), np.uint8)
    np.savez(path, **arrays)


def test_unrecorded_runs_read_as_torch(tmp_path, monkeypatch):
    made = watch_agents(monkeypatch)
    cli.main(TINY + ["--max_episodes", "1", "--squash", "torch",
                     "--output", str(tmp_path / "a")])
    run = only_run(tmp_path / "a")
    unrecord(run)
    assert ckpt.weights_squash(str(run)) == "torch"
    with np.load(run / "checkpoint.npz") as z:
        assert ckpt.checkpoint_squash(z) == "torch"
    for args in ([], ["--squash", "xla"]):
        with pytest.raises(ValueError, match="resume it with --squash "
                                             "torch, not xla"):
            cli.main(TINY + ["--max_episodes", "2", "--output",
                             str(tmp_path / "b"), "--resume",
                             str(run / "checkpoint.npz")] + args)
    cli.main(TINY + ["--max_episodes", "2", "--squash", "torch", "--output",
                     str(tmp_path / "c"), "--resume",
                     str(run / "checkpoint.npz")])
    assert made[-1] == "torch"
    resumed = only_run(tmp_path / "c")
    assert json.loads((resumed / "squash.json").read_text()) == {
        "squash": "torch"}

    # evaluation and export follow a directory's record, torch without one
    seen = []
    monkeypatch.setattr(evaluate, "run_policy",
                        lambda *a, squash, **kw: seen.append(squash) or [])
    monkeypatch.setattr(evaluate, "load_trained_state", lambda *a: None)
    monkeypatch.setattr(export_policy, "export_policy",
                        lambda *a, squash, **kw: seen.append(squash))
    xla_run = tmp_path / "xla"
    xla_run.mkdir()
    (xla_run / "squash.json").write_text(json.dumps({"squash": "xla"}))
    for d in (run, xla_run):
        cli.main(TINY + ["--mode", "eval", "--output", str(d)])
        evaluate.main([str(d), "--preset", "unicycle", "--cpu"])
        export_policy.main([str(d), "--preset", "unicycle", "--cpu"])
    assert seen == ["torch"] * 3 + ["xla"] * 3
