"""The lockstep seed runner's seed-batched parts over every preset, on the
CPU, against the JAX package:

(a) one seed-batched ``update_from_batch`` against ``jax.vmap`` of JAX's
    ``update_from_batch`` for ``cars``, ``pvtol``, ``nbc_unicycle``,
    ``nbc_pvtol`` and ``quadrotor`` (both pre-tanh regularizers on), and
    for the unicycle with a two-step Euler NODE and with a bf16 NODE
    (JAX's update compiled without excess precision): three seeds at
    different counters, so that the NODE fit, the multiplier ascent, the
    target update and the backup branch (where the preset trains one)
    differ between them, the states carried across by
    ``from_reference_stacked``, every draw injected;
(b) the ``cars_gap`` and ``pvtol`` supervisor machines stacked over 3
    seeds against 3 one-seed calls on the scripted inputs of
    ``test_torch_port_presets.py`` (two seeds a few steps late), bit for
    bit.

Each seed's draws come from its own JAX key, as the reference's
``split(key, 8)`` hands them out (``test_torch_port_gates.py``), and the
key is, of PRNGKey(100 + i + 1000 j) for j < 100, the one whose largest
TD-target, policy or backup sample is least in pre-tanh magnitude, which
must be below 3 (``out_of_band_key``'s bound), where the two libraries'
tanh-squash terms agree. PVTOL's policies at these seeds and batches put
some row's mean near 3 (for some seeds no key keeps every sample below
3), so the PVTOL family's bound is 5 and it takes PVTOL's tolerances,
which ``test_torch_port_presets.py`` sets for a sample at pre-tanh -4.96
(policy_loss 1.09e-5 relative apart). The first key below 5 is not
enough there: at seed 2's the one-seed port's own policy_loss parts from
JAX's beyond rtol 1e-4, as the seed-batched one's does.

Tolerances: the single-update tests' (``test_torch_port_update.py``,
``test_torch_port_nbc.py``): metrics rtol 1e-5 / atol 1e-6; parameters,
Adam moments and the Lagrangian state rtol 1e-4 / atol 1e-6. PVTOL and
nbc_pvtol take ``test_torch_port_gates.py``'s ``TOL["pvtol"]`` (metrics
rtol 1e-4, state atol 1e-5): PVTOL's thrust scale of 15 and its float32
conditioning (``test_torch_port_presets.py``'s note).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu import config as jconfig
from nlbac_tpu.agent import create_train_state, make_agent
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.agent import make_agent as t_make_agent
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.interop import (
    from_reference,
    from_reference_stacked,
    to_reference_stacked,
)
from nlbac_tpu_torch.train import supervisor as tsup
from test_torch_port_gates import PRE_TANH_MAX, TOL, pre_tanh_max
from test_torch_port_lockstep import as_numpy, stack_trees, take
from test_torch_port_nbc import make_batch as nbc_batch
from test_torch_port_presets import leaves_with_paths, resample_draws
from test_torch_port_presets import make_batch as preset_batch
from test_torch_port_update import make_batch as unicycle_batch

S = 3
BATCH, NODE_BATCH = 6, 8
# each seed's updates before the compared one, and the gates there (fit
# every 3rd update, ascent every 4th, target every 2nd, backup every
# 5th): seed 0 all four; seed 1 none; seed 2 the ascent and the target
COUNTERS = (0, 1, 4)
PRESETS = ("cars", "pvtol", "nbc_unicycle", "nbc_pvtol", "quadrotor")
# the PVTOL family's bound on the samples' pre-tanh magnitude (the
# module's note)
PVTOL_PRE_TANH_MAX = 5.0
# the update's regularizers: the quadrotor's both
PRETANH = {"quadrotor": dict(pretanh_reg=0.05, probe_pretanh_reg=0.2)}


@pytest.fixture(autouse=True)
def one_thread():
    """Many small ops: one intra-op thread, as the dopri5 tests run."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def gated_cfg(mod, preset, **node_kw):
    cfg = mod.get_config(preset)
    return dataclasses.replace(
        cfg,
        node=dataclasses.replace(cfg.node, hidden_dim=12, f_hidden_layers=2,
                                 g_hidden_layers=2, mlp_hidden_layers=2,
                                 max_batch=NODE_BATCH, update_interval=3,
                                 **node_kw),
        sac=dataclasses.replace(cfg.sac, hidden_dim=24, batch_size=BATCH,
                                target_update_interval=2,
                                **PRETANH.get(preset, {})),
        constraint=dataclasses.replace(cfg.constraint,
                                       lambda_update_interval=4,
                                       backup_update_interval=5),
        replay=mod.ReplayConfig(capacity=64, node_capacity=64))


def batches(preset, rng, n):
    if preset == "unicycle":
        return unicycle_batch(rng, n)
    if preset in ("cars", "pvtol"):
        return preset_batch(preset, rng, n)
    return nbc_batch(preset, rng, n)


def draws(cfg, key):
    """The reference's draws from split(key, 8): [2] the TD-target sample,
    [3] the policy-loss sample, [4] the primary resamples, [5] the
    backup-loss sample, [6] the backup resamples (PVTOL's chain splits
    its key for two, the other builders draw one with the key itself;
    the unicycle's none)."""
    n_u = cfg.action_dim
    keys = jax.random.split(key, 8)
    noise = {name: torch.tensor(np.asarray(
        jax.random.normal(keys[i], (BATCH, n_u), jnp.float32)))
        for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    kind = cfg.constraint.kind
    if kind != "unicycle":
        chain = "pvtol" if kind == "pvtol" else "cars"
        noise["resample"] = resample_draws(chain, keys[4], BATCH, n_u)
        noise["backup_resample"] = resample_draws(chain, keys[6], BATCH, n_u)
    return noise


def out_of_band(cfg_t, port, batch, i, bound):
    """Seed i's key and draws: of PRNGKey(100 + i + 1000 j), j < 100, the
    one whose samples' largest pre-tanh magnitude is least; it must be
    below ``bound``."""
    best = None
    for j in range(100):
        key = jax.random.PRNGKey(100 + i + 1000 * j)
        noise = draws(cfg_t, key)
        worst = pre_tanh_max(port, batch, noise)
        if best is None or worst < best[0]:
            best = (worst, key, noise)
    assert best[0] < bound, f"seed {i}: no key keeps the samples below " \
        f"{bound} (best {best[0]:.3f})"
    return best[1], best[2]


def seeds_at_counters(cfg_j, preset, rng):
    """Three seeds, seed i after COUNTERS[i] updates of its own (the
    vmapped reference update, run max(COUNTERS) times on fresh batches),
    stacked; with the vmapped update."""
    vupdate = jax.jit(jax.vmap(make_agent(cfg_j).update_from_batch,
                               in_axes=(0, 0, 0, 0, None)))
    keys = jax.random.split(jax.random.PRNGKey(0), S)
    ts = jax.vmap(lambda k: create_train_state(cfg_j, k))(keys)
    history = [ts]
    for k in range(max(COUNTERS)):
        ts, _ = vupdate(
            ts, stack_trees([batches(preset, rng, BATCH) for _ in range(S)]),
            stack_trees([batches(preset, rng, NODE_BATCH)
                         for _ in range(S)]),
            jax.random.split(jax.random.PRNGKey(50 + k), S), jnp.int32(0))
        history.append(ts)
    ts = stack_trees([take(history[n], i) for i, n in enumerate(COUNTERS)])
    assert np.asarray(ts.updates).tolist() == list(COUNTERS)
    return ts, vupdate


def check_seed_batched_update(preset, exact_rounding=False, bf16_leaves=(),
                              float32_fails=False, **node_kw):
    """The port's seed-batched update against ``jax.vmap`` of JAX's
    ``update_from_batch``, ``jax.jit``-compiled (with
    ``exact_rounding``, without XLA's excess precision, so that each
    bf16 op rounds as it does run op by op). A state leaf whose path holds one of ``bf16_leaves`` is
    held, seed by seed, within one bf16 ulp (2**-7) of the seed's largest
    entry of it. With ``float32_fails``, the port's update with a float32
    NODE, from the same states and draws, must fail the same checks."""
    cfg_j = gated_cfg(jconfig, preset, **node_kw)
    cfg_t = gated_cfg(tconfig, preset, **node_kw)
    bound = PVTOL_PRE_TANH_MAX if "pvtol" in preset else PRE_TANH_MAX
    rng = np.random.default_rng(2)
    ts, vupdate = seeds_at_counters(cfg_j, preset, rng)

    batch = [batches(preset, rng, BATCH) for _ in range(S)]
    node_batch = [batches(preset, rng, NODE_BATCH) for _ in range(S)]
    ref = as_numpy(ts)
    noise, step_keys = [], []
    for i in range(S):
        port_i = from_reference(take(ref, i), cfg_t, "cpu")
        tb = {k: torch.tensor(v) for k, v in batch[i].items()}
        key, drawn = out_of_band(cfg_t, port_i, tb, i, bound)
        step_keys.append(key)
        noise.append(drawn)

    args = (ts, stack_trees(batch), stack_trees(node_batch),
            jnp.stack(step_keys), jnp.int32(1))
    if exact_rounding:
        vupdate = vupdate.lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
    ts_j, m_j = vupdate(*args)

    def stacked(dicts):
        return {k: torch.stack([torch.tensor(np.asarray(d[k]))
                                for d in dicts])
                for k in dicts[0]}

    # a resample draw is (S, B, n_u) per chain step, the seeds stacked
    # inside each step
    draw = {k: (torch.stack([d[k] for d in noise], dim=1)
                if k in ("resample", "backup_resample")
                else torch.stack([d[k] for d in noise]))
            for k in noise[0]}
    m_t = check_port(cfg_t, ref, stacked(batch), stacked(node_batch), draw,
                     ts_j, m_j, bf16_leaves)
    if float32_fails:
        f32 = dataclasses.replace(cfg_t, node=dataclasses.replace(
            cfg_t.node, compute_dtype=None))
        with pytest.raises(AssertionError, match="Not equal to tolerance"):
            check_port(f32, ref, stacked(batch), stacked(node_batch), draw,
                       ts_j, m_j, bf16_leaves)
    return m_t


def check_port(cfg_t, ref, batch, node_batch, draw, ts_j, m_j,
               bf16_leaves):
    """The port's seed-batched update of ``ref`` against the reference's
    ``ts_j``/``m_j`` (``check_seed_batched_update``'s note)."""
    metric_rtol, atol = TOL["pvtol" if "pvtol" in cfg_t.env.name
                            else "unicycle"]
    port = from_reference_stacked(ref, cfg_t, S, "cpu")
    agent = t_make_agent(cfg_t, "cpu")
    lam_before = port.lag.lam.clone()
    backup_before = port.lag.backup_lam.clone()
    target_before = port.critic_target["q1"]["w"][0].clone()
    port, m_t = agent.update_from_batch(port, batch, node_batch, None, 1,
                                        noise=draw)

    # the gates differ across the seeds as planned
    assert (np.asarray(m_j["node_loss"]) > 0).tolist() == [True, False,
                                                            False]
    assert [not torch.equal(port.lag.lam[i], lam_before[i])
            for i in range(S)] == [True, False, True]
    assert [not torch.equal(port.critic_target["q1"]["w"][0][i],
                            target_before[i])
            for i in range(S)] == [True, False, True]
    if cfg_t.constraint.use_backup:
        assert [not torch.equal(port.lag.backup_lam[i], backup_before[i])
                for i in range(S)] == [True, False, False]
    assert port.updates == [n + 1 for n in COUNTERS]
    for k in METRIC_NAMES:
        assert m_t[k].shape == (S,), k
        np.testing.assert_allclose(m_t[k].numpy(), np.asarray(m_j[k]),
                                   rtol=metric_rtol, atol=1e-6, err_msg=k)
    expect = as_numpy(ts_j)
    got = to_reference_stacked(port, expect, cfg_t)
    for (pa, a), (pb, b) in zip(leaves_with_paths(expect),
                                leaves_with_paths(got)):
        assert pa == pb and a.shape == b.shape, pa
        if any(part in pa for part in bf16_leaves):
            for i in range(S):
                np.testing.assert_allclose(
                    b[i], a[i], rtol=0,
                    atol=max(atol, 2.0 ** -7 * np.abs(a[i]).max()),
                    err_msg=f"{pa} seed {i}")
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4, atol=atol,
                                       err_msg=pa)
    return m_t


@pytest.mark.parametrize("preset", PRESETS)
def test_seed_batched_update_matches_jax_vmap(preset):
    m = check_seed_batched_update(preset)
    if preset in ("nbc_unicycle", "nbc_pvtol", "quadrotor"):
        assert (m["barrier_td_loss"] > 0).all()


def test_seed_batched_two_step_node_update_matches_jax_vmap():
    """The unicycle with a two-step Euler NODE (the plain control-affine
    field on stacked weights, no K1)."""
    check_seed_batched_update("unicycle", solver_steps=2)


def test_seed_batched_bf16_node_update_matches_jax_vmap():
    """The unicycle with a bf16 NODE (the plain control-affine field on
    stacked weights, each layer's product rounded to bf16 before its bias
    is added, as one seed's layer rounds) against ``jax.vmap`` of JAX's
    update, compiled without XLA's excess precision: the single-update
    tolerances, the NODE biases'
    Adam moments within one bf16 ulp (a bias gradient is a sum of the
    batch's bf16 terms, which the two libraries round differently: up to
    2.4e-5 apart, 23 times rtol 1e-4, as far as the one-seed port's
    update from JAX's one-seed update). The port's float32 update from
    the same states and draws fails them (constraint_loss 227 times its
    tolerance, the NODE weights' moments up to 32 times). With excess
    precision (XLA's default) a bf16 product keeps float32 into its bias
    add, where JAX's ops run one by one round between them: that
    update's constraint_loss parts from the op-by-op one's by 2.3e-3
    relative, the port's by 1e-7."""
    bias_moments = tuple(f"{m}['{n}']['b']" for m in ("mu", "nu")
                         for n in ("f", "g"))
    check_seed_batched_update("unicycle", exact_rounding=True,
                              bf16_leaves=bias_moments, float32_fails=True,
                              compute_dtype="bfloat16")


# ---------------------------------------------------------------------------
# (b) the supervisor machines on a seed axis
# ---------------------------------------------------------------------------

class StackedMachines:
    """``tsup`` with every call made twice: once on S seeds stacked, once
    per seed; each seed's stacked fields must equal its one-seed fields
    bit for bit after every call. Seed 0 takes the script's inputs, seeds
    1 and 2 the same inputs DELAYS steps late, so that their machines
    fire at other steps."""

    DELAYS = (0, 3, 7)

    def __init__(self):
        self.stacked, self.single = None, None
        self.flags = []  # the stacked machine's backup flag per action
        self.inputs = []  # (obs_prev, obs, reached) per post_step

    def init_supervisor(self, cfg, device):
        self.stacked = tsup.init_supervisor(cfg, device, seeds=S)
        self.single = [tsup.init_supervisor(cfg, device) for _ in range(S)]
        self.check()
        return self.single[0]

    def pre_action(self, cfg, sup, start):
        a, self.stacked = tsup.pre_action(cfg, self.stacked, start)
        outs = [tsup.pre_action(cfg, s, start) for s in self.single]
        self.single = [s for _, s in outs]
        assert a.tolist() == [bool(f) for f, _ in outs]
        self.flags.append(a.tolist())
        self.check()
        return outs[0]

    def post_step(self, cfg, sup, obs_prev, out, steps, start):
        self.inputs.append((obs_prev, out.obs, out.reached))
        seen = [self.inputs[max(len(self.inputs) - 1 - d, 0)]
                for d in self.DELAYS]
        outs = [out._replace(obs=o, reached=r) for _, o, r in seen]
        self.stacked = tsup.post_step(
            cfg, self.stacked, torch.stack([p for p, _, _ in seen]),
            out._replace(obs=torch.stack([o.obs for o in outs]),
                         reached=torch.stack([o.reached for o in outs])),
            steps, start)
        self.single = [tsup.post_step(cfg, s, p, o, steps, start)
                       for s, (p, _, _), o in zip(self.single, seen, outs)]
        self.check()
        return self.single[0]

    def check(self):
        assert self.stacked.ptr == self.single[0].ptr
        for name in tsup.SupervisorState._fields:
            if name == "ptr":
                continue
            got = getattr(self.stacked, name)
            for i, one in enumerate(self.single):
                assert torch.equal(got[i], getattr(one, name)), (name, i)


@pytest.mark.parametrize("script", ["cars_gap_machine_on_scripted_gaps",
                                    "pvtol_machine_on_scripted_motion"],
                         ids=["cars_gap", "pvtol"])
def test_stacked_machines_equal_their_one_seed_calls(script, monkeypatch):
    """The presets' scripted sequences drive the machines; each step's
    stacked machine (3 seeds, two of them on moved inputs) against 3
    one-seed machines, bit for bit; the seeds' backup flags differ
    somewhere in the sequence. The JAX comparison of the one-seed
    machine runs as in ``test_torch_port_presets.py``."""
    import test_torch_port_presets as presets

    machines = StackedMachines()
    monkeypatch.setattr(presets, "tsup", machines)
    getattr(presets, f"test_{script}")()
    assert any(len(set(f)) > 1 for f in machines.flags)
