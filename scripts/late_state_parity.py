#!/usr/bin/env python3
"""The port's update against the JAX package's over a sequence of updates
from a late training state, on the CPU.

    python3 scripts/late_state_parity.py CHECKPOINT [--preset unicycle]
        [--updates 40] [--seed 0] [--xla_tanh] [--json OUT]

CHECKPOINT is a ``checkpoint.npz`` of ``--preset`` (unicycle or
nbc_unicycle) written by ``nlbac-train-torch`` at the preset's widths, or
a band seed's kept chunk checkpoint, packed, under
``band_work/<preset>/s<seed>/``. Its state and replays are restored into
the port on the CPU, and the state is carried into the JAX package by
``nlbac_tpu_torch.interop.to_reference``. Three runs then take the same
updates, each carrying its own state: the JAX package, the port, and the
port with every trained weight one float32 ulp up (the noise floor: how
far float32 rounding alone moves the same updates). Every update takes
the same RL and NODE batches, drawn with numpy from the checkpoint's
replays, and the same standard-normal draws, taken from the JAX update's
key as ``tests/test_torch_port_gates.py`` takes them (under nbc_unicycle
also the learned barrier's resampled controls, as
``tests/test_torch_port_episode.py`` takes them); the gates (the NODE
fit, the targets, the multiplier ascent, the backup branch) fall where the
checkpoint's update counter and episode put them.

Printed: per update, whether it fitted the NODE, the largest pre-tanh
sample, how many samples lie at 4.66-9.02, where the two libraries'
squash terms part by over 1e-3 nats (``tests/test_torch_port_squash.py``),
how far each tanh's squash term moves under a one-ulp move of the samples
(JSON only), and
the largest relative gap of its metrics to JAX's, the port's and the
one-ulp port's; then, for each part of the state, its largest gap to
JAX's after the last update, relative to the part's largest entry, for
the port and for the one-ulp port. A port that follows JAX only as far as
float32 noise lets it shows gaps to JAX of the floor's size.
``--xla_tanh`` gives both port runs the port's own XLA-form squash
(``make_agent(..., squash="xla")``, ``nlbac-train-torch --squash xla``:
XLA's CPU tanh and its jitted derivative, bit for bit), so that what gap
remains is not the tanh's (the pinned deviation of ROADMAP Queue 3). A
checkpoint of a run under ``--squash xla`` records it; the script prints
the record.

It imports both packages (a comparison, like the tests), and is not part
of the test suite: a full-width update sequence takes minutes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from nlbac_tpu import config as jconfig  # noqa: E402
from nlbac_tpu.agent import create_train_state as j_create  # noqa: E402
from nlbac_tpu.agent import make_agent as j_make_agent  # noqa: E402
from nlbac_tpu_torch import config as tconfig  # noqa: E402
from nlbac_tpu_torch.agent import create_train_state  # noqa: E402
from nlbac_tpu_torch.agent import make_agent  # noqa: E402
from nlbac_tpu_torch.agent.update import METRIC_NAMES  # noqa: E402
from nlbac_tpu_torch.interop import to_reference  # noqa: E402
from nlbac_tpu_torch.nn import gaussian_policy_forward  # noqa: E402
from nlbac_tpu_torch.nn.xla_float import xla_tanh  # noqa: E402
from nlbac_tpu_torch.replay import buffer as replay_lib  # noqa: E402
from nlbac_tpu_torch.train import checkpoint as ckpt  # noqa: E402
from nlbac_tpu_torch.train.driver import create_replays  # noqa: E402

import band_torch  # noqa: E402  (beside this script: a band's packed checkpoints)

# the presets whose checkpoints the script reads: unicycle's constraint
# chain resamples nothing, nbc_unicycle's learned barrier resamples the
# next control
PRESETS = ("unicycle", "nbc_unicycle")
# the trained fields that the one-ulp run moves (and the learned barrier's
# net where the preset trains one)
TRAINED = ("policy", "backup_policy", "critic", "lyap", "node", "log_alpha",
           "backup_log_alpha")


def trained_fields(cfg):
    return TRAINED + (("barrier",)
                      if cfg.constraint.kind == "learned_barrier" else ())


def restore(cfg, path):
    """The port's state and replays from ``path``, and its counters (the
    generator's state, a card's, is not restored: no update here draws
    from it)."""
    ts = create_train_state(cfg, torch.Generator("cpu").manual_seed(0),
                            "cpu")
    rl, node = create_replays(cfg, "cpu")
    if path.endswith(band_torch.PACKED):
        z = band_torch.unpack_arrays(path)
    else:
        with np.load(path) as f:
            z = {k: f[k] for k in f.files}
    ckpt._restore_state(z, ts)
    for name, rep in zip(ckpt.REPLAYS, (rl, node)):
        ckpt._restore_replay(name, z, rep)
    ts.updates, total, episode = (int(v) for v in z["counters"])
    return ts, rl, node, total, episode, ckpt.checkpoint_squash(z)


def replay_rows(rep):
    return rep.data[:rep.size].numpy(), rep.layout


def sample(rows, layout, rng, n):
    idx = rng.integers(0, rows.shape[0], n)
    got = replay_lib.unpack_rows(layout, torch.from_numpy(rows[idx]))
    return {k: v.numpy().copy() for k, v in got.items()}


def draws(key, batch, n_u, ccfg=None):
    """The JAX update's draws from split(key, 8): [2] the TD-target
    sample, [3] the policy-loss sample, [5] the backup-loss sample; under
    a learned barrier (``ccfg``, the constraint config) also [4] the
    resampled control of the policy loss's barrier term and, with a
    backup policy, [6] the backup loss's, each (1, batch, n_u): one draw
    a resampling step."""
    keys = jax.random.split(key, 8)

    def normal(i):
        return torch.tensor(np.asarray(
            jax.random.normal(keys[i], (batch, n_u), jnp.float32)))

    out = {name: normal(i)
           for name, i in (("next", 2), ("pi", 3), ("backup", 5))}
    if ccfg is not None and ccfg.kind == "learned_barrier":
        out["resample"] = normal(4)[None]
        if ccfg.use_backup:
            out["backup_resample"] = normal(6)[None]
    return out


def pre_tanh(ts, batch, noise, use_backup=True):
    """The update's samples' pre-tanh values |mean + std * noise|,
    flattened: the TD target's, the policy loss's and, with a backup
    policy, the backup loss's."""
    out = []
    samples = ((ts.policy, batch["next_obs"], "next"),
               (ts.policy, batch["obs"], "pi"),
               (ts.backup_policy, batch["obs"], "backup"))
    with torch.no_grad():
        for policy, obs, name in samples[:3 if use_backup else 2]:
            mean, log_std = gaussian_policy_forward(policy, obs)
            out.append((mean + torch.exp(log_std) * noise[name]).abs()
                       .flatten())
    return torch.cat(out)


def ulp_jump(u):
    """The largest change of the squash term log(1 - tanh(u)^2 + 1e-6)
    (action scale 1) under a one-ulp move of u, with torch's tanh and with
    XLA's: how much float32 noise each tanh turns into."""
    up = torch.nextafter(u, torch.full_like(u, np.inf))

    def term(y):
        return torch.log(1.0 - torch.square(y) + 1e-6)

    jumps = {}
    for name, tanh in (("torch", torch.tanh), ("xla", xla_tanh)):
        with torch.no_grad():
            jumps[name] = float((term(tanh(up)) - term(tanh(u))).abs()
                                .max())
    return jumps


def one_ulp_up(ts, fields=TRAINED):
    with torch.no_grad():
        for field in fields:
            for p in jax.tree_util.tree_leaves(getattr(ts, field)):
                p.copy_(torch.nextafter(p, torch.full_like(p, np.inf)))


def rel_gap(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def part_gaps(got, want):
    """{part: largest |got - want| over the part's leaves / the part's
    largest |want|}, a part being a state field (an optimizer group
    apart)."""
    out = {}
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    parts = {}
    for (pw, w), (pg, g) in zip(flat_w, flat_g):
        name = jax.tree_util.keystr(pw)
        assert name == jax.tree_util.keystr(pg), name
        part = name.split("[")[0].split(".")[1]
        if part == "opt":
            part = "opt" + name.split("]")[0].split("[")[1]
        gap, scale = parts.get(part, (0.0, 0.0))
        w, g = np.asarray(w, np.float64), np.asarray(g, np.float64)
        if w.size:
            parts[part] = (max(gap, float(np.abs(g - w).max())),
                           max(scale, float(np.abs(w).max())))
    for part, (gap, scale) in parts.items():
        out[part] = gap / max(scale, 1e-12)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint")
    p.add_argument("--preset", default="unicycle", choices=PRESETS,
                   help="the checkpoint's preset")
    p.add_argument("--updates", type=int, default=40)
    p.add_argument("--seed", type=int, default=0,
                   help="the batches' numpy seed and the keys' offset")
    p.add_argument("--xla_tanh", action="store_true",
                   help="both port runs take the port's XLA-form squash "
                        "(squash='xla') in place of torch.tanh")
    p.add_argument("--json", default=None)
    args = p.parse_args(argv)
    squash = "xla" if args.xla_tanh else "torch"
    t0 = time.monotonic()

    cfg_t = tconfig.get_config(args.preset)
    cfg_j = jconfig.get_config(args.preset)
    port, rl, node, total, last, trained = restore(cfg_t, args.checkpoint)
    ulp, *_ = restore(cfg_t, args.checkpoint)
    one_ulp_up(ulp, trained_fields(cfg_t))
    episode = last + 1
    template = jax.tree.map(np.asarray,
                            j_create(cfg_j, jax.random.PRNGKey(0)))
    ts_j = jax.tree.map(jnp.asarray, to_reference(port, template))
    update = jax.jit(j_make_agent(cfg_j).update_from_batch)
    agent = make_agent(cfg_t, "cpu", squash=squash)
    rl_rows, layout = replay_rows(rl)
    node_rows, _ = replay_rows(node)
    rng = np.random.default_rng(args.seed)
    n_u, batch_size = cfg_j.action_dim, cfg_j.sac.batch_size
    print(f"{args.checkpoint}: episode {last}, {total} env steps, "
          f"{port.updates} updates (trained under --squash {trained}); "
          f"these updates under squash {squash}; rho "
          f"{float(port.lag.rho)}, lam "
          f"{port.lag.lam.tolist()}; RL rows {rl.size}, NODE rows "
          f"{node.size}; the next {args.updates} updates at episode "
          f"{episode}", flush=True)
    rows = []
    for k in range(args.updates):
        batch = sample(rl_rows, layout, rng, batch_size)
        node_batch = sample(node_rows, layout, rng, cfg_j.node.max_batch)
        tb = {n: torch.from_numpy(v) for n, v in batch.items()}
        tnb = {n: torch.from_numpy(v) for n, v in node_batch.items()}
        key = jax.random.PRNGKey(args.seed * 100000 + k)
        noise = draws(key, batch_size, n_u, cfg_t.constraint)
        u = pre_tanh(port, tb, noise, cfg_t.constraint.use_backup)
        tanh_in = float(u.max())
        # where the two tanh's squash terms part by over 1e-3 nats
        # (|u| 4.66-9.02, tests/test_torch_port_squash.py)
        apart = int(((u >= 4.66) & (u < 9.02)).sum())
        ts_j, m_j = update(ts_j, batch, node_batch, key,
                           jnp.int32(episode))
        fitted = []
        port, m_t = agent.update_core(
            port, tb, lambda: fitted.append(1) or tnb, None, episode,
            noise=noise)
        ulp, m_u = agent.update_core(ulp, tb, lambda: tnb, None, episode,
                                     noise=noise)
        gaps = {name: (rel_gap(float(m_t[name]), float(m_j[name])),
                       rel_gap(float(m_u[name]), float(m_t[name])))
                for name in METRIC_NAMES}
        worst = max(gaps, key=lambda n: gaps[n][0])
        row = {"update": k, "fit": bool(fitted), "pre_tanh_max": tanh_in,
               "samples_apart": apart, "samples": int(u.numel()),
               "squash_ulp_jump": ulp_jump(u),
               "metric_gap": {n: g[0] for n, g in gaps.items()},
               "metric_floor": {n: g[1] for n, g in gaps.items()}}
        rows.append(row)
        print(f"update {k:3d} fit {int(bool(fitted))} pre-tanh max "
              f"{tanh_in:6.2f}, {apart:3d} of {u.numel()} at 4.66-9.02  "
              f"worst metric {worst} gap to JAX "
              f"{gaps[worst][0]:.3e} (one-ulp port "
              f"{max(g[1] for g in gaps.values()):.3e})", flush=True)

    want = jax.tree.map(np.asarray, ts_j)
    gap_j = part_gaps(to_reference(port, want), want)
    gap_u = part_gaps(to_reference(ulp, want),
                      to_reference(port, want))
    print("part            port vs JAX   one-ulp port vs port "
          "(largest gap / largest entry)")
    for part in gap_j:
        print(f"{part:15s} {gap_j[part]:12.3e}   {gap_u[part]:12.3e}")
    print(f"{time.monotonic() - t0:.1f} s", flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"checkpoint": args.checkpoint, "episode": episode,
                       "trained_squash": trained, "squash": squash,
                       "updates": rows, "state_gap": gap_j,
                       "state_floor": gap_u}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
