#!/usr/bin/env python3
"""dp and tp gangs of the port against one rank: one rank per card over
NCCL across the cards of one host, or every rank on one card over gloo.

    python3 scripts/gang_probe.py [--layouts 4x1 1x4 2x2] [--steps 140]
        [--policy_from N] [--perturb up|down] [--one_card]
        [--backend nccl|gloo] [--cpu]

For each layout DPxTP (dp * tp ranks, at most one per card unless
``--one_card``), one full-width unicycle episode of ``--steps`` steps from
seed 0's state and generator, through ``make_parallel_runner``: the
reward and the whole state (parameters, targets, Adam moments,
multipliers; under tp gathered) against one rank's, each Adam moment's
relative gap (its 2-norm over one rank's), the replay rows' largest gap
over spans of steps, whether the ranks' states are bit-equal, each
rank's K1 launches by row count, and the episode's time on each rank
against one rank's, with the card's name and power limit.

The policy acts from step ``--policy_from`` on (the steps before take
random warm-up actions). By default that is the step of the first update
(the replay then holds a batch), so every action comes from a trained
policy. ``--perturb`` moves every policy weight of the start state one
ulp up or down, in the gangs and in one more run of one rank, whose gap
to the unperturbed rank is printed first: how far float32 noise in the
actions alone carries the episode. ``--cpu`` runs the same on the CPU
over gloo (a check of the script, at the preset's widths: slow). Exits
nonzero if a gang fails, disagrees with one rank beyond
``tests/test_parallel.py``'s tolerances, or if K1 was launched under tp,
or not at the shares of one rank's rows under dp.
"""

from __future__ import annotations

import argparse
import dataclasses
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nlbac_tpu_torch import parallel  # noqa: E402
from nlbac_tpu_torch.agent import create_train_state  # noqa: E402
from nlbac_tpu_torch.config import get_config  # noqa: E402
from nlbac_tpu_torch.ops import node_kernel  # noqa: E402
from nlbac_tpu_torch.train import (  # noqa: E402
    create_replays,
    make_episode_runner,
)
from nlbac_tpu_torch.train.driver import episode_to_host  # noqa: E402
from nlbac_tpu_torch.tree import tree_leaves  # noqa: E402

SEED = 0
REWARD_RTOL, REWARD_ATOL = 2e-4, 1e-4
STATE_RTOL, STATE_ATOL = 2e-3, 5e-4
# Spans of steps (first, last + 1) whose replay rows' gap is printed.
SPANS = ((0, 1), (1, 10), (10, 50), (50, 100), (100, 129), (129, None))


def card_line() -> str:
    if not torch.cuda.is_available():
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def episode_cfg(steps: int):
    cfg = get_config("unicycle")
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, max_episode_steps=steps),
        run=dataclasses.replace(cfg.run, max_episodes=1, seed=SEED))


def one_episode(cfg, place, run, dev, policy_from, perturb):
    """One episode from seed SEED's state and generator (every rank takes
    rank 0's through ``place``; ``perturb`` the policy's weights one ulp
    up or down first), the policy acting from step ``policy_from``, K1's
    launches counted and the time taken around it; the same episode runs
    once before, untimed, so that the process's first-call set-up
    (cuBLAS, K1's library) is not timed."""
    for _ in range(2):  # an untimed first pass, then the timed one
        gen = torch.Generator(dev).manual_seed(SEED)
        ts = create_train_state(cfg, gen, dev)
        if perturb:
            with torch.no_grad():
                for p in tree_leaves(ts.policy):
                    p.copy_(torch.nextafter(p, torch.full_like(
                        p, np.inf if perturb == "up" else -np.inf)))
        rl, node = create_replays(cfg, dev)
        ts, rl, node, gen, total = place(
            (ts, rl, node, gen, cfg.sac.start_steps - policy_from))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        node_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        ts, rl, node, m, total = run(ts, rl, node, gen, 0, total)
        host = episode_to_host(m)
        seconds = time.perf_counter() - t0
    return ts, {"reward": host["reward"], "seconds": seconds,
                "rows": dict(node_kernel.launches_by_rows),
                "replay": rl.data[:host["steps"]].cpu().numpy()}


def rank(r, world, coordinator, dp, tp, steps, cpu, one_card, backend,
         policy_from, perturb, out):
    dev = parallel.device_for_rank(cpu, 0 if one_card else r)
    torch.backends.cuda.matmul.allow_tf32 = False
    parallel.init_distributed(coordinator, world, r, backend=backend,
                              device=dev)
    cfg = episode_cfg(steps)
    grid = parallel.make_mesh((dp, tp))
    place, run = parallel.make_parallel_runner(cfg, grid, dev)
    ts, result = one_episode(cfg, place, run, dev, policy_from, perturb)
    whole = parallel.gather_state_tp(ts) if tp > 1 else ts
    result["state"] = parallel.state_arrays(whole)
    Path(out, f"r{r}.pkl").write_bytes(pickle.dumps(result))


def flat(state, adam_only=False):
    return [a for k, v in state.items() if k != "updates"
            and (k.startswith("adam/") or not adam_only)
            for x in v for a in (x if isinstance(x, tuple) else (x,))]


def relative_gap(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are 0, inf when only b is)."""
    den = float(np.linalg.norm(b))
    num = float(np.linalg.norm(np.asarray(a, np.float64) - b))
    return num / den if den > 0 else (0.0 if num == 0 else float("inf"))


def compare(got, want):
    """Gaps of one run (``got``: its result dict) to another."""
    pairs = list(zip(flat(got["state"]), flat(want["state"])))
    rows = np.max(np.abs(got["replay"] - want["replay"]), axis=1)
    spans = ", ".join(f"{lo}-{hi or len(rows)}: "
                      f"{float(rows[lo:hi].max()):.3e}"
                      for lo, hi in SPANS if lo < len(rows))
    return {
        "reward_gap": abs(got["reward"] - want["reward"]),
        "gap": max(float(np.max(np.abs(a - b))) for a, b in pairs),
        "state_ok": got["state"]["updates"] == want["state"]["updates"]
        and all(np.allclose(a, b, rtol=STATE_RTOL, atol=STATE_ATOL)
                for a, b in pairs),
        "moment_gap": max((relative_gap(a, b) for a, b in zip(
            flat(got["state"], True), flat(want["state"], True))),
            default=0.0),
        "spans": spans}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--layouts", nargs="+", default=["4x1", "1x4", "2x2"])
    p.add_argument("--steps", type=int, default=140)
    p.add_argument("--policy_from", type=int, default=None,
                   help="the first step the policy acts at (default: the "
                        "first update's)")
    p.add_argument("--perturb", choices=["up", "down"], default=None)
    p.add_argument("--one_card", action="store_true",
                   help="every rank on card 0 (gloo)")
    p.add_argument("--backend", default=None)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("gang_probe: no CUDA device (pass --cpu)", file=sys.stderr)
        return 1
    card = card_line()
    dev = torch.device("cpu" if args.cpu else "cuda:0")
    backend = args.backend or ("gloo" if args.cpu or args.one_card
                               else "nccl")
    cfg = episode_cfg(args.steps)
    # updates start once the replay holds more than a batch
    policy_from = (cfg.sac.batch_size + 1 if args.policy_from is None
                   else args.policy_from)
    run1 = make_episode_runner(cfg, dev)
    ts1, one = one_episode(cfg, lambda tree: tree, run1, dev, policy_from,
                           None)
    one["state"] = parallel.state_arrays(ts1)
    print(f"one rank: {ts1.updates} updates, K1 launches by rows "
          f"{one['rows']}, {one['seconds']:.2f} s, reward "
          f"{one['reward']:.6g}, the policy from step {policy_from}, on "
          f"{card}", flush=True)
    if args.perturb:
        ts2, moved = one_episode(cfg, lambda tree: tree, run1, dev,
                                 policy_from, args.perturb)
        moved["state"] = parallel.state_arrays(ts2)
        c = compare(moved, one)
        print(f"one rank, policy one ulp {args.perturb}: reward gap "
              f"{c['reward_gap']:.3e}; whole state's largest gap "
              f"{c['gap']:.3e}, within the tolerances {c['state_ok']}; "
              f"Adam moments' largest relative gap {c['moment_gap']:.3e}; "
              f"replay rows' gap by steps {c['spans']}", flush=True)
    ok = True
    for layout in args.layouts:
        dp, tp = (int(v) for v in layout.split("x"))
        world = dp * tp
        if not (args.cpu or args.one_card) and \
                world > torch.cuda.device_count():
            print(f"{layout}: needs {world} cards, this host has "
                  f"{torch.cuda.device_count()}; skipped", flush=True)
            continue
        with tempfile.TemporaryDirectory() as out:
            t0 = time.perf_counter()
            parallel.run_gang(rank, world, (
                dp, tp, args.steps, args.cpu, args.one_card, backend,
                policy_from, args.perturb, out), timeout=900)
            wall = time.perf_counter() - t0
            ranks = [pickle.loads(Path(out, f"r{r}.pkl").read_bytes())
                     for r in range(world)]
        got = flat(ranks[0]["state"])
        same = all(all(np.array_equal(a, b) for a, b in
                       zip(got, flat(r["state"]))) for r in ranks[1:])
        c = compare(ranks[0], one)
        reward_ok = c["reward_gap"] <= REWARD_ATOL + REWARD_RTOL * abs(
            one["reward"])
        share = {rows // dp: n for rows, n in one["rows"].items()}
        k1_ok = all(r["rows"] == ({} if tp > 1 else share) for r in ranks)
        print(f"{layout} ({backend}, {world} ranks"
              f"{', one card' if args.one_card else ''}"
              f"{', policy one ulp ' + args.perturb if args.perturb else ''}"
              f"): episode {max(r['seconds'] for r in ranks):.2f} s on its "
              f"slowest rank against one rank's {one['seconds']:.2f} s, "
              f"{wall:.2f} s with the spawn; reward gap "
              f"{c['reward_gap']:.3e}; whole state's largest gap "
              f"{c['gap']:.3e} (rtol {STATE_RTOL} atol {STATE_ATOL}); Adam "
              f"moments' largest relative gap {c['moment_gap']:.3e} (limit "
              f"{STATE_RTOL}); replay rows' gap by steps {c['spans']}; "
              f"ranks bit-equal {same}; K1 launches by rows on rank 0 "
              f"{ranks[0]['rows']}; on {card}", flush=True)
        ok = (ok and same and c["state_ok"] and c["moment_gap"] <= STATE_RTOL
              and reward_ok and k1_ok)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
