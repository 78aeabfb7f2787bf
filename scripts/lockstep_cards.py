#!/usr/bin/env python3
"""The lockstep seed runner over several cards against one card.

    python3 scripts/lockstep_cards.py [--cards 4] [--seeds_per_card 4]
        [--episodes 2] [--steps 300] [--one_card] [--cpu]

Unicycle at full width (the preset's widths), ``--episodes`` episodes of
``--steps`` steps with ``--start_steps`` one episode (the policy acts from
the second), base seed 0, as ``chip_smoke.py``'s phases 21 and 24 run it:

1. one card's lockstep of seeds 0 .. S-1 (S = ``--seeds_per_card``) in
   this process on ``cuda:0`` (phase 21's SEEDS-seed run), after a
   warm-up episode: its env-steps/s;
2. ``--cards`` x S seeds in ``make_seed_parallel_runner`` over ``cuda:0``
   .. ``cuda:<cards - 1>``, one worker process a card: the workers'
   start-up seconds, each shard's K1 launches against the count per
   lockstep update (2 at S x 128 rows, one S x 32768 fit when a seed of
   it fits), the aggregate env-steps/s and its ratio to step 1's;
3. each other shard's seed block in this process on ``cuda:0``: each
   shard's largest gap to its one-card run (episodes, whole states, Adam
   moments, rings, generators; 0 expected, as the same code runs on the
   same shapes).

Every line names the cards and their power limits. Writes
``chiprun_out/lockstep_cards.json``. Exits nonzero without a card (or
with fewer than ``--cards``), if a shard's launches do not match its
updates or if a shard's first episode parts from its one-card run by more
than float32 rounding (relative 1e-5). ``--one_card`` puts every shard
on ``cuda:0`` (``--cards`` then counts shards). ``--cpu`` runs the same
on the CPU at tiny widths, a check of the script alone.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nlbac_tpu_torch import parallel  # noqa: E402
from nlbac_tpu_torch.config import ReplayConfig  # noqa: E402
from nlbac_tpu_torch.ops import node_kernel  # noqa: E402
from nlbac_tpu_torch.train import cli  # noqa: E402

SEED = 0
FIRST_RTOL = 1e-5
OUT = Path("chiprun_out") / "lockstep_cards.json"


def card_lines() -> list:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()


def run_cfg(episodes: int, steps: int, tiny: bool):
    argv = ["--preset", "unicycle", "--quiet", "--seed", str(SEED),
            "--max_episodes", str(episodes), "--max_episode_steps",
            str(steps), "--start_steps", str(steps)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    if tiny:  # the script's check on the CPU
        cfg = dataclasses.replace(
            cfg, sac=dataclasses.replace(cfg.sac, hidden_dim=16,
                                         batch_size=8),
            node=dataclasses.replace(cfg.node, hidden_dim=12,
                                     f_hidden_layers=2, g_hidden_layers=2,
                                     max_batch=16, update_interval=5),
            replay=ReplayConfig(capacity=steps * episodes,
                                node_capacity=steps * episodes))
    return cfg


def one_card(cfg, n_seeds, base, episodes, device):
    """The one-device lockstep of seeds base .. base + n_seeds - 1: each
    episode's per-seed host metrics, each seed on the host, seconds of
    the run_fn calls and K1's launches."""
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, n_seeds,
                                                         device)
    carry = init_fn(base)
    node_kernel.reset_launch_counts()
    sync(device)
    t0 = time.perf_counter()
    out = []
    for ep in range(episodes):
        ts, rl, node, gens, m, total = run_fn(*carry[:4], ep, carry[4])
        carry = (ts, rl, node, gens, total)
        out.append(parallel.episode_to_host_seeds(m))
    sync(device)
    secs = time.perf_counter() - t0
    return dict(episodes=out, seconds=secs,
                launches=node_kernel.launch_counts["node_euler"],
                fetched=[parallel.lockstep.seed_on_host(cfg, carry, i)
                         for i in range(n_seeds)])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def leaves(x):
    if isinstance(x, dict):
        return [a for k in sorted(x) for a in leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in leaves(v)]
    return [np.asarray(x, np.float64)]


def gap(a, b) -> float:
    """The largest absolute gap between two nests of numbers."""
    xs, ys = leaves(a), leaves(b)
    if len(xs) != len(ys) or any(x.shape != y.shape
                                 for x, y in zip(xs, ys)):
        return math.inf
    return max((float(np.max(np.abs(x - y), initial=0.0))
                for x, y in zip(xs, ys)), default=0.0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--seeds_per_card", type=int, default=4)
    ap.add_argument("--episodes", type=int, default=2)
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--one_card", action="store_true",
                    help="every shard on cuda:0")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU at tiny widths (checks the script)")
    args = ap.parse_args(argv)
    if args.cpu:
        devices, card = ["cpu"] * args.cards, "cpu (a check of the script)"
    else:
        cards = 1 if args.one_card else args.cards
        if torch.cuda.device_count() < cards:
            print(f"lockstep_cards: needs {cards} CUDA devices, has "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        devices = [f"cuda:{0 if args.one_card else d}"
                   for d in range(args.cards)]
        card = "; ".join(card_lines()[:cards])
        t0 = time.perf_counter()
        node_kernel.build()  # once, before the workers load it
        print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    print(f"cards: {card}", flush=True)
    cfg = run_cfg(args.episodes, args.steps, args.cpu)
    per, n_seeds = args.seeds_per_card, args.seeds_per_card * args.cards

    # a warm-up episode in this process (cuBLAS, the allocator, K1's
    # first launches), just past the first update, so that step 1 times a
    # warm process as chip_smoke.py's phase 21 does
    warm = run_cfg(1, cfg.sac.batch_size + 12, args.cpu)
    print(f"warm-up: {one_card(warm, per, SEED, 1, devices[0])['seconds']:.2f}"
          f" s", flush=True)
    # 1. one card's lockstep of the first block, in this process
    ref = {0: one_card(cfg, per, SEED, args.episodes, devices[0])}
    steps1 = sum(s["steps"] for ep in ref[0]["episodes"] for s in ep)
    rate1 = steps1 / ref[0]["seconds"]
    print(f"one card: {per} seeds in one process on {devices[0]}: {steps1} "
          f"env steps in {ref[0]['seconds']:.2f} s, {rate1:.2f} "
          f"env-steps/s, K1 {ref[0]['launches']} launches", flush=True)

    # 2. every block as a shard, a worker process a card
    t0 = time.perf_counter()
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, n_seeds,
                                                         devices)
    try:
        init_fn(SEED)
        start = time.perf_counter() - t0
        worker_setup = run_fn.start_seconds
        t1 = time.perf_counter()
        episodes = []
        for ep in range(args.episodes):
            metrics, _ = run_fn(ep)
            episodes.append(metrics)
        secs = time.perf_counter() - t1
        fetched = [run_fn.fetch(i) for i in range(n_seeds)]
        shards = run_fn.shards
    finally:
        run_fn.close()
    steps = sum(s["steps"] for ep in episodes for s in ep)
    rate = steps / secs

    # 3. the other blocks on one card, for each shard's gap
    for d in range(1, args.cards):
        ref[d] = one_card(cfg, per, SEED + shards[d][0], args.episodes,
                          devices[0])
    failed, rows = [], []
    for d, seeds in enumerate(shards):
        launches = sum(ep[seeds[0]]["kernel_launches"] for ep in episodes)
        calls = sum(max(ep[i]["updates_done"] for i in seeds)
                    for ep in episodes)
        fits = launches - 2 * calls
        want = ref[d]
        episode_gap = max(gap([[ep[i]["reward"], ep[i]["train"]]
                               for ep in episodes],
                              [[ep[j]["reward"], ep[j]["train"]]
                               for ep in want["episodes"]])
                          for j, i in enumerate(seeds))
        state_gap = max(gap(fetched[i], want["fetched"][j])
                        for j, i in enumerate(seeds))
        first = max(abs(episodes[0][i]["reward"]
                        - want["episodes"][0][j]["reward"])
                    / max(abs(want["episodes"][0][j]["reward"]), 1e-30)
                    for j, i in enumerate(seeds))
        shard_steps = sum(ep[i]["steps"] for ep in episodes for i in seeds)
        rows.append(dict(shard=d, device=devices[d], seeds=seeds,
                         launches=launches, updates=calls, fits=fits,
                         one_card_launches=want["launches"],
                         episode_gap=episode_gap, state_gap=state_gap,
                         first_episode_rel_gap=first,
                         one_card_seconds=want["seconds"],
                         one_card_env_steps_per_s=(
                             shard_steps / want["seconds"])))
        print(f"shard {d} (seeds {SEED + seeds[0]}..{SEED + seeds[-1]}, a "
              f"worker on {devices[d]}): K1 {launches} launches for {calls} "
              f"lockstep updates ({fits} fits of {per} x 32768; its one-card"
              f" run {want['launches']}); against its one-card run on "
              f"{devices[0]}: largest gap {episode_gap:.3e} in the episodes' "
              f"metrics, {state_gap:.3e} in the states, first episode's "
              f"reward relative {first:.3e} (limit {FIRST_RTOL}); one-card "
              f"rate {rows[-1]['one_card_env_steps_per_s']:.2f} env-steps/s",
              flush=True)
        if not args.cpu and not 1 <= fits <= calls:
            failed.append(f"shard {d}: {launches} K1 launches for {calls} "
                          f"lockstep updates")
        if first > FIRST_RTOL:
            failed.append(f"shard {d}: first episode {first:.3e} off its "
                          f"one-card run")
    print(f"{args.cards} shards x {per} seeds ({args.episodes} x "
          f"{args.steps} steps): {steps} env steps in {secs:.2f} s of run_fn "
          f"calls, {rate:.2f} env-steps/s in all, {rate / rate1:.3f} times "
          f"one card's {per}-seed lockstep ({rate1:.2f}); start-up "
          f"{start:.2f} s to every worker ready (the workers' own set-up "
          f"{[round(w, 2) for w in worker_setup]} s) on {card}", flush=True)
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({
        "cards": card, "shards": args.cards, "seeds_per_card": per,
        "episodes": args.episodes, "steps": args.steps,
        "env_steps_per_s": rate, "one_card_env_steps_per_s": rate1,
        "ratio_to_one_card": rate / rate1, "seconds": secs,
        "start_seconds": start, "worker_setup_seconds": worker_setup,
        "per_shard": rows}, indent=1))
    if failed:
        print(f"lockstep_cards: {'; '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
