#!/usr/bin/env python3
"""The port's band: seeds of a preset trained through ``nlbac-train-torch``
over the preset's whole budget, judged against the JAX package's recorded
seeds.

    python3 scripts/band_torch.py run [--per_card 3] [--chunk 25]
        [--seeds S ...] [--time_limit SECONDS] [--cpu]
    python3 scripts/band_torch.py judge [--port DIR] [--episodes N]

``run`` trains each seed as its own ``python -m nlbac_tpu_torch.train.cli
--preset unicycle --seed S --quiet`` process at the preset's defaults
(full widths, its episodes, steps and warm-up), at most ``--per_card``
processes a card over every card present, each pinned to its card by
``CUDA_VISIBLE_DEVICES``. A seed trains in chunks of ``--chunk`` episodes:
chunk k runs ``--max_episodes k*C --resume <the last chunk's
checkpoint.npz>``, and the CLI writes a checkpoint at a chunk's last
episode. A chunk counts once its process has ended with every row and a
checkpoint at its last episode: only then are its rows added to the seed's
``progress.txt`` under ``--out`` (``s<seed>/progress.txt``, the JAX CLI's
columns, and ``s<seed>/run.json``: the card and its power limit, the
processes a card, env steps, seconds, env-steps/s, the chunks). A chunk
that is cut (``--time_limit``, SIGTERM, a failed process) leaves no row,
and a later ``run`` continues every seed from its last kept checkpoint,
which lives under ``--work`` with the chunks' own run directories (a
seed with no work state is done when its ``--out`` files hold every
episode, and starts from episode 0 otherwise). Without
a card it raises unless ``--cpu`` is given; ``--cpu`` trains at tiny
widths and only checks the script.

``judge`` reads the port's and the reference's ``progress.txt`` files,
prints a row per seed (last-50 reward, goals in the last 50, episodes with
``safety_cost_train > 0`` in the last 100, first episode with a goal, env
steps; ``scripts/r9_analyze.py``'s definitions), the verdict of the band
rules below and a two-sided Mann-Whitney U test of the last-50 rewards,
port against reference (reported, not a gate), and writes ``judge.json``
under ``--port``. ``--episodes N`` takes every seed's first N episodes,
both sides, for a reading before the budget ends (not the band).

Band rules, from the reference's 16 unicycle seeds: a seed is converged
with a last-50 reward >= 640, >= 49/50 goals in the last 50 and <= 5
violation episodes in the last 100 (15 of the 16 are; s12345 is not). The
port passes with >= 10 of its 12 seeds converged and a median last-50
reward >= 684. With exactly 3 seeds not converged, seeds 108-111 are run
too, and the port then passes with >= 13 of 16 converged and a median
>= 684.

This script imports neither JAX nor the JAX package; it reaches the port
only through the CLI's processes.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# preset -> its budget, the band's seeds (the r9 seed numbers; the port's
# Philox streams differ from the reference's threefry ones, so the numbers
# match only by convention), the fallback seeds and the reference's
# recorded seed directories (each holds s<seed>/progress.txt)
PRESETS = {
    "unicycle": {
        "episodes": 200,
        "seeds": (12345, 12346, 12347, 12348) + tuple(range(100, 108)),
        "fallback": (108, 109, 110, 111),
        "ref": ("results/r9/seeds/unicycle/unicycle-run1",
                "results/r9/unicycle_8seed/unicycle-run1",
                "results/r10/unicycle_seeds"),
    },
}
# --cpu: tiny widths, a check of the script and not a band
CPU_ARGS = ("--cpu", "--hidden_size", "16", "--max_episode_steps", "40",
            "--batch_size", "8", "--start_steps", "10")

# the band rules (see the module docstring)
LAST_REWARD, LAST_GOALS, LAST_VIOLATIONS = 50, 50, 100
CONVERGED_REWARD, CONVERGED_GOALS, CONVERGED_VIOLATIONS = 640.0, 49, 5
PASS_MEDIAN = 684.0
PASS_CONVERGED = 10          # of the 12 seeds
FALLBACK_AT = 3              # seeds not converged that call the fallback
FALLBACK_CONVERGED = 13      # of the 16 seeds

# OMP_NUM_THREADS of each CLI process: its card's work is issued by one
# Python thread, and several processes share the host's cores, which
# each process's own intra-op pool would otherwise all claim
THREADS = 1

_TIMER = re.compile(r"time/(\w+): ([0-9.]+)s")


# ---------------------------------------------------------------- files


def read_progress(path):
    """A progress.txt as (header, rows as text lines, {column: array})."""
    with open(path) as f:
        header = f.readline().rstrip("\n")
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    keys = header.split("\t")
    cols = {k: np.array([float(ln.split("\t")[i]) for ln in lines])
            for i, k in enumerate(keys)}
    return header, lines, cols


def _write_atomic(path, text):
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)


def card_line(index):
    """``nvidia-smi``'s name and power limit of card ``index``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------- run


class Seed:
    """One seed's kept state: ``<work>/s<seed>/state.json`` holds the
    progress.txt header and rows of its completed chunks, its last
    checkpoint and its chunks' records; ``<out>/s<seed>/`` is rewritten
    from it after every completed chunk. Without a state, a seed whose
    ``<out>`` files hold all ``episodes`` is done (a work directory is
    not committed); any other starts from episode 0, its partial files
    removed."""

    def __init__(self, seed, work, out, episodes):
        self.seed = seed
        self.work = os.path.join(work, f"s{seed}")
        self.out = os.path.join(out, f"s{seed}")
        self.state_path = os.path.join(self.work, "state.json")
        os.makedirs(self.work, exist_ok=True)
        if os.path.exists(self.state_path):
            with open(self.state_path) as f:
                self.state = json.load(f)
        else:
            self.state = {"seed": seed, "header": None, "rows": [],
                          "checkpoint": None, "env_steps": 0,
                          "chunks": []}
            self.adopt(episodes)
        ckpt = self.checkpoint()
        if ckpt is not None and not os.path.exists(ckpt):
            raise SystemExit(f"s{seed}: {self.done} episodes kept but no "
                             f"checkpoint at {ckpt}")

    def adopt(self, episodes):
        kept = os.path.join(self.out, "progress.txt")
        if not os.path.exists(kept):
            return
        header, rows, cols = read_progress(kept)
        if len(rows) < episodes:
            shutil.rmtree(self.out)
            return
        with open(os.path.join(self.out, "run.json")) as f:
            chunks = json.load(f)["chunks"]
        self.state.update(header=header, rows=rows, chunks=chunks,
                          env_steps=int(cols["episode_steps"].sum()))
        self.save_state()

    @property
    def done(self):
        return len(self.state["rows"])

    def checkpoint(self):
        name = self.state["checkpoint"]
        return None if name is None else os.path.join(self.work, name)

    def tidy(self):
        """Remove what a cut chunk left (its run directory, an unkept
        checkpoint) and rewrite the kept files."""
        keep = {"state.json", self.state["checkpoint"]}
        for name in os.listdir(self.work):
            if name not in keep and not name.endswith(".log"):
                path = os.path.join(self.work, name)
                if os.path.isdir(path):
                    shutil.rmtree(path)
                else:
                    os.remove(path)
        self.write_out()

    def write_out(self):
        os.makedirs(self.out, exist_ok=True)
        if self.state["header"] is not None:
            _write_atomic(os.path.join(self.out, "progress.txt"),
                          "\n".join([self.state["header"]]
                                    + self.state["rows"]) + "\n")
        chunks = self.state["chunks"]
        seconds = sum(c["seconds"] for c in chunks)
        train_s = sum(c["train_seconds"] for c in chunks)
        run = {"seed": self.seed, "episodes": self.done,
               "env_steps": self.state["env_steps"],
               "wall_seconds": round(seconds, 2),
               "env_steps_per_s": (round(self.state["env_steps"] / seconds,
                                         3) if seconds else None),
               "train_seconds": round(train_s, 2),
               "train_env_steps_per_s": (
                   round(self.state["env_steps"] / train_s, 3)
                   if train_s else None),
               "cards": sorted({c["card"] for c in chunks}),
               "processes_per_card": sorted({c["processes_per_card"]
                                             for c in chunks}),
               "chunks": chunks}
        _write_atomic(os.path.join(self.out, "run.json"),
                      json.dumps(run, indent=1) + "\n")

    def commit(self, header, rows, checkpoint, steps, record):
        """Keep a completed chunk: its checkpoint, then the state (the
        commit point), then the files under ``--out``."""
        name = f"checkpoint_ep{self.done + len(rows)}.npz"
        os.replace(checkpoint, os.path.join(self.work, name))
        old = self.checkpoint()
        self.state["header"] = self.state["header"] or header
        self.state["rows"] += rows
        self.state["checkpoint"] = name
        self.state["env_steps"] += steps
        self.state["chunks"].append(record)
        self.save_state()
        if old is not None and os.path.exists(old):
            os.remove(old)
        self.write_out()

    def save_state(self):
        _write_atomic(self.state_path, json.dumps(self.state) + "\n")


def _chunk_timers(log_path):
    """The CLI's phase timers (seconds) from its summary lines."""
    with open(log_path, errors="replace") as f:
        return {k: float(v) for k, v in _TIMER.findall(f.read())}


class Runner:
    """Runs the seeds' chunks on card slots until every seed has its
    episodes, the time limit passes or a stop is asked for."""

    def __init__(self, args, seeds, slots, card_names, call):
        self.args = args
        self.queue = list(seeds)
        self.slots = slots
        self.card_names = card_names
        self.call = call
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.deadline = (time.monotonic() + args.time_limit
                         if args.time_limit else None)
        self.failed = []
        self.cut = []

    def expired(self):
        return self.stop.is_set() or (
            self.deadline is not None and time.monotonic() > self.deadline)

    def command(self, seed, end):
        cmd = [sys.executable, "-m", "nlbac_tpu_torch.train.cli",
               "--preset", self.args.preset, "--seed", str(seed.seed),
               "--quiet", "--max_episodes", str(end),
               "--output", os.path.join(seed.work, "chunk")]
        if seed.done:
            cmd += ["--resume", seed.checkpoint()]
        if self.args.cpu:
            cmd += list(CPU_ARGS)
        return cmd + self.args.cli_args.split()

    def chunk(self, seed, card):
        """Run seed's next chunk on ``card`` (None: the CPU). Returns True
        when the chunk was kept."""
        start, end = seed.done, min(seed.done + self.args.chunk,
                                    self.args.episodes)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            OMP_NUM_THREADS=str(THREADS))
        if card is not None:
            env["CUDA_VISIBLE_DEVICES"] = str(card)
        shutil.rmtree(os.path.join(seed.work, "chunk"), ignore_errors=True)
        log = os.path.join(seed.work, f"chunk_ep{start}-{end - 1}.log")
        t0 = time.monotonic()
        with open(log, "w") as f:
            proc = subprocess.Popen(self.command(seed, end), cwd=ROOT,
                                    env=env, stdout=f,
                                    stderr=subprocess.STDOUT)
            while True:
                try:
                    rc = proc.wait(timeout=0.05 if self.args.cpu else 1.0)
                    break
                except subprocess.TimeoutExpired:
                    if self.expired():
                        proc.terminate()
                        try:
                            proc.wait(timeout=30)
                        except subprocess.TimeoutExpired:
                            proc.kill()
                            proc.wait()
                        with self.lock:
                            self.cut.append((seed.seed, start, end))
                        seed.tidy()
                        return False
        seconds = time.monotonic() - t0
        runs = glob.glob(os.path.join(seed.work, "chunk", "*-run*", "*",
                                      f"*_s{seed.seed}"))
        why = None
        if rc != 0:
            why = f"exit code {rc}"
        elif len(runs) != 1:
            why = f"{len(runs)} run directories"
        else:
            header, rows, cols = read_progress(
                os.path.join(runs[0], "progress.txt"))
            ckpt = os.path.join(runs[0], "checkpoint.npz")
            episodes = [int(e) for e in cols["Episode"]]
            if episodes != list(range(start, end)):
                why = f"episodes {episodes}, expected {start}..{end - 1}"
            elif seed.state["header"] not in (None, header):
                why = "a progress.txt header unlike the seed's"
            else:
                with np.load(ckpt) as z:
                    updates, total, last = (int(v) for v in z["counters"])
                steps = int(cols["episode_steps"].sum())
                if last != end - 1 or total != seed.state["env_steps"] + \
                        steps:
                    why = (f"checkpoint at episode {last} after {total} "
                           f"steps, expected {end - 1} after "
                           f"{seed.state['env_steps'] + steps}")
        if why is not None:
            with self.lock:
                self.failed.append((seed.seed, start, end, why, log))
            seed.tidy()
            return False
        timers = _chunk_timers(log)
        record = {"episodes": [start, end - 1], "env_steps": steps,
                  "updates": updates, "seconds": round(seconds, 2),
                  "train_seconds": round(timers.get("episode", 0.0)
                                         + timers.get("episode_first", 0.0),
                                         2),
                  "timers": timers,
                  "card": self.card_names[card],
                  "card_index": card,
                  "processes_per_card": self.args.per_card,
                  "cards_in_call": len(self.card_names),
                  "call": self.call}
        seed.commit(header, rows, ckpt, steps, record)
        shutil.rmtree(os.path.join(seed.work, "chunk"), ignore_errors=True)
        print(f"s{seed.seed}: episodes {start}..{end - 1} kept, {steps} env "
              f"steps in {seconds:.1f} s on card {card} "
              f"({self.card_names[card]})", flush=True)
        return True

    def slot_loop(self, card):
        while not self.expired():
            with self.lock:
                if not self.queue:
                    return
                seed = self.queue.pop(0)
            while seed.done < self.args.episodes and not self.expired():
                if not self.chunk(seed, card):
                    break

    def run(self):
        threads = [threading.Thread(target=self.slot_loop, args=(s,),
                                    daemon=True) for s in self.slots]
        for t in threads:
            t.start()
        for t in threads:
            while t.is_alive():
                t.join(timeout=0.5)


def cmd_run(args):
    preset = PRESETS[args.preset]
    args.episodes = args.episodes or preset["episodes"]
    seeds = args.seeds or list(preset["seeds"])
    if args.cpu:
        cards = [None]
        names = {None: "cpu"}
    else:
        import torch  # the card check only; the CLI processes train

        if not torch.cuda.is_available():
            raise SystemExit("band_torch.py run: no CUDA device (pass --cpu "
                             "to check the script at tiny widths)")
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = ([int(c) for c in visible.split(",") if c.strip()]
                 if visible else list(range(torch.cuda.device_count())))
        names = {c: card_line(c) for c in cards}
    args.out, args.work = os.path.abspath(args.out), os.path.abspath(
        args.work)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.work, exist_ok=True)
    call_path = os.path.join(args.work, "calls.json")
    calls = []
    if os.path.exists(call_path):
        with open(call_path) as f:
            calls = json.load(f)
    band = [Seed(s, args.work, args.out, args.episodes) for s in seeds]
    for seed in band:
        if 0 < seed.done < args.episodes and seed.checkpoint() is None:
            raise SystemExit(f"s{seed.seed}: {seed.done} episodes kept and "
                             "no checkpoint to continue from")
        seed.tidy()
    todo = [s for s in band if s.done < args.episodes]
    # a slot is a card; each card appears --per_card times
    slots = [c for _ in range(args.per_card) for c in cards]
    print(f"band run: {len(todo)} of {len(band)} seeds to train to "
          f"{args.episodes} episodes, {len(slots)} slots "
          f"({args.per_card} a card on {len(cards)} card(s): "
          f"{sorted(set(names.values()))})", flush=True)
    runner = Runner(args, todo, slots[:max(1, len(todo))], names,
                    len(calls))

    def on_term(signum, frame):
        runner.stop.set()

    old = signal.signal(signal.SIGTERM, on_term)
    t0 = time.monotonic()
    try:
        runner.run()
    finally:
        signal.signal(signal.SIGTERM, old)
    seconds = time.monotonic() - t0
    steps = sum(c["env_steps"] for s in band for c in s.state["chunks"]
                if c["call"] == len(calls))
    calls.append({"seconds": round(seconds, 2), "env_steps": steps,
                  "env_steps_per_s": round(steps / seconds, 3),
                  "cards": [names[c] for c in cards],
                  "per_card": args.per_card, "chunk": args.chunk,
                  "cut": runner.cut, "failed": runner.failed})
    _write_atomic(call_path, json.dumps(calls, indent=1) + "\n")
    for s, a, b, why, log in runner.failed:
        print(f"s{s}: episodes {a}..{b - 1} failed: {why} (log {log})",
              flush=True)
    if args.carry_mb is not None:
        carry(band, args)
    left = [s.seed for s in band if s.done < args.episodes]
    print(f"band run: {steps} env steps in {seconds:.1f} s "
          f"({steps / seconds:.2f} env-steps/s over the call); seeds "
          f"short of {args.episodes} episodes: {left}", flush=True)
    if runner.failed:
        return 1
    return 3 if left else 0


def carry(band, args):
    """Drop finished seeds' checkpoints; keep the checkpoints of unfinished
    seeds, the furthest first, while they sum to at most ``--carry_mb``,
    and start the others afresh (their work and kept rows removed), so
    that what a later call must be handed stays within that size."""
    for seed in band:
        if seed.done >= args.episodes and seed.checkpoint() is not None:
            os.remove(seed.checkpoint())
            seed.state["checkpoint"] = None
            seed.save_state()
    budget = args.carry_mb * 2 ** 20
    short = sorted((s for s in band if 0 < s.done < args.episodes),
                   key=lambda s: -s.state["env_steps"])
    for seed in short:
        size = os.path.getsize(seed.checkpoint())
        if size <= budget:
            budget -= size
            continue
        print(f"s{seed.seed}: {seed.done} episodes dropped (its "
              f"{size / 2 ** 20:.1f} MiB checkpoint is past --carry_mb)",
              flush=True)
        shutil.rmtree(seed.work)
        shutil.rmtree(seed.out, ignore_errors=True)
        seed.state = {"seed": seed.seed, "header": None, "rows": [],
                      "checkpoint": None, "env_steps": 0, "chunks": []}


# ---------------------------------------------------------------- judge


def seed_stats(path, episodes):
    """r9_analyze.py's figures of one seed's progress.txt over its first
    ``episodes`` episodes."""
    _, _, c = read_progress(path)
    c = {k: v[:episodes] for k, v in c.items()}
    goals = c["goal_met"]
    hit = np.nonzero(goals > 0)[0]
    stats = {
        "episodes": int(len(c["Episode"])),
        "last50_reward": float(c["reward_train"][-LAST_REWARD:].mean()),
        "goals_last50": int(goals[-LAST_GOALS:].sum()),
        "violation_episodes_last100": int(
            (c["safety_cost_train"][-LAST_VIOLATIONS:] > 0).sum()),
        "first_goal_episode": (int(c["Episode"][hit[0]]) if len(hit)
                               else None),
        "env_steps": int(c["episode_steps"].sum()),
    }
    stats["complete"] = stats["episodes"] >= episodes
    stats["converged"] = bool(
        stats["complete"]
        and stats["last50_reward"] >= CONVERGED_REWARD
        and stats["goals_last50"] >= CONVERGED_GOALS
        and stats["violation_episodes_last100"] <= CONVERGED_VIOLATIONS)
    return stats


def find_seeds(dirs):
    """{seed: progress.txt} over ``dirs`` (each holding s<seed>/)."""
    found = {}
    for d in dirs:
        for p in sorted(glob.glob(os.path.join(d, "s*", "progress.txt"))):
            m = re.fullmatch(r"s(\d+)", os.path.basename(os.path.dirname(p)))
            if m:
                found[int(m.group(1))] = p
    return found


def verdict(stats, seeds, fallback):
    """The band rules over the port's seeds: ``pass``, ``fail``,
    ``incomplete`` (a band seed short of its episodes) or ``fallback``
    (exactly FALLBACK_AT seeds not converged and seeds 108-111 not yet
    complete)."""
    main = [stats.get(s) for s in seeds]
    if any(s is None or not s["complete"] for s in main):
        return "incomplete"
    missed = sum(not s["converged"] for s in main)
    need, group = PASS_CONVERGED, main
    if missed == FALLBACK_AT:
        extra = [stats.get(s) for s in fallback]
        if any(s is None or not s["complete"] for s in extra):
            return "fallback"
        group, need = main + extra, FALLBACK_CONVERGED
    converged = sum(s["converged"] for s in group)
    median = float(np.median([s["last50_reward"] for s in group]))
    return "pass" if converged >= need and median >= PASS_MEDIAN else "fail"


def cmd_judge(args):
    preset = PRESETS[args.preset]
    episodes = args.episodes or preset["episodes"]
    ref = {s: seed_stats(p, episodes) for s, p in find_seeds(
        [os.path.join(ROOT, d) for d in preset["ref"]]).items()}
    port = {s: seed_stats(p, episodes)
            for s, p in find_seeds([args.port]).items()}
    seeds, fallback = preset["seeds"], preset["fallback"]
    result = verdict(port, seeds, fallback)

    def table(name, stats):
        print(f"{name}: seed  episodes  last-50 reward  goals/50  "
              f"viol-eps/100  first goal  env steps  converged")
        for s, st in stats.items():
            print(f"{name}: s{s:<6d} {st['episodes']:8d}  "
                  f"{st['last50_reward']:14.1f}  {st['goals_last50']:8d}  "
                  f"{st['violation_episodes_last100']:12d}  "
                  f"{str(st['first_goal_episode']):>10s}  "
                  f"{st['env_steps']:9d}  {st['converged']}")

    table("reference", ref)
    table("port", port)
    band_port = [s for s in list(seeds) + list(fallback)
                 if s in port and port[s]["complete"]]
    r_port = [port[s]["last50_reward"] for s in band_port]
    r_ref = [st["last50_reward"] for st in ref.values()]
    mwu = None
    if len(r_port) >= 2 and len(r_ref) >= 2:
        from scipy.stats import mannwhitneyu

        u = mannwhitneyu(r_port, r_ref, alternative="two-sided")
        mwu = {"u": float(u.statistic), "p": float(u.pvalue),
               "n_port": len(r_port), "n_ref": len(r_ref)}
    summary = {
        "verdict": result,
        "port_converged": sum(port[s]["converged"] for s in band_port),
        "port_complete": len(band_port),
        "port_median_last50_reward": (float(np.median(r_port))
                                      if r_port else None),
        "ref_converged": sum(st["converged"] for st in ref.values()),
        "ref_seeds": len(ref),
        "ref_median_last50_reward": (float(np.median(r_ref)) if r_ref
                                     else None),
        "mann_whitney_u": mwu,
        "rules": {"converged": {"last50_reward": CONVERGED_REWARD,
                                "goals_last50": CONVERGED_GOALS,
                                "violation_episodes_last100":
                                    CONVERGED_VIOLATIONS},
                  "pass": {"converged": f"{PASS_CONVERGED} of "
                                        f"{len(seeds)}",
                           "median_last50_reward": PASS_MEDIAN,
                           "fallback_at": FALLBACK_AT,
                           "fallback_converged":
                               f"{FALLBACK_CONVERGED} of "
                               f"{len(seeds) + len(fallback)}"}},
        "port": {f"s{s}": st for s, st in port.items()},
        "reference": {f"s{s}": st for s, st in ref.items()},
    }
    print(f"port: {summary['port_converged']} of {summary['port_complete']} "
          f"complete seeds converged, median last-50 reward "
          f"{summary['port_median_last50_reward']}; reference: "
          f"{summary['ref_converged']} of {summary['ref_seeds']}, median "
          f"{summary['ref_median_last50_reward']}")
    if mwu is not None:
        print(f"Mann-Whitney U (two-sided, last-50 rewards, port against "
              f"reference; not a gate): U {mwu['u']:.1f}, p {mwu['p']:.4g}")
    band = episodes == preset["episodes"]
    print(f"band verdict: {result}" if band else
          f"verdict at {episodes} episodes (the band's rules on each seed's "
          f"first {episodes}; not the band): {result}", flush=True)
    if args.json != "-":
        path = args.json or os.path.join(
            args.port, "judge.json" if band else f"judge_ep{episodes}.json")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        _write_atomic(path, json.dumps(summary, indent=1) + "\n")
    return 0


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="train the band's seeds through the CLI")
    r.add_argument("--preset", default="unicycle", choices=sorted(PRESETS))
    r.add_argument("--seeds", type=int, nargs="+", default=None,
                   help="seeds to train (default: the band's 12)")
    r.add_argument("--episodes", type=int, default=None,
                   help="episodes a seed (default: the preset's budget)")
    r.add_argument("--chunk", type=int, default=25,
                   help="episodes a chunk (a process that resumes the "
                        "last chunk's checkpoint)")
    r.add_argument("--per_card", type=int, default=3,
                   help="processes sharing a card")
    r.add_argument("--time_limit", type=float, default=None,
                   help="seconds; at the limit running chunks are cut "
                        "(their rows dropped) and the call ends")
    r.add_argument("--out", default=os.path.join(ROOT, "results",
                                                 "torch_band", "unicycle"))
    r.add_argument("--work", default=os.path.join(ROOT, "band_work",
                                                  "unicycle"),
                   help="checkpoints and the chunks' run directories")
    r.add_argument("--carry_mb", type=float, default=None,
                   help="at the end, keep unfinished seeds' checkpoints "
                        "(the furthest first) up to this many MiB and "
                        "start the rest afresh")
    r.add_argument("--cpu", action="store_true",
                   help="train on the CPU at tiny widths (a check of the "
                        "script, not a band)")
    r.add_argument("--cli_args", default="",
                   help="more flags for every CLI process (checks only; "
                        "the band runs the preset's defaults)")
    j = sub.add_parser("judge", help="hold the port's seeds to the band")
    j.add_argument("--preset", default="unicycle", choices=sorted(PRESETS))
    j.add_argument("--port", default=os.path.join(ROOT, "results",
                                                  "torch_band", "unicycle"))
    j.add_argument("--episodes", type=int, default=None,
                   help="judge each seed's first N episodes (default: the "
                        "preset's budget, the band)")
    j.add_argument("--json", default=None,
                   help="where to write judge.json (default under --port; "
                        "'-' writes none)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    return cmd_run(args) if args.cmd == "run" else cmd_judge(args)


if __name__ == "__main__":
    sys.exit(main())
