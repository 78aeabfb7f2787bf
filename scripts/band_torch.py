#!/usr/bin/env python3
"""The port's band: seeds of a preset trained through ``nlbac-train-torch``
over the preset's whole budget, judged against the JAX package's recorded
seeds.

    python3 scripts/band_torch.py run [--preset P] [--per_card 3]
        [--chunk 25] [--seeds S ...] [--time_limit SECONDS] [--cpu]
    python3 scripts/band_torch.py judge [--preset P] [--port DIR]
        [--episodes N]
    python3 scripts/band_torch.py rules

``run`` trains each seed as its own ``python -m nlbac_tpu_torch.train.cli
--preset P --seed S --quiet`` process at the preset's defaults
(full widths, its episodes, steps and warm-up), at most ``--per_card``
processes a card over every card present, each pinned to its card by
``CUDA_VISIBLE_DEVICES``. A seed trains in chunks of ``--chunk`` episodes:
chunk k runs ``--max_episodes k*C --resume <the last chunk's
checkpoint>``, and the CLI writes a checkpoint at a chunk's last
episode. A chunk counts once its process has ended with every row and a
checkpoint at its last episode: only then are its rows added to the seed's
``progress.txt`` under ``--out`` (``s<seed>/progress.txt``, the JAX CLI's
columns, and ``s<seed>/run.json``: the card and its power limit, the
host's cores and CPU model, the processes a card, env steps, seconds,
env-steps/s, the chunks). A chunk
that is cut (``--time_limit``, SIGTERM, a failed process) leaves no row,
and a later ``run`` continues every seed from its last kept checkpoint,
which lives packed under ``--work`` with the chunks' own run directories (a
seed with no work state is done when its ``--out`` files hold every
episode, and starts from episode 0 otherwise: its partial rows are then
read against the rerun's, and ``run.json``'s ``rerun`` gives the first
episode whose row differs, or null). Under ``--time_limit`` each chunk,
a seed's first too, is shortened to end before it: every episode counted
at the preset's ``max_episode_steps``, at the seconds an env step of the
seed's own last kept chunk (else of the newest chunk any seed of the run
kept; with neither the chunk stays as asked), a quarter to spare, plus
that chunk's start-up; where not one episode fits, no chunk starts and
its slot stays idle. Several ``run``s of one preset may share ``--work``
and ``--out`` at once when their seeds differ. Without
a card it raises unless ``--cpu`` is given; ``--cpu`` trains at tiny
widths and only checks the script.

``judge`` reads the port's and the reference's ``progress.txt`` files,
prints a row per seed (last-50 reward, goals in the last 50, episodes
with ``safety_cost_train > 0`` in the last 100, first episode with a
goal, env steps; ``scripts/r9_analyze.py``'s definitions; and how a
complete seed that is not converged missed: a ``graze`` meets the reward
and goals limits and breaks the violation limit, a ``collapse`` breaks the
reward or goals limit, as does a short seed whose rows already break the
goals limit; a report, which no rule reads), the verdict
of the band rules below and two-sided Mann-Whitney U tests of the
last-50 rewards and of the violation episodes in the last 100, port
against reference (reported, not gates), and writes ``judge.json`` under
``--port`` (each seed's figures there also give its violation episodes
and its backup controller's mean steps an episode in each 50, its safety
cost over the last 100 and the multipliers ``rho`` and ``lam_max``
there). ``--episodes N`` takes every seed's first N episodes, both
sides, for a reading before the budget ends (not the band). While band
seeds are short, the verdict is ``fail`` once no outcome of theirs can
pass (a short seed whose rows already break a count limit over the
window that ends at the budget, as more than 5 violation episodes in
unicycle's episodes 100-199, is a miss), and ``pass`` once every short
seed is such a miss and every last-50 reward they could end at passes;
otherwise it is ``incomplete``, and ``judge`` prints (and ``judge.json``
holds under ``short_seeds`` and ``outcomes``) what each number of misses
among them leads to: ``pass``,
``fallback`` with the fallback seeds' converged count that a pass then
needs, or ``fail``.

Band rules (``PRESETS[p]["rules"]``), each from the preset's 16 recorded
reference seeds (12345-12348 and 100-111). A seed is converged when it
meets the preset's limits; a statistic on which converged reference seeds
reach 100 violation episodes is left out, and cars has no goal. Each
limit sits at the lowest converged reference seed's figure, its reward
rounded down to a multiple of 10 (as unicycle's 640 sits under s111's
649.1):

- unicycle: last-50 reward >= 640, >= 49/50 goals in the last 50 and <= 5
  violation episodes in the last 100 (15 of 16; s12345 is not);
- cars: last-50 reward >= 80 (16 of 16, the lowest s12348's 81.3; stable
  seeds spread over 0-83 violation episodes, so no count is held);
- pvtol: last-50 reward >= 1490 and 50/50 goals (15 of 16, the lowest
  1496.8; s105, which never took off, is not);
- nbc_unicycle: last-50 reward >= 490 and >= 49/50 goals (16 of 16, the
  lowest 499.4 and 49);
- nbc_pvtol: last-50 reward >= 1390 and >= 47/50 goals (15 of 16, the
  lowest s103's 1395.6 and 47; s104 is not).

The port passes with >= 10 of its 12 seeds converged and a median last-50
reward >= the preset's floor: unicycle 684, cars 130, pvtol 1498.1,
nbc_unicycle 659, nbc_pvtol 1497. With exactly 3 seeds not converged,
seeds 108-111 are run too, and the port then passes with >= 13 of 16
converged and the same median floor. Each floor other than unicycle's
(kept as first set) is the highest at which 12 seeds drawn with replacement
from the reference's 16 (and 4 more for the fallback) miss the pass
under 4.5% of the time (the next step up of the median of 12 draws
misses 4.9-5.0%); ``rules`` (20000 draws, seed 0) gives unicycle 1.785%,
cars 4.025%, pvtol 2.775%, nbc_unicycle 3.335%, nbc_pvtol 2.810%. Cars'
last-50 rewards have two modes (about 150 and about 230) and a low tail
of four seeds at 81-117; a median of 12 draws under 130 needs about half
of them from that tail. The reference's own 12 band seeds, every last-50 reward lowered by
the same amount, stop passing at a drop of: unicycle 8.01, cars 19.41,
pvtol 0.45, nbc_unicycle 22.83, nbc_pvtol 1.56 (``rules``; the median
floor binds first in each).

This script imports neither JAX nor the JAX package; it reaches the port
only through the CLI's processes.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import lzma
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

BAND_SEEDS = (12345, 12346, 12347, 12348) + tuple(range(100, 108))
FALLBACK_SEEDS = (108, 109, 110, 111)

# r9_analyze.py's windows: last-50 reward and goals, violation episodes
# (safety_cost_train > 0) in the last 100
LAST_REWARD, LAST_GOALS, LAST_VIOLATIONS = 50, 50, 100
# a converged seed's statistics and the way each is held to its limit
CONVERGED_CHECKS = {"last50_reward": ">=", "goals_last50": ">=",
                    "violation_episodes_last100": "<="}
# the limits whose break makes a miss a collapse (the rest: a graze)
MISS_MODE_COLLAPSE = ("last50_reward", "goals_last50")
# the bootstrap of the pass rules: draws of 16 seeds and the draws' seed
DRAWS, DRAW_SEED = 20000, 0
# the resolution of the smallest uniform reward drop that fails a band
DROP_STEP = 0.01
# the episodes of a window of judge.json's violation episodes by window;
# the multipliers' columns (the JAX CLI's later runs write them)
WINDOW = 50
MULTIPLIERS = ("rho", "lam_max")


def _rules(converged, pass_median, pass_converged=10, fallback_at=3,
           fallback_converged=13):
    """A preset's band rules: ``converged`` maps statistics of
    CONVERGED_CHECKS to their limits (a statistic left out is not held);
    the port passes with >= ``pass_converged`` of its 12 seeds converged
    and a median last-50 reward >= ``pass_median``; with exactly
    ``fallback_at`` seeds not converged the fallback seeds are run too,
    and then >= ``fallback_converged`` of 16 and the median decide."""
    return {"converged": converged, "pass_median": pass_median,
            "pass_converged": pass_converged, "fallback_at": fallback_at,
            "fallback_converged": fallback_converged}


def _ref(preset, run):
    return (f"results/r9/seeds/{preset}/{run}-run1",
            f"results/r9/{preset}_8seed/{run}-run1",
            f"results/r10/{preset}_seeds")


# preset -> its budget and its longest episode (nlbac_tpu_torch/config.py),
# the band's seeds (the r9 seed numbers; the port's Philox streams differ
# from the reference's threefry ones, so the numbers match only by
# convention), the fallback seeds, the reference's recorded seed
# directories (each holds s<seed>/progress.txt) and the band rules (see the
# module docstring)
PRESETS = {
    "unicycle": {
        "episodes": 200, "max_episode_steps": 1200,
        "seeds": BAND_SEEDS, "fallback": FALLBACK_SEEDS,
        "ref": _ref("unicycle", "unicycle"),
        "rules": _rules({"last50_reward": 640.0, "goals_last50": 49,
                         "violation_episodes_last100": 5}, 684.0),
    },
    "cars": {
        "episodes": 200, "max_episode_steps": 300,
        "seeds": BAND_SEEDS, "fallback": FALLBACK_SEEDS,
        "ref": _ref("cars", "cars"),
        "rules": _rules({"last50_reward": 80.0}, 130.0),
    },
    "pvtol": {
        "episodes": 400, "max_episode_steps": 2000,
        "seeds": BAND_SEEDS, "fallback": FALLBACK_SEEDS,
        "ref": _ref("pvtol", "pvtol"),
        "rules": _rules({"last50_reward": 1490.0, "goals_last50": 50},
                        1498.1),
    },
    "nbc_unicycle": {
        "episodes": 200, "max_episode_steps": 1200,
        "seeds": BAND_SEEDS, "fallback": FALLBACK_SEEDS,
        "ref": _ref("nbc_unicycle", "unicycle"),
        "rules": _rules({"last50_reward": 490.0, "goals_last50": 49},
                        659.0),
    },
    "nbc_pvtol": {
        "episodes": 210, "max_episode_steps": 2000,
        "seeds": BAND_SEEDS, "fallback": FALLBACK_SEEDS,
        "ref": _ref("nbc_pvtol", "pvtol"),
        "rules": _rules({"last50_reward": 1390.0, "goals_last50": 47},
                        1497.0),
    },
}
# the default preset's pass median (unicycle's)
PASS_MEDIAN = PRESETS["unicycle"]["rules"]["pass_median"]
# --cpu: tiny widths, a check of the script and not a band
CPU_ARGS = ("--cpu", "--hidden_size", "16", "--max_episode_steps", "40",
            "--batch_size", "8", "--start_steps", "10")

# OMP_NUM_THREADS of each CLI process: its card's work is issued by one
# Python thread, and several processes share the host's cores, which
# each process's own intra-op pool would otherwise all claim
THREADS = 1

_TIMER = re.compile(r"time/(\w+): ([0-9.]+)s")

# a kept checkpoint's packed form, and the ``.npz`` it is unpacked to for
# the next chunk's ``--resume``
PACKED = ".xz"
RESUME = "resume.npz"


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


def _planes(a):
    """An array's bytes as byte planes: a 2-D array column by column, and
    byte k of every item together (a replay column's slowly changing
    high bytes then sit side by side, where lzma finds them)."""
    a = np.ascontiguousarray(a.T if a.ndim == 2 else a.reshape(-1))
    return a.view(np.uint8).reshape(-1, a.itemsize).T.tobytes()


def _from_planes(buf, dtype, shape):
    dtype = np.dtype(dtype)
    flat = np.frombuffer(buf, np.uint8).reshape(dtype.itemsize, -1).T
    flat = np.ascontiguousarray(flat).view(dtype)
    if len(shape) == 2:
        return np.ascontiguousarray(flat.reshape(shape[::-1]).T)
    return flat.reshape(shape)


def unpack_arrays(path):
    """The arrays of a checkpoint that ``pack_checkpoint`` packed."""
    with lzma.open(path, "rb") as f:
        data = bytearray(f.read())  # writable arrays
    n = int.from_bytes(data[:8], "little")
    off, arrays = 8 + n, {}
    for h in json.loads(data[8:off]):
        if "same_as" in h:
            arrays[h["name"]] = arrays[h["same_as"]]
            continue
        arrays[h["name"]] = _from_planes(data[off:off + h["bytes"]],
                                         h["dtype"], h["shape"])
        off += h["bytes"]
    return arrays


def pack_checkpoint(path, out):
    """Write the checkpoint ``path`` (``.npz``) to ``out`` packed,
    lossless: an array equal to an earlier one (the NODE replay repeats
    the RL replay's rows) is stored once, the rest as byte planes under
    lzma, well under the deflated ``.npz``. The packed file is read back
    and compared before it takes the name ``out``."""
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    header, blobs, seen = [], [], {}
    for name, a in arrays.items():
        key = (a.dtype.str, a.shape, hashlib.sha256(a.tobytes()).digest())
        if key in seen:
            header.append({"name": name, "same_as": seen[key]})
            continue
        seen[key] = name
        blobs.append(_planes(a))
        header.append({"name": name, "dtype": a.dtype.str,
                       "shape": list(a.shape), "bytes": len(blobs[-1])})
    head = json.dumps(header).encode()
    tmp = f"{out}.tmp{os.getpid()}"
    with lzma.open(tmp, "wb") as f:
        f.write(len(head).to_bytes(8, "little") + head)
        for blob in blobs:
            f.write(blob)
    back = unpack_arrays(tmp)
    if list(back) != list(arrays) or any(
            b.dtype != a.dtype or b.shape != a.shape
            or b.tobytes() != a.tobytes()
            for a, b in zip(arrays.values(), back.values())):
        os.remove(tmp)
        raise RuntimeError(f"{path}: its packed form reads back unlike it")
    os.replace(tmp, out)


def cards_present():
    """The indices of the cards ``nvidia-smi`` lists (none without a card
    or a driver); the parent process needs no CUDA context of its own."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=index",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return [int(i) for i in out.stdout.split()] if out.returncode == 0 \
        else []


def card_line(index):
    """``nvidia-smi``'s name and power limit of card ``index``."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(index)],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0]


def cpu_model():
    """The host's CPU model, as ``/proc/cpuinfo`` names it (None where it
    names none), so that a slow run can be told from a slow host."""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return None


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
        self.resume = os.path.join(self.work, RESUME)
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
            # a rerun from episode 0: its rows are read against these
            self.state["earlier"] = {"header": header, "rows": rows}
            self.state["rerun"] = {"earlier_episodes": len(rows),
                                   "compared_episodes": 0,
                                   "first_differing_episode": None}
            self.save_state()
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
               "rerun": self.state.get("rerun"),
               "cards": sorted({c["card"] for c in chunks}),
               "host_cores": sorted({c["host_cores"] for c in chunks
                                     if "host_cores" in c}),
               "cpu_models": sorted({c["cpu_model"] for c in chunks
                                     if c.get("cpu_model")}),
               "processes_per_card": sorted({c["processes_per_card"]
                                             for c in chunks}),
               "chunks": chunks}
        _write_atomic(os.path.join(self.out, "run.json"),
                      json.dumps(run, indent=1) + "\n")

    def commit(self, header, rows, checkpoint, steps, record):
        """Keep a completed chunk: its checkpoint (packed,
        ``pack_checkpoint``: about 5 MiB at full width against 11-14
        deflated, so that more unfinished seeds fit what a later call is
        handed; the next chunk resumes from it unpacked), then the state
        (the commit point), then the files under ``--out``."""
        name = f"checkpoint_ep{self.done + len(rows)}{PACKED}"
        pack_checkpoint(checkpoint, os.path.join(self.work, name))
        os.remove(checkpoint)
        old = self.checkpoint()
        self.state["header"] = self.state["header"] or header
        self.compare_earlier(header, rows)
        self.state["rows"] += rows
        self.state["checkpoint"] = name
        self.state["env_steps"] += steps
        self.state["chunks"].append(record)
        self.save_state()
        if old is not None and os.path.exists(old):
            os.remove(old)
        self.write_out()

    def compare_earlier(self, header, rows):
        """Read a rerun's new rows against the earlier run's rows of the
        same episodes (the same ``%.6g`` text fields) and keep the first
        episode where they differ (None while they agree)."""
        earlier, rerun = self.state.get("earlier"), self.state.get("rerun")
        if earlier is None:
            return
        old = earlier["rows"][self.done:self.done + len(rows)]
        if earlier["header"] != header:
            first = self.done if old else None
        else:
            first = next((self.done + i for i, (a, b) in
                          enumerate(zip(rows, old))
                          if a.split("\t") != b.split("\t")), None)
        known = rerun["first_differing_episode"]
        if first is not None and (known is None or first < known):
            rerun["first_differing_episode"] = first
        if old:
            rerun["compared_episodes"] = max(rerun["compared_episodes"],
                                             self.done + len(old))

    def save_state(self):
        _write_atomic(self.state_path, json.dumps(self.state) + "\n")


def _chunk_timers(log_path):
    """The CLI's phase timers (seconds) from its summary lines."""
    with open(log_path, errors="replace") as f:
        return {k: float(v) for k, v in _TIMER.findall(f.read())}


class Runner:
    """Runs the seeds' chunks on card slots until every seed has its
    episodes, the time limit passes or a stop is asked for. ``clock`` gives
    the seconds the time limit is read on."""

    def __init__(self, args, seeds, slots, card_names, call,
                 clock=time.monotonic):
        self.args = args
        self.queue = list(seeds)
        self.slots = slots
        self.card_names = card_names
        self.call = call
        self.clock = clock
        self.lock = threading.Lock()
        self.stop = threading.Event()
        self.deadline = (clock() + args.time_limit
                         if args.time_limit else None)
        self.failed = []
        self.cut = []
        # (seed, episode) of each chunk not started for want of time
        self.idle = []
        # the records of the chunks this run kept, oldest first
        self.kept = []

    def expired(self):
        return self.stop.is_set() or (
            self.deadline is not None and self.clock() > self.deadline)

    def episode_steps(self):
        """The most env steps an episode of this run's processes takes: the
        preset's ``max_episode_steps``, or the last ``--max_episode_steps``
        that ``--cpu`` or ``--cli_args`` passes them."""
        flags = ((list(CPU_ARGS) if self.args.cpu else [])
                 + self.args.cli_args.split())
        steps = PRESETS[self.args.preset]["max_episode_steps"]
        for flag, value in zip(flags, flags[1:]):
            if flag == "--max_episode_steps":
                steps = int(value)
        return steps

    def rate(self, seed):
        """(train seconds an env step, start-up seconds) of the seed's own
        last kept chunk, else of the newest chunk that any seed of this run
        kept; None where neither has one."""
        with self.lock:
            newest = self.kept[-1:]
        for c in seed.state["chunks"][-1:] + newest:
            if c["train_seconds"] > 0 and c["env_steps"] > 0:
                return (c["train_seconds"] / c["env_steps"],
                        max(0.0, c["seconds"] - c["train_seconds"]))
        return None

    def fit(self, seed, start, end):
        """Under a time limit, shorten the chunk so that it ends before the
        deadline: each episode bounded by ``episode_steps`` at ``rate``'s
        seconds an env step with a quarter to spare, plus its process's
        start-up. Returns ``start`` (start no chunk) when not one such
        episode fits; without a rate the chunk stays as asked."""
        rate = self.rate(seed) if self.deadline is not None else None
        if rate is None:
            return end
        per_step, startup = rate
        per_episode = 1.25 * per_step * self.episode_steps()
        left = self.deadline - self.clock() - startup
        return start + max(0, min(end - start, int(left / per_episode)))

    def command(self, seed, end):
        cmd = [sys.executable, "-m", "nlbac_tpu_torch.train.cli",
               "--preset", self.args.preset, "--seed", str(seed.seed),
               "--quiet", "--max_episodes", str(end),
               "--output", os.path.join(seed.work, "chunk")]
        if seed.done:
            cmd += ["--resume", seed.resume]
        if self.args.cpu:
            cmd += list(CPU_ARGS)
        return cmd + self.args.cli_args.split()

    def chunk(self, seed, card):
        """Run seed's next chunk on ``card`` (None: the CPU). Returns True
        when the chunk was kept, False when it was not, and None when no
        episode fits before the deadline (no chunk started)."""
        start, end = seed.done, min(seed.done + self.args.chunk,
                                    self.args.episodes)
        end = self.fit(seed, start, end)
        if end <= start:
            with self.lock:
                self.idle.append((seed.seed, start))
            return None
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]),
            OMP_NUM_THREADS=str(THREADS))
        if card is not None:
            env["CUDA_VISIBLE_DEVICES"] = str(card)
        shutil.rmtree(os.path.join(seed.work, "chunk"), ignore_errors=True)
        if seed.done:
            np.savez(seed.resume, **unpack_arrays(seed.checkpoint()))
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
                  "host_cores": len(os.sched_getaffinity(0)),
                  "cpu_model": cpu_model(),
                  "processes_per_card": self.args.per_card,
                  "cards_in_call": len(self.card_names),
                  "call": self.call, "cli_args": self.args.cli_args}
        t0 = time.monotonic()
        seed.commit(header, rows, ckpt, steps, record)
        with self.lock:
            self.kept.append(record)
        shutil.rmtree(os.path.join(seed.work, "chunk"), ignore_errors=True)
        if os.path.exists(seed.resume):
            os.remove(seed.resume)
        print(f"s{seed.seed}: episodes {start}..{end - 1} kept, {steps} env "
              f"steps in {seconds:.1f} s on card {card} "
              f"({self.card_names[card]}); checkpoint packed to "
              f"{os.path.getsize(seed.checkpoint()) / 2 ** 20:.2f} MiB, "
              f"kept in {time.monotonic() - t0:.1f} s", flush=True)
        return True

    def slot_loop(self, card):
        while not self.expired():
            with self.lock:
                if not self.queue:
                    return
                seed = self.queue.pop(0)
            while seed.done < self.args.episodes and not self.expired():
                kept = self.chunk(seed, card)
                if kept is None:
                    # the slot stays idle, its core left to the others
                    return
                if not kept:
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
    args.out = args.out or results_dir(args.preset)
    args.work = args.work or os.path.join(ROOT, "band_work", args.preset)
    seeds = args.seeds or list(preset["seeds"])
    if args.cpu:
        cards = [None]
        names = {None: "cpu"}
    else:
        present = cards_present()
        if not present:
            raise SystemExit("band_torch.py run: no CUDA device (pass --cpu "
                             "to check the script at tiny widths)")
        visible = os.environ.get("CUDA_VISIBLE_DEVICES")
        cards = ([int(c) for c in visible.split(",") if c.strip()]
                 if visible else present)
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
    if args.carry_only:
        if args.carry_mb is None:
            raise SystemExit("band_torch.py run: --carry_only needs "
                             "--carry_mb")
        carry(band, args)
        return 0
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
                if c["call"] == runner.call)
    # read again: another run of the same work directory (other seeds) may
    # have ended meanwhile
    if os.path.exists(call_path):
        with open(call_path) as f:
            calls = json.load(f)
    calls.append({"seconds": round(seconds, 2), "env_steps": steps,
                  "env_steps_per_s": round(steps / seconds, 3),
                  "cards": [names[c] for c in cards],
                  "host_cores": len(os.sched_getaffinity(0)),
                  "cpu_model": cpu_model(), "call": runner.call,
                  "seeds": [s.seed for s in band],
                  "per_card": args.per_card, "chunk": args.chunk,
                  "cut": runner.cut, "failed": runner.failed,
                  "idle": runner.idle})
    _write_atomic(call_path, json.dumps(calls, indent=1) + "\n")
    for s, a, b, why, log in runner.failed:
        print(f"s{s}: episodes {a}..{b - 1} failed: {why} (log {log})",
              flush=True)
    for s, a in runner.idle:
        print(f"s{s}: no chunk from episode {a}: not one episode fits "
              f"before the deadline (its slot left idle)", flush=True)
    if args.carry_mb is not None:
        carry(band, args)
    left = [s.seed for s in band if s.done < args.episodes]
    print(f"band run: {steps} env steps in {seconds:.1f} s "
          f"({steps / seconds:.2f} env-steps/s over the call); seeds "
          f"short of {args.episodes} episodes: {left}", flush=True)
    if runner.failed:
        return 1
    return 3 if left else 0


def tree_bytes(path, skip=()):
    """The bytes of the files under ``path``, those in ``skip`` left out."""
    skip = {os.path.abspath(p) for p in skip}
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files
               if os.path.abspath(os.path.join(d, f)) not in skip)


def carry(band, args):
    """Drop finished seeds' checkpoints; keep the checkpoints of unfinished
    seeds, those with the fewest episodes left first (a dropped seed
    starts again from episode 0, whatever it has spent), while they and
    every other file under ``--carry_dir`` (if given; measured now) sum to
    at most ``--carry_mb``, and start the others afresh (their work and
    kept rows removed), so that what a later call must be handed stays
    within that size."""
    for seed in band:
        if seed.done >= args.episodes and seed.checkpoint() is not None:
            os.remove(seed.checkpoint())
            seed.state["checkpoint"] = None
            seed.save_state()
    short = sorted((s for s in band if 0 < s.done < args.episodes),
                   key=lambda s: (-s.done, -s.state["env_steps"]))
    budget = args.carry_mb * 2 ** 20
    if getattr(args, "carry_dir", None):
        budget -= tree_bytes(args.carry_dir, [s.checkpoint() for s in short])
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
        os.makedirs(seed.work)
        # the next rerun is read against the same earlier rows, and the
        # reading so far is kept
        seed.state = {"seed": seed.seed, "header": None, "rows": [],
                      "checkpoint": None, "env_steps": 0, "chunks": [],
                      **{k: seed.state[k] for k in ("earlier", "rerun")
                         if k in seed.state}}
        seed.save_state()


# ---------------------------------------------------------------- judge


def seed_stats(path, episodes, rules=None):
    """r9_analyze.py's figures of one seed's progress.txt over its first
    ``episodes`` episodes, and whether it is converged under ``rules``
    (default: unicycle's); beside them, not in the rules: the violation
    episodes in each WINDOW episodes, the safety cost summed over the last
    100, the multipliers' means over the last 100 and the backup
    controller's mean steps an episode in each WINDOW episodes (None where
    the file has no such column)."""
    _, _, c = read_progress(path)
    c = {k: v[:episodes] for k, v in c.items()}
    goals = c["goal_met"]
    hit = np.nonzero(goals > 0)[0]
    violated = c["safety_cost_train"] > 0
    stats = {
        "episodes": int(len(c["Episode"])),
        "last50_reward": float(c["reward_train"][-LAST_REWARD:].mean()),
        "goals_last50": int(goals[-LAST_GOALS:].sum()),
        "violation_episodes_last100": int(
            violated[-LAST_VIOLATIONS:].sum()),
        "first_goal_episode": (int(c["Episode"][hit[0]]) if len(hit)
                               else None),
        "env_steps": int(c["episode_steps"].sum()),
        "violation_episodes_by_window": [
            int(violated[i:i + WINDOW].sum())
            for i in range(0, len(violated), WINDOW)],
        "safety_cost_last100": float(
            c["safety_cost_train"][-LAST_VIOLATIONS:].sum()),
        "multipliers_last100": {
            k: (float(c[k][-LAST_VIOLATIONS:].mean()) if k in c else None)
            for k in MULTIPLIERS},
        "backup_steps_by_window": (
            [float(c["backup_steps"][i:i + WINDOW].mean())
             for i in range(0, len(violated), WINDOW)]
            if "backup_steps" in c else None),
    }
    stats["complete"] = stats["episodes"] >= episodes
    stats["converged"] = stats["complete"] and converged(stats, rules)
    doomed = not stats["complete"] and cannot_converge(c, episodes, rules)
    # a short seed whose rows already break the goals limit has collapsed,
    # whatever its reward ends at; one that breaks the violation limit
    # alone may still end a graze or a collapse
    stats["miss_mode"] = miss_mode(stats, rules) or (
        "collapse" if doomed and cannot_converge(
            c, episodes, rules, MISS_MODE_COLLAPSE) else None)
    stats["cannot_converge"] = doomed
    return stats


def cannot_converge(c, episodes, rules=None, keys=None):
    """Whether a short seed's rows ``c`` already break a count limit of
    ``rules`` (of those named in ``keys``, if given) over a window that
    ends at ``episodes``, whatever its remaining episodes bring (a reward
    limit is never decided early)."""
    limits = (rules or PRESETS["unicycle"]["rules"])["converged"]
    if keys is not None:
        limits = {k: v for k, v in limits.items() if k in keys}
    n = len(c["Episode"])
    if "violation_episodes_last100" in limits:
        start = max(0, episodes - LAST_VIOLATIONS)
        seen = int((c["safety_cost_train"][start:] > 0).sum())
        if seen > limits["violation_episodes_last100"]:
            return True
    if "goals_last50" in limits:
        start = max(0, episodes - LAST_GOALS)
        best = int((c["goal_met"][start:] > 0).sum()) + episodes - max(
            n, start)
        if best < limits["goals_last50"]:
            return True
    return False


def _meets(stats, limits):
    return all(stats[k] >= v if CONVERGED_CHECKS[k] == ">=" else
               stats[k] <= v for k, v in limits.items())


def converged(stats, rules=None):
    """Whether a seed's statistics meet ``rules``' converged limits."""
    return _meets(stats, (rules or PRESETS["unicycle"]["rules"])[
        "converged"])


def miss_mode(stats, rules=None):
    """How a complete seed that is not converged missed (a report; no
    rule reads it): ``collapse`` where it breaks the reward or the goals
    limit, ``graze`` where it meets both and breaks the violation limit
    only; None for a converged or short seed."""
    if not stats["complete"] or stats["converged"]:
        return None
    limits = (rules or PRESETS["unicycle"]["rules"])["converged"]
    return "graze" if _meets(stats, {
        k: v for k, v in limits.items() if k in MISS_MODE_COLLAPSE}) \
        else "collapse"


def find_seeds(dirs):
    """{seed: progress.txt} over ``dirs`` (each holding s<seed>/)."""
    found = {}
    for d in dirs:
        for p in sorted(glob.glob(os.path.join(d, "s*", "progress.txt"))):
            m = re.fullmatch(r"s(\d+)", os.path.basename(os.path.dirname(p)))
            if m:
                found[int(m.group(1))] = p
    return found


def _short(stats, seeds):
    """The seeds of ``seeds`` short of their episodes (or not run), those
    that can no longer converge first."""
    short = [s for s in seeds if s not in stats or not stats[s]["complete"]]
    return sorted(short, key=lambda s: not _doomed(stats, s))


def _doomed(stats, seed):
    return bool(stats.get(seed, {}).get("cannot_converge"))


def _decided(main, extra, rules):
    """The verdict of complete band seeds ``main``, with the complete
    fallback seeds ``extra`` held only at exactly ``fallback_at`` misses."""
    missed = sum(not s["converged"] for s in main)
    need, group = rules["pass_converged"], main
    if missed == rules["fallback_at"]:
        group, need = main + extra, rules["fallback_converged"]
    n = sum(s["converged"] for s in group)
    median = float(np.median([s["last50_reward"] for s in group]))
    return ("pass" if n >= need and median >= rules["pass_median"]
            else "fail")


def _reachable(stats, seeds, fallback, rules, band_misses=None):
    """The verdicts that some completion of the short seeds reaches (with
    exactly ``band_misses`` of the short band seeds not converged, if
    given). A short seed that converges scores its last-50 reward anywhere
    from the converged limit (or -inf where none is held) up; one that
    misses, anywhere."""
    floor = rules["converged"].get("last50_reward", -np.inf)

    def fill(group, misses, high):
        # the first ``misses`` short seeds miss, those that cannot
        # converge among them
        order = {s: i for i, s in enumerate(_short(stats, group))}
        out = []
        for s in group:
            if s not in order:
                out.append(stats[s])
                continue
            hit = order[s] >= misses
            out.append({"complete": True, "converged": hit,
                        "last50_reward": np.inf if high else
                        floor if hit else -np.inf})
        return out

    band, fall = _short(stats, seeds), _short(stats, fallback)
    ks = (_miss_counts(stats, seeds) if band_misses is None
          else [band_misses])
    highs = (False, True) if band or fall else (False,)
    return {_decided(fill(seeds, k, high), fill(fallback, j, high), rules)
            for k in ks for j in _miss_counts(stats, fallback)
            for high in highs}


def _miss_counts(stats, group):
    """The numbers of misses that ``group``'s short seeds can end with."""
    short = _short(stats, group)
    return range(sum(_doomed(stats, s) for s in short), len(short) + 1)


def verdict(stats, seeds, fallback, rules=None):
    """The band rules (default: unicycle's) over the port's seeds:
    ``pass``; ``fail``, also before every seed is complete once no
    completion of the short seeds can pass; ``incomplete`` (a band seed
    short of its episodes that may still converge, or short seeds that can
    no longer converge whose rewards decide the median) or ``fallback``
    (exactly ``fallback_at`` seeds not converged and a fallback seed short
    that may still converge) while one can. Short seeds that can no longer
    converge count as misses: with every reward they could end at giving a
    pass, the band passes before they end."""
    rules = rules or PRESETS["unicycle"]["rules"]
    reach = _reachable(stats, seeds, fallback, rules)
    if "pass" not in reach:
        return "fail"
    if _open(stats, seeds):
        return "incomplete"
    missed = sum(not stats[s]["converged"] for s in seeds)
    if missed == rules["fallback_at"] and _open(stats, fallback):
        return "fallback"
    return reach.pop() if len(reach) == 1 else "incomplete"


def _open(stats, group):
    """The seeds of ``group`` short of their episodes that may still
    converge."""
    return [s for s in _short(stats, group) if not _doomed(stats, s)]


def outcomes(stats, seeds, fallback, rules=None):
    """What each number of misses among the short band seeds leads to (at
    least those that cannot converge miss): a row per count with its
    verdict (``pass``, ``fail``, ``pass or fail``
    where the short seeds' rewards decide the median, or ``fallback``,
    then with the fallback seeds' converged count that a pass needs)."""
    rules = rules or PRESETS["unicycle"]["rules"]
    short = _short(stats, seeds)
    known = sum(not stats[s]["converged"] for s in seeds if s not in short)
    rows = []
    for k in _miss_counts(stats, seeds):
        reach = _reachable(stats, seeds, fallback, rules, band_misses=k)
        row = {"misses": k, "verdict": " or ".join(
            v for v in ("pass", "fail") if v in reach)}
        if known + k == rules["fallback_at"] and "pass" in reach:
            done = [stats[s] for s in fallback if s not in _short(
                stats, fallback)]
            row["verdict"] = "fallback"
            row["fallback_converged_needed"] = (
                rules["fallback_converged"] - (len(seeds) - known - k)
                - sum(s["converged"] for s in done))
            row["fallback_short"] = _short(stats, fallback)
        rows.append(row)
    return rows


def reference_stats(name, episodes=None):
    """{seed: seed_stats} of a preset's recorded reference seeds."""
    preset = PRESETS[name]
    episodes = episodes or preset["episodes"]
    return {s: seed_stats(p, episodes, preset["rules"]) for s, p in
            find_seeds([os.path.join(ROOT, d) for d in preset["ref"]]).items()}


def bootstrap_miss(name):
    """How often a port drawn from the reference misses the pass: each of
    DRAWS draws takes 16 of the preset's recorded seeds with replacement,
    the first 12 as the band and the last 4 as the fallback, and judges
    them by the preset's rules."""
    preset = PRESETS[name]
    ref = list(reference_stats(name).values())
    seeds, fallback = preset["seeds"], preset["fallback"]
    order = list(seeds) + list(fallback)
    rng = np.random.default_rng(DRAW_SEED)
    picks = rng.integers(0, len(ref), (DRAWS, len(order)))
    missed = sum(verdict(dict(zip(order, (ref[i] for i in row))), seeds,
                         fallback, preset["rules"]) != "pass"
                 for row in picks)
    return missed / DRAWS


def smallest_failing_drop(name):
    """The smallest drop (a multiple of DROP_STEP) of every last-50 reward
    at which the reference's own 12 band seeds, judged as the port, no
    longer pass."""
    preset = PRESETS[name]
    ref = reference_stats(name)
    band = {s: ref[s] for s in preset["seeds"]}
    for k in range(1, 10 ** 7):
        drop = round(k * DROP_STEP, 10)
        low = {}
        for s, st in band.items():
            st = dict(st, last50_reward=st["last50_reward"] - drop)
            st["converged"] = converged(st, preset["rules"])
            low[s] = st
        if verdict(low, preset["seeds"], preset["fallback"],
                   preset["rules"]) != "pass":
            return drop
    raise ValueError(f"{name}: no drop fails the band")


def rules_record(preset):
    """The rules a judge.json records."""
    r, n, m = (preset["rules"], len(preset["seeds"]),
               len(preset["seeds"]) + len(preset["fallback"]))
    return {"converged": dict(r["converged"]),
            "pass": {"converged": f"{r['pass_converged']} of {n}",
                     "median_last50_reward": r["pass_median"],
                     "fallback_at": r["fallback_at"],
                     "fallback_converged":
                         f"{r['fallback_converged']} of {m}"}}


def results_dir(preset):
    return os.path.join(ROOT, "results", "torch_band", preset)


def cmd_judge(args):
    preset = PRESETS[args.preset]
    episodes = args.episodes or preset["episodes"]
    args.port = args.port or results_dir(args.preset)
    ref = reference_stats(args.preset, episodes)
    port = {s: seed_stats(p, episodes, preset["rules"])
            for s, p in find_seeds([args.port]).items()}
    seeds, fallback = preset["seeds"], preset["fallback"]
    result = verdict(port, seeds, fallback, preset["rules"])
    short = _short(port, seeds)
    table_out = (outcomes(port, seeds, fallback, preset["rules"])
                 if short and result not in ("pass", "fail") else [])

    def table(name, stats):
        print(f"{name}: seed  episodes  last-50 reward  goals/50  "
              f"viol-eps/100  first goal  env steps  converged  miss")
        for s, st in stats.items():
            print(f"{name}: s{s:<6d} {st['episodes']:8d}  "
                  f"{st['last50_reward']:14.1f}  {st['goals_last50']:8d}  "
                  f"{st['violation_episodes_last100']:12d}  "
                  f"{str(st['first_goal_episode']):>10s}  "
                  f"{st['env_steps']:9d}  {str(st['converged']):9s}  "
                  f"{st['miss_mode'] or '-'}")

    table("reference", ref)
    table("port", port)
    band_port = [s for s in list(seeds) + list(fallback)
                 if s in port and port[s]["complete"]]
    r_port = [port[s]["last50_reward"] for s in band_port]
    r_ref = [st["last50_reward"] for st in ref.values()]

    def mann_whitney(key):
        a = [port[s][key] for s in band_port]
        b = [st[key] for st in ref.values()]
        if len(a) < 2 or len(b) < 2:
            return None
        from scipy.stats import mannwhitneyu

        u = mannwhitneyu(a, b, alternative="two-sided")
        return {"u": float(u.statistic), "p": float(u.pvalue),
                "n_port": len(a), "n_ref": len(b)}

    mwu = mann_whitney("last50_reward")
    summary = {
        "preset": args.preset,
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
        "mann_whitney_u_violations": mann_whitney(
            "violation_episodes_last100"),
        "rules": rules_record(preset),
        "short_seeds": short,
        "outcomes": table_out,
        "miss_modes": {f"s{s}": port[s]["miss_mode"]
                       for s in list(seeds) + list(fallback)
                       if s in port and port[s]["miss_mode"]},
        "ref_miss_modes": {f"s{s}": st["miss_mode"]
                           for s, st in ref.items() if st["miss_mode"]},
        "port": {f"s{s}": st for s, st in port.items()},
        "reference": {f"s{s}": st for s, st in ref.items()},
    }
    print(f"port: {summary['port_converged']} of {summary['port_complete']} "
          f"complete seeds converged, median last-50 reward "
          f"{summary['port_median_last50_reward']}; reference: "
          f"{summary['ref_converged']} of {summary['ref_seeds']}, median "
          f"{summary['ref_median_last50_reward']}")
    if mwu is not None:
        v = summary["mann_whitney_u_violations"]
        print(f"Mann-Whitney U (two-sided, port against reference; not a "
              f"gate): last-50 rewards U {mwu['u']:.1f}, p {mwu['p']:.4g}; "
              f"violation episodes in the last 100 U {v['u']:.1f}, p "
              f"{v['p']:.4g}")
    doomed = [s for s in short if _doomed(port, s)]
    if doomed:
        print(f"short seeds that can no longer converge (their rows break "
              f"a count limit already): {', '.join(map(str, doomed))}")
    for row in table_out:
        need = ("" if row["verdict"] != "fallback" else
                f" ({row['fallback_converged_needed']} of "
                f"{', '.join(map(str, row['fallback_short']))} must "
                f"converge)")
        print(f"if {row['misses']} of the short seeds "
              f"{', '.join(map(str, short))} miss: {row['verdict']}{need}")
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
    r.add_argument("--out", default=None,
                   help="default results/torch_band/<preset>")
    r.add_argument("--work", default=None,
                   help="checkpoints and the chunks' run directories "
                        "(default band_work/<preset>)")
    r.add_argument("--carry_mb", type=float, default=None,
                   help="at the end, keep unfinished seeds' checkpoints "
                        "(those with the fewest episodes left first) up "
                        "to this many MiB, --carry_dir's other files "
                        "included, and start the rest afresh")
    r.add_argument("--carry_dir", default=None,
                   help="the directory a later call is handed back, whose "
                        "other files count against --carry_mb (default: "
                        "none; only the checkpoints count)")
    r.add_argument("--carry_only", action="store_true",
                   help="train nothing: only the carry of the seeds, after "
                        "the call's other runs have ended")
    r.add_argument("--cpu", action="store_true",
                   help="train on the CPU at tiny widths (a check of the "
                        "script, not a band)")
    r.add_argument("--cli_args", default="",
                   help="more flags for every CLI process: a check's cuts, "
                        "or --squash xla (the band of the XLA-form squash, "
                        "into its own --out and --work; the band otherwise "
                        "runs the preset's defaults); each chunk record "
                        "keeps them")
    j = sub.add_parser("judge", help="hold the port's seeds to the band")
    j.add_argument("--preset", default="unicycle", choices=sorted(PRESETS))
    j.add_argument("--port", default=None,
                   help="default results/torch_band/<preset>")
    j.add_argument("--episodes", type=int, default=None,
                   help="judge each seed's first N episodes (default: the "
                        "preset's budget, the band)")
    j.add_argument("--json", default=None,
                   help="where to write judge.json (default under --port; "
                        "'-' writes none)")
    sub.add_parser("rules", help="print each preset's rules, how often "
                                 "the reference misses them and the "
                                 "smallest reward drop they fail")
    return p


def cmd_rules(args):
    for name in PRESETS:
        ref = reference_stats(name)
        n = sum(st["converged"] for st in ref.values())
        print(f"{name}: {json.dumps(rules_record(PRESETS[name]))}; "
              f"reference {n} of {len(ref)} converged; bootstrap miss "
              f"{100 * bootstrap_miss(name):.3f}% over {DRAWS} draws (seed "
              f"{DRAW_SEED}); the reference's 12 band seeds fail at a "
              f"uniform drop of {smallest_failing_drop(name):.2f}",
              flush=True)
    return 0


def main(argv=None):
    args = build_parser().parse_args(argv)
    return {"run": cmd_run, "judge": cmd_judge, "rules": cmd_rules}[
        args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
