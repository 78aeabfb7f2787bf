#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nlbac_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

1. the card's name and power limit; the host's CPU model, its cores and a
   fixed host-only probe (``host_info``); TF32 off for matmuls and cuDNN;
2. build the NODE Euler kernel (csrc/node_euler.cu) with nvcc, printing
   ptxas's registers, shared memory and spills per kernel, and count the
   tensor-core (HMMA) instructions in its SASS; then find where
   ``torch.tanh`` first returns 1.0 on the card and on the CPU, and the
   policy's squash term's gap to float64 on each, over |x| in [3, 9.1];
   then the XLA-form tanh (``--squash xla``, ``nn/xla_float.py``) on the
   card against the CPU, bit for bit: forward over a float32 grid on
   [-10, 10], every float32 in [7.9988, 7.9989] and around +-0.0004, and
   its gradient; and the soft target update of a full-width critic on the
   card against the CPU, bit for bit;
3. hold the kernel against its plain PyTorch version on the card, forward
   and gradients, at the rows the main path gives it (128 and 32768), at
   the tile edges (1, 16, 17, 127, 129), at a ragged 1000 and at the
   switch between the small and large tiles and one either side, for the
   unicycle (3, 2) and pvtol (6, 2) dimensions;
4. time the kernel and the plain version (CUDA events, median of 30 runs,
   both replayed from a CUDA graph and issued from Python) beside the
   card's least time for the work (its bound, on the tensor cores and on
   the CUDA cores); the host's time per call; the kernel where PVTOL's
   constraint chain calls it (3 chained calls at 256 rows and (6, 2),
   gradients of u_t, x and the parameters, and its time); a sweep of every
   tile configuration over 128 to 32768 rows, each checked against the
   plain version;
5. the main path: train the unicycle preset at its full widths through
   the CLI (``nlbac_tpu_torch.train.cli.main``, into
   ``chiprun_out/chip_smoke/``), the policy acting from the second
   episode, then resume it from its checkpoint.npz for one more episode
   (launch counts reset just before each run, read just after); profile 10 more steps of the restored state (device busy
   share, top device ops); then hold one full-width update on the card
   against the same update on the CPU, and again under ``squash="torch"``;
   then ms per update of the restored state under each squash,
   interleaved (SQUASH_BLOCKS blocks of SQUASH_BLOCK updates each);
6. cars and PVTOL at their full widths through the CLI, each with its
   env-steps/s, and each followed by one full-width update on the card
   against the CPU;
7. the learned-barrier family: K1 held against its plain version at the
   learned barrier's single calls (128 rows (3, 2), 256 rows (6, 2);
   forward and the gradient with respect to u); nbc_unicycle and nbc_pvtol
   at their full widths through the CLI (steps, updates, NODE fits, K1
   launches, env-steps/s, the last barrier_td_loss, barrier.pkl); the
   quadrotor through the CLI with its kill penalty, the mix spawn
   curriculum and both pre-tanh regularizers, resumed episode chunk by
   chunk until it has taken QUAD_MIN_STEPS env steps and QUAD_MIN_UPDATES
   updates (random warm-up thrusts crash it early); each followed by one
   full-width update on the card against the CPU;
8. the adaptive dopri5 solver on the card: ``solve_adaptive`` in its
   ``while`` and ``scan`` forms on the unicycle control-affine field at
   full width (hidden 100) over the NODE's span, at 128 and 32768 rows,
   held against the same call on the CPU (values, time reached, trial
   counts), the adjoint's parameter and y0 gradients held against the
   scan form's autograd gradients, and each form's ms per call;
9. unicycle under ``--node_solver dopri5 --node_adaptive_impl scan``
   through the CLI (steps, updates, fits, integrations that ended short
   of dt, env-steps/s, ms per update), then one full-width update on the
   card against the CPU under the scan form and again under the while
   form;
10. unicycle under ``--host_loop`` (Euler, so K1 runs) through the CLI,
   then ``--resume`` for one more episode: K1 launches, env-steps/s, the
   checkpoint's ``host_loop`` mode, progress.txt from the native writer;
11. unicycle under ``--host_loop --node_solver dopri5`` (the while form
   and the adjoint) through the CLI: env-steps/s and ms per update;
12. evaluation: ``--mode eval`` through the CLI on the unicycle run of
   phase 5, ``python -m nlbac_tpu_torch.utils.evaluate ... --json`` in its
   own process (return, length, violations and ms per episode), and the
   quadrotor run's deterministic rollouts (EVAL_QUAD_STEPS steps) on the
   card against the CPU;
13. export: the unicycle policy exported with ``torch.export`` on the card
   and on the CPU, loaded back (the CPU one moved with ``.to``) and held
   against the policy's deterministic head on the card; host µs per call;
14. profile: unicycle through the CLI with ``--profile_dir``: the trace of
   the second episode must hold K1's kernel (the trace is then removed);
15. the point-mass envs of examples/torch_custom_env.py (a hand-written
   CBF) and examples/torch_custom_barrier_env.py (a learned barrier),
   registered at runtime, trained on the card (K1 on their path; the
   barrier critic's TD loss must move off zero);
16. the parallel modes: ``--n_seeds SEEDS`` through the CLI's
   ``train_multi_seed`` (worker processes) at the main path's depth, the
   policy acting from the second episode on (each seed's env steps,
   updates and K1 launches, the aggregate env-steps/s beside phase 5's
   one-seed run, seed 0's first episode against phase 5's); then a dp=2
   and a tp=2 gang of two ranks sharing the card over gloo
   (``make_dp_episode_runner`` / ``make_tp_episode_runner``; both
   layouts, GANG_LAYOUTS, in one spawn of the two ranks), each one
   full-width unicycle episode of GANG_STEPS steps, the policy acting
   from the first update on, against one rank from the same state and
   seed: the reward and the whole state
   within ``tests/test_parallel.py``'s tolerances, the Adam moments and
   the last update's losses near one rank's, the ranks' states
   bit-equal, K1's launches per dp rank those of one rank at half the
   rows, none under tp;
17. ``--node_solver dopri5`` in gangs: a dp=2 and a tp=2 gang of two
   ranks on the card over gloo (both in one spawn, as in phase 16), each
   one full-width unicycle episode per
   form (``while``, ``scan``) of DOPRI5_GANG_STEPS steps whose first
   update fits the NODE on the full 32768 rows, against one rank: the
   reward, the state and the Adam moments, the ranks' bit-equality and
   trial steps, ms per update (each timed alone) against one rank's;
18. the experimental levers (``nlbac_tpu_torch.experimental``) at full
   unicycle width: on the card, the stacked twin-Q update against the
   plain one, the fused gather's batches against the default path's
   given the same index draws, the decoupled agent's TD losses against
   the default's; then the default update block interleaved with the
   stacked, decoupled and fused-gather blocks from the main path's state,
   LEVER_BLOCKS each: ms per block (median) and the ratio to the default,
   K1's launches on each path;
19. one full-width unicycle update with the NODE in bf16 on the card (the
   plain bf16 field, no K1) against the CPU;
20. start-up: a fresh process (``chip_smoke.py --startup``, on a copy of
   the package) from its spawn to its first update's end through
   ``cached_episode_runner``, with ``_build/`` empty and then warm, split
   into import, set-up, K1's library and the first episode;
21. the lockstep seed runner (``parallel.make_seed_parallel_runner``):
   K1 seed-batched (LOCKSTEP_KERNEL: seeds x rows) against its plain
   version and against one launch per seed (forward and gradients),
   timed beside them, beside its bound and with both tile
   configurations; then SEEDS unicycle seeds at full width in one
   seed-batched episode loop with phase 16's seeds and argv, each seed's
   first episode against phase 16's same seed (relative 1e-5), its later
   episodes and node_loss within the larger of LOCKSTEP_LATER_RTOL and
   NOISE_FACTOR times the float32 noise floor of that episode and metric,
   which a run of LOCKSTEP_BIG seeds measures in the same call (seeds
   SEED..SEED+3 and their twins, every weight one ulp up, drawing from
   the same seeds); one lockstep update of the trained seeds at different
   update counts against each seed's one-seed update on the card;
   K1's launches per update (two at SEEDS x 128 rows, a SEEDS x 32768
   fit when a seed fits), the aggregate env-steps/s of both runs beside
   phase 16's and phase 5's, ms per lockstep update, and a
   ``torch.profiler`` window's device busy share;
22. the lockstep seed runner over the other presets: K1 seed-batched at
   SEEDS seeds where their constraints call it (PVTOL's chain of three
   calls at SEEDS x 256 rows (6, 2), gradients of u_t, x and the
   parameters; the learned barrier's one call at SEEDS x 128 (3, 2) and
   SEEDS x 256 (6, 2)) against the plain version, timed beside SEEDS
   single launches a call and the bound; then cars, PVTOL (its supervisor
   from episode 0), nbc_unicycle, nbc_pvtol and the quadrotor (QUAD_FLAGS)
   in ``make_seed_parallel_runner`` at SEEDS seeds, one episode each (the
   quadrotor until every seed has LOCKSTEP_QUAD_UPDATES updates), the
   policy acting in its second half: each seed's steps and updates, K1's
   launches against its count per lockstep update, the aggregate
   env-steps/s beside one seed's run of the same episodes, and
   ``lockstep_update_check`` on the trained seeds;
23. the lockstep seed runner under ``--node_solver dopri5`` and with a
   constraint builder that does not declare ``SEED_AXIS``: (a) the
   adaptive solver with a seed axis on SEEDS x LOCKSTEP_DOPRI5_ROWS rows
   of the unicycle NODE at full width, each seed's weights at its
   LOCKSTEP_DOPRI5_SCALES entry so that the seeds take different trial
   counts, in both forms, against each seed's one-seed solve on the card
   (trials per seed equal, values within LOCKSTEP_DOPRI5_RTOL/ATOL, the
   gradients of the parameters and y0 within LOCKSTEP_DOPRI5_GRAD_FRAC of
   each leaf's largest entry: the adjoint's under ``while`` within phase
   8's ADJOINT_FRAC, the scan form's within its float32 noise, with a
   one-ulp floor beside them), timed against the one-seed solves; (b)
   SEEDS unicycle seeds under each form in the runner for one episode of
   LOCKSTEP_DOPRI5_STEPS steps (every seed updates, the first update
   fits), then ``lockstep_update_check``
   with each seed's short integrations beside its one-seed update's, and
   ms per lockstep update against one seed's (a fit update and
   LOCKSTEP_DOPRI5_TIMED others, in turns); (c) unicycle's builder
   registered again without ``SEED_AXIS``, one Euler episode of
   LOCKSTEP_DOPRI5_STEPS steps: K1's launches against SEEDS a rollout
   call plus the seed-batched fit, and ``lockstep_update_check``;
24. the lockstep seed runner in shards (``make_seed_parallel_runner``
   with a list of devices): LOCKSTEP_SHARDS x SEEDS unicycle seeds at
   full width as LOCKSTEP_SHARDS worker processes on this one card, at
   phase 21's depth and base seed: the workers' start-up seconds, each
   shard's K1 launches against the count per lockstep update, shard 0
   against phase 21's SEEDS-seed run of the same seeds (its largest gap
   over the episodes and the fetched states; bit for bit expected, else
   held as phase 21 holds its seeds), each seed's first episode against
   phase 21's LOCKSTEP_BIG-seed run where that run holds the seed, the
   aggregate env-steps/s beside phase 21's in-process and one-seed
   rates; then one lockstep update of phase 21's trained seeds with the
   critic in the stacked twin-Q layout against the plain layout
   (UPDATE_RTOL/UPDATE_ATOL);
25. the band's script (``scripts/band_torch.py run``, one CLI process
   a seed, chunks that resume): BAND_SEEDS unicycle seeds at full width
   in chunks of 1 episode of BAND_STEPS steps (``--start_steps``
   BAND_STEPS) to BAND_EPISODES episodes, beside seed SEED's uncut
   run of BAND_EPISODES episodes in a process of its own: seed SEED's
   chunked progress.txt and final checkpoint against the uncut run's,
   bit for bit; then ``band_torch.py judge`` on the chunked seeds (its
   verdict is printed and does not gate: these are not the band's seeds
   or budget);
26. a JSON line of the kernel's numbers (and the tanh, lever, start-up,
   lockstep and band phases'), the script's total time, then the result
   line.

The depth of each CLI run is cut (EPISODES, PRESET_RUNS, NBC_RUNS,
QUAD_*, DOPRI5_RUN, HOST_RUNS, PROFILE_RUN, CUSTOM_RUN, GANG_STEPS,
DOPRI5_GANG_STEPS, STARTUP_STEPS, LOCKSTEP_PRESETS, LOCKSTEP_DOPRI5_STEPS
below; phase 21's and 24's lockstep runs take the main path's EPISODES x
EPISODE_STEPS); the widths are the presets'.

``python3 chip_smoke.py --squash`` runs only the squash's checks: the
card's line, the kernel's build, phase 2's XLA-form tanh and soft update
checks, then a SQUASH_RUN unicycle run through the CLI under ``--squash
xla`` and phase 5's squash checks on its state (a quick check before a
band under ``--squash xla``).

Needs a CUDA device; it exits nonzero without printing a result when there
is none, or when the ``nlbac_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import collections
import dataclasses
import importlib.util
import itertools
import json
import math
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import torch

import numpy as np

from nlbac_tpu_torch import experimental, runtime_native
from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.agent.state import make_optimizers
from nlbac_tpu_torch.config import get_config
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import (
    DEFAULT_SQUASH,
    make_field,
    node_init,
    pack_input,
    soft_update,
    twin_q_unstack,
    uses_euler_kernel,
)
from nlbac_tpu_torch.nn.xla_float import xla_tanh
from nlbac_tpu_torch.ode import odeint_adjoint, solve_adaptive, solvers
from nlbac_tpu_torch import parallel
from nlbac_tpu_torch.ops import node_kernel
from nlbac_tpu_torch.replay import create as create_replay
from nlbac_tpu_torch.replay import buffer as replay_buffer
from nlbac_tpu_torch.replay import sample, unpack_rows
from nlbac_tpu_torch.train import cli, create_replays, make_episode_runner
from nlbac_tpu_torch.train.aot import cached_episode_runner
from nlbac_tpu_torch.train.driver import UpdateCarry, episode_to_host
from nlbac_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    restore_host_checkpoint,
)
from nlbac_tpu_torch.train.host_loop import HostRings
from nlbac_tpu_torch.tree import tree_leaves, tree_map

# H100 SXM data-sheet peaks (dense): TF32 on the tensor cores, float32
# outside them, HBM3. The kernel takes three TF32 passes for float32
# accuracy, so its bound is the work at a third of the TF32 rate.
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version on the card, both float32 (torch.allclose form):
# the two sum each layer's 100 products in different orders.
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
# One full-width update on the card vs on the CPU: float32 on both, but
# cuBLAS and the CPU's BLAS sum in different orders and the difference
# passes through Adam's normalisation and the constraint's /dt.
UPDATE_RTOL, UPDATE_ATOL = 1e-3, 1e-4
# Depth of the CLI runs (the presets' widths are kept): unicycle 2
# episodes of 200 steps (preset: 200 of 1200), resumed for a third; cars
# 1 of 300 (preset: 200 of 300); PVTOL 1 of 600 (preset: 400 of 2000).
# Short enough that the whole script ends well within its 1200 s limit on
# a slow host. The unicycle runs take --start_steps one episode (preset:
# 1000), so the first episode's actions are random warm-up draws and the
# second episode and the resumed third are trained and resumed with the
# policy acting.
EPISODES, EPISODE_STEPS = 2, 200
PRESET_RUNS = {"cars": (1, 300), "pvtol": (1, 600)}
# nbc_unicycle 1 episode of 400 steps (preset: 200 of 1200), nbc_pvtol 1
# of 500 (preset: 210 of 2000); the quadrotor in chunks of QUAD_CHUNK
# episodes of at most QUAD_EPISODE_STEPS steps (preset: 210 of 1000).
NBC_RUNS = {"nbc_unicycle": (1, 400), "nbc_pvtol": (1, 500)}
QUAD_CHUNK, QUAD_EPISODE_STEPS = 10, 200
QUAD_MIN_STEPS, QUAD_MIN_UPDATES = 600, 300
QUAD_FLAGS = ["--spawn_curriculum_episodes", "4", "--spawn_curriculum_mode",
              "mix", "--pretanh_reg", "0.001", "--probe_pretanh_reg", "0.01"]
# The resampled controls each constraint chain draws per loss.
RESAMPLES = {"unicycle": 0, "cars": 1, "pvtol": 2, "learned_barrier": 1,
             "unicycle_per_seed": 0}
# The learned barrier's single K1 call: (n_s, n_u) and rows.
NBC_CALLS = {"nbc_unicycle": ((3, 2), 128), "nbc_pvtol": ((6, 2), 256)}
PVTOL_ROWS = 256
# dopri5 on the card vs on the CPU (values; float32 both, different sums,
# and the controller may pick other steps from float32-noise errors, each
# accepted step within the solver's rtol 1e-5): rtol and atol below.
DOPRI5_RTOL, DOPRI5_ATOL = 1e-4, 1e-5
# The adjoint's gradients vs the scan form's, as a fraction of each
# leaf's largest entry: at the NODE's 0.02 span the scan form's gradient
# through the step sizes is float32 noise (up to 1.2e-1 of a leaf's
# largest entry for the fit's loss on the CPU: python3
# scripts/dopri5_probe.py).
ADJOINT_FRAC = 5e-2
DOPRI5_ROWS = (128, 32768)
# dopri5 and host-loop CLI runs (unicycle at full width): (episodes,
# steps per episode). Updates start once the replay holds more than a
# batch (128 rows), 2 per step; start_steps is 1000, so every action is
# random. A dopri5 update takes 0.3-0.8 s over a fit cycle (NVIDIA H100
# 80GB HBM3, 700 W), so those runs stop 6 steps after the first update:
# 12 updates, the NODE fitted at the first and again at the 11th (after
# updates), the multipliers' ascent at the first and the 9th. The
# host loop's Euler episodes were 150 steps and the dopri5 runs 140 (22
# updates, 3 fits in the first episode) until the depth was cut to keep
# the whole script in its time limit.
DOPRI5_RUN = (1, 135)
HOST_RUNS = {"euler": (2, 135), "dopri5": (1, 135)}
# The dopri5 card-vs-CPU update fits the NODE on this many rows (the
# CPU's dopri5 fit on 32768 rows at width 100 takes minutes).
DOPRI5_CHECK_NODE_ROWS = 512
# Warm-up updates, timed updates. Each timed window is a multiple of the
# NODE's update_interval (10), so it holds its share of the 32768-row
# fits wherever it starts; dopri5's window also times each update alone
# to give the fit's cost apart.
DOPRI5_UPDATE_TIMING = (1, 10)
# The squash term's action scales (unicycle v, omega; PVTOL's thrust).
TANH_SCALES = (3.5, 12.0, 15.0)
# The XLA-form tanh on the card against the CPU: a float32 grid over
# [-10, 10], and every float32 within TANH_TINY_ULPS of +-0.0004 (where it
# switches to x); ms per update under each squash in SQUASH_BLOCKS
# interleaved blocks of SQUASH_BLOCK updates (one NODE fit each); the
# --squash mode's CLI run (episodes, steps; --start_steps one episode).
TANH_GRID = 2000001
TANH_TINY_ULPS = 5000
SQUASH_BLOCKS, SQUASH_BLOCK = 3, 10
SQUASH_RUN = (2, 150)
# The quadrotor's card-vs-CPU evaluation stops after this many steps, clear
# of float32 divergence between the two devices' rollouts.
EVAL_QUAD_STEPS = 50
# The exported head on the card vs the policy's own head on the card: the
# same ops on the same device.
EXPORT_ATOL = 1e-6
EXPORT_BATCHES = (1, 7, 128)
# (episodes, steps per episode) of the profiled unicycle run: the first
# episode fills the replay past a batch (128 rows), so the traced second
# one holds updates (from step 130 of the run on) and K1's launches; and
# of each custom env's run.
PROFILE_RUN = (2, 70)
CUSTOM_RUN = (2, 150)
OUT = Path("chiprun_out") / "chip_smoke"
# The band's script (phase 25): seeds, episodes (one a chunk) and the CLI
# flags of its processes: episodes of BAND_STEPS steps, the first of them
# warm-up, so that the resumed chunk updates from its 59th step (the
# replay then holds a batch of 128 rows; its first update fits the
# NODE). The phase's cost is its fresh CLI processes (15-25 s each),
# so its depth is cut from 2 seeds of 300 steps an episode (about 110 s
# alone) to 1 seed of 100 steps (about 62 s on an H100 with a slow host)
# and then to 70 steps, to hold it within a minute; the widths stay the preset's.
BAND = Path("chiprun_out") / "band_smoke"
BAND_SEEDS, BAND_EPISODES, BAND_STEPS = 1, 2, 70
BAND_CLI_ARGS = f"--max_episode_steps {BAND_STEPS} --start_steps {BAND_STEPS}"
SEED = 0
SWEEP_ROWS = (128, 512, 2048, 4096, 8448, 32768)
HOST_CALLS = 1000
UPDATE_TIMING = (3, 20)
# --n_seeds of the seeds phase, at the main path's depth with
# --start_steps one episode: the first episode's actions are random, as
# in the main path's (so seed 0's first episode equals it), the later
# ones the policy's.
SEEDS = 4
# The gangs on one card: one unicycle episode of GANG_STEPS steps whose
# updates start at step 129, when the replay holds more than a batch (2
# per step, a NODE fit every 10th), and the policy acts from that step
# on, so every action comes from a trained policy (the steps before take
# random warm-up actions: an untrained policy acting there lets float32
# noise in the actions grow for 129 steps first; PERF.md, PR 7), each
# gang given GANG_TIMEOUT seconds. Against one rank: tests/test_parallel.py's
# tolerances, the reward rtol/atol and the whole state's; each Adam
# moment leaf's relative gap (its 2-norm over one rank's) within the
# state's rtol (a dp gradient off by a constant factor passes Adam's
# normalised step, not its moments), and the last update's losses within
# GANG_METRIC_RTOL. The episode is cut from 140 steps (22 updates, 3 NODE
# fits) to 135 (12 updates, 2 fits: a fit after updates, whose Adam
# moments the check reads, is still in it) to shorten phase 16.
GANG_STEPS = 135
GANG_TIMEOUT = 300
# The gangs' layouts of the card's two ranks, (dp, tp): phase 16 runs both
# in one spawn of the two ranks, one after the other, and so does phase
# 17 (a spawn of two ranks costs about 20 s; a spawn per layout did until
# the script was cut to keep it in its time limit).
GANG_LAYOUTS = (("dp", (2, 1)), ("tp", (1, 2)))
GANG_REWARD_RTOL, GANG_REWARD_ATOL = 2e-4, 1e-4
GANG_STATE_RTOL, GANG_STATE_ATOL = 2e-3, 5e-4
GANG_METRIC_RTOL = 1e-4
# (node_loss is 0 on the last update, which is not a fit; the NODE's
# moments hold the fit)
GANG_METRICS = ("qf1_loss", "qf2_loss", "lf_loss", "policy_loss")
# The row counts K1 takes on a dp rank's share at dp=2 and 4 (the main
# path's 128-row rollouts and 32768-row fit, PVTOL's 256-row chain)
DP_ROWS = (64, 32, 16384, 8192)
# The dopri5 gangs (dp=2 and tp=2 on one card over gloo): per form, one
# unicycle episode of DOPRI5_GANG_STEPS steps from seed SEED's state, the
# policy acting from the first update block (step 130), whose first
# update fits the NODE on the full 32768 rows (16384 per dp rank): 2
# updates in all (the fit and one other), each timed alone; cut from 131
# steps (4 updates) to shorten phase 17: the updates after the fit leave
# the NODE as the fit left it, so the NODE's check reads the same fit. Against one rank: the reward and the
# state at the gangs' tolerances above, but the NODE's parameters and Adam
# moments, which hold the fit's gradient through the adaptive solve:
# within DOPRI5_GANG_NODE_FRAC of each leaf's largest entry (the float32
# noise of the adaptive steps that tests/test_torch_port_ode.py's
# NODE_GRAD_FRAC allows at its small widths), or within NOISE_FACTOR times
# the float32 noise floor measured in the same run, the NODE's gap between
# one rank's episode and one whose NODE weights start one ulp up,
# whichever is larger. The scan form differentiates through its step
# sizes, whose gradient is float32 noise (ROADMAP.md G3): a tp gang sums
# each layer in another order, and at full width its NODE moments part
# from one rank's by more than a leaf's largest entry, as the one-ulp run
# does. NOISE_FACTOR leaves room for the spread of a largest gap over the
# NODE's leaves between two such draws.
DOPRI5_GANG_STEPS = 130
DOPRI5_IMPLS = ("while", "scan")
DOPRI5_GANG_NODE_FRAC = {"while": 2e-2, "scan": 1.5e-1}
NOISE_FACTOR = 4
# The levers' A/B: update blocks (updates_per_step = 2 updates) per path,
# interleaved in turns, the paths' order rotating each turn.
LEVER_BLOCKS = 30
LEVERS = ("default", "stacked", "decoupled", "fused")
# A bf16 NODE's update on the card vs the CPU (tests/test_torch_port_gpu.py
# states why): rtol and atol.
BF16_RTOL, BF16_ATOL = 2e-2, 1e-6
# The start-up runs' unicycle episode: its first update block (step 130)
# is its last step.
STARTUP_STEPS = 130
# The lockstep phase: K1 seed-batched at (seeds, rows per seed), the main
# path's 128-row rollouts and 32768-row fit at 4 and 8 seeds; the runner at
# SEEDS seeds (phase 16's) and at LOCKSTEP_BIG (SEEDS seeds and their
# one-ulp twins). Each seed's first episode (all warm-up actions) against
# phase 16's: relative LOCKSTEP_FIRST_RTOL on reward_train. The later
# episodes' reward_train and every episode's node_loss (the episode's last
# update's): relative to phase 16's within the larger of
# LOCKSTEP_LATER_RTOL and NOISE_FACTOR times that episode's and metric's
# largest gap between a seed and its twin (a batched product need not
# round as one seed's product does; the policy acts from the second
# episode, so float32 noise can tip a trajectory; PERF.md §6). One
# lockstep update of the trained seeds, set to the update counts
# LOCKSTEP_COUNTERS with the seeds LOCKSTEP_UPDATE_ON updating (the first
# fits the NODE and ascends, the second does neither, the third sits out,
# the fourth ascends only), against each seed's one-seed update on the
# card: UPDATE_RTOL/UPDATE_ATOL, the seed that sits out bit for bit.
LOCKSTEP_KERNEL = ((4, 128), (4, 32768), (8, 128), (8, 32768))
LOCKSTEP_BIG = 8
LOCKSTEP_FIRST_RTOL = 1e-5
LOCKSTEP_LATER_RTOL = 1e-3
LOCKSTEP_PROFILE_STEPS = 10
LOCKSTEP_COUNTERS = (960, 961, 965, 968)
LOCKSTEP_UPDATE_ON = (True, True, False, True)
# The lockstep in shards (phase 24): LOCKSTEP_SHARDS worker processes of
# SEEDS seeds each on the one card, at phase 21's depth and base seed.
LOCKSTEP_SHARDS = 2
# The lockstep phase over the other presets (22), at full width and SEEDS
# seeds: K1 seed-batched where their constraints call it (PVTOL's chain of
# 3 calls at SEEDS x 256 rows (6, 2), the learned barrier's one call at
# SEEDS x 128 (3, 2) and SEEDS x 256 (6, 2)); then each preset's runner
# for one episode of LOCKSTEP_PRESETS[preset] steps (preset: cars 300,
# PVTOL and nbc_pvtol 2000, nbc_unicycle 1200), just past the batch
# (256 rows; nbc_unicycle 128) so that every seed updates, the policy
# acting in the second half (--start_steps half of it), PVTOL with its
# supervisor from episode 0 (preset: 3) so that both machines run; the
# quadrotor with phase 7's QUAD_FLAGS in episodes of QUAD_EPISODE_STEPS
# until every seed has LOCKSTEP_QUAD_UPDATES updates (random warm-up
# thrusts crash it early), at most LOCKSTEP_QUAD_EPISODES episodes. One
# seed's run of the same preset and episodes (seed SEED, the lockstep's
# seed 0) in the same call gives the rate beside it. Each run is followed
# by ``lockstep_update_check`` on its trained state.
LOCKSTEP_PRESETS = {"cars": 300, "pvtol": 320, "nbc_unicycle": 180,
                    "nbc_pvtol": 320, "quadrotor": QUAD_EPISODE_STEPS}
LOCKSTEP_QUAD_UPDATES, LOCKSTEP_QUAD_EPISODES = 30, 12
# K1 calls a lockstep update makes on each preset's constraint rollout,
# and the backup branch's (PVTOL: every backup_update_interval-th update)
K1_CHAIN_CALLS = {"cars": 0, "pvtol": 3, "nbc_unicycle": 1, "nbc_pvtol": 1,
                  "quadrotor": 0}
# The lockstep under dopri5 (phase 23), unicycle at full width and SEEDS
# seeds. (a) The solver on SEEDS x LOCKSTEP_DOPRI5_ROWS rows, seed i's
# NODE weights scaled by LOCKSTEP_DOPRI5_SCALES[i] (5, 6, 9 and 11 trials
# at 128 rows on the CPU, every error at least 0.44 from the accept
# threshold), against each seed's one-seed solve on the card: values
# within LOCKSTEP_DOPRI5_RTOL/ATOL (a batched product need not round as
# the one-seed product does), trial counts equal, gradients within
# LOCKSTEP_DOPRI5_GRAD_FRAC of each leaf's largest entry: the adjoint's
# (``while``) within phase 8's ADJOINT_FRAC; autograd's through the scan
# form within its float32 noise, DOPRI5_GANG_NODE_FRAC's (that gradient
# runs through the step sizes, which a batched product's rounding moves;
# the 2.5-scaled seed's stood 7.88e-2 off its one-seed gradient in one
# run), with the worst seed's one-ulp floor printed beside it. (b) The
# runner for one
# episode of LOCKSTEP_DOPRI5_STEPS steps (preset: 1200), just past the
# batch (128 rows), so that every seed makes 6 updates and the first fits
# the NODE on SEEDS x 32768 rows; the policy acts in the second half. Its
# update check holds the NODE's parameters and Adam moments, which carry
# the fit's gradient through the adaptive solve, as phase 17 holds a
# gang's: within the larger of DOPRI5_GANG_NODE_FRAC and NOISE_FACTOR
# times the one-ulp NODE floor, of each leaf's largest entry. Then a fit
# update and LOCKSTEP_DOPRI5_TIMED others of the lockstep and of one seed,
# in turns, each timed alone. (c) The per-seed builder: one Euler episode
# of the same length.
LOCKSTEP_DOPRI5_ROWS = 128
LOCKSTEP_DOPRI5_SCALES = (1.0, 1.5, 2.0, 2.5)
LOCKSTEP_DOPRI5_RTOL, LOCKSTEP_DOPRI5_ATOL = 1e-5, 1e-6
LOCKSTEP_DOPRI5_GRAD_FRAC = {"while": ADJOINT_FRAC,
                             "scan": DOPRI5_GANG_NODE_FRAC["scan"]}
LOCKSTEP_DOPRI5_STEPS = 131
LOCKSTEP_DOPRI5_TIMED = 2


# the host probe: a pure Python loop of HOST_PROBE_ITERS iterations, timed
# HOST_PROBE_REPEATS times (about 0.1 s each on a current server core)
HOST_PROBE_ITERS = 1_000_000
HOST_PROBE_REPEATS = 3


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def host_info() -> dict:
    """The host beside the card: its CPU model (``/proc/cpuinfo``), the
    cores this process may run on and a fixed host-only probe, the best of
    HOST_PROBE_REPEATS timings of HOST_PROBE_ITERS iterations of a pure
    Python loop (ms; well under 2 s), so that a slow run can be told from
    a slow host."""
    model = None
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), None)
    except OSError:
        pass
    best = math.inf
    for _ in range(HOST_PROBE_REPEATS):
        t0 = time.perf_counter()
        acc = 0
        for i in range(HOST_PROBE_ITERS):
            acc += i * i % 7
        best = min(best, (time.perf_counter() - t0) * 1e3)
    return {"cpu_model": model,
            "affinity": sorted(os.sched_getaffinity(0)),
            "probe_ms": round(best, 2), "probe_iters": HOST_PROBE_ITERS}


def node_params(n_s, n_u, gen, dev):
    cfg = dataclasses.replace(get_config("unicycle").node, state_dim=n_s,
                              action_dim=n_u)
    params = node_init(gen, cfg, device=dev)
    # non-zero biases, so the kernel's bias path is exercised
    for net in params.values():
        for b in net["b"]:
            b.uniform_(-0.1, 0.1, generator=gen)
    return tree_map(lambda p: p.requires_grad_(True), params)


def work(params, rows, n_s, n_u):
    """(FLOP, bytes) the Euler step needs: every layer's multiply-adds, the
    g.u contraction and the update; x, u and the weights read once and x'
    written once."""
    macs = sum(w.shape[0] * w.shape[1]
               for net in params.values() for w in net["w"])
    flops = 2 * rows * (macs + n_s * n_u + n_s)
    nbytes = 4 * (rows * (2 * n_s + n_u)
                  + sum(p.numel() for p in tree_leaves(params)))
    return flops, nbytes


def bound(flops, nbytes, peak_flops=PEAK_TF32_FLOPS / TF32_PASSES):
    """(ms, what bounds it): the larger of the work's time at
    ``peak_flops`` and its bytes' time at the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, runs=30, inner=10):
    """(device ms, call ms): medians over ``runs`` of the per-call time of
    ``inner`` calls, from CUDA events. Device: the calls captured in a CUDA
    graph and replayed, so the host does not pace them. Call: the calls
    issued from Python, as the training loop issues them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()

    def median(step):
        step()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    def issue():
        for _ in range(inner):
            fn()

    return median(graph.replay), median(issue)


def check_rows():
    """The row counts phase 3 checks: the main path's (and a dp rank's
    share of them at dp=2 and 4), the 16-row tile's edges, a ragged
    count, and both sides of the small/large tile switch."""
    switch = node_kernel.SMALL_TILE_MAX_ROWS
    return sorted({1, 16, 17, 127, 128, 129, 1000, switch - 1, switch,
                   switch + 1, 32768} | set(DP_ROWS))


def check_kernel(dev, gen):
    """Kernel vs plain version: forward and gradients. Returns the largest
    forward error."""
    worst = 0.0
    for (n_s, n_u), rows in itertools.product(((3, 2), (6, 2)),
                                              check_rows()):
        params = node_params(n_s, n_u, gen, dev)
        x = torch.randn(rows, n_s, device=dev, generator=gen)
        u = (torch.rand(rows, n_u, device=dev, generator=gen) * 2 - 1) * 3.5
        u.requires_grad_(True)
        cot = torch.randn(rows, n_s, device=dev, generator=gen)
        y_k = node_kernel.node_euler_step(params, x, u, 0.02)
        y_p = node_kernel.node_euler_step_plain(params, x, u, 0.02)
        torch.cuda.synchronize()
        err = (y_k - y_p).abs().max().item()
        rel = ((y_k - y_p).abs() / y_p.abs().clamp_min(1e-6)).max().item()
        torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        inputs = [u] + tree_leaves(params)
        g_k = torch.autograd.grad((y_k * cot).sum(), inputs)
        g_p = torch.autograd.grad((y_p * cot).sum(), inputs)
        g_err = max((a - b).abs().max().item() for a, b in zip(g_k, g_p))
        for a, b in zip(g_k, g_p):
            torch.testing.assert_close(a, b, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
        worst = max(worst, err)
        tiles = node_kernel.TILE_CONFIGS[node_kernel.tile_config(rows)]
        phase(f"check (n_s,n_u)=({n_s},{n_u}) rows={rows} tiles {tiles}: "
              f"forward max abs err {err:.3e} max rel err {rel:.3e}, "
              f"gradient max abs err {g_err:.3e} (tolerance rtol "
              f"{KERNEL_RTOL} atol {KERNEL_ATOL}) ok")
    return worst


def tensor_core_check(lib):
    """Counts the tensor-core instructions (HMMA) in the built library's
    SASS; fails if there are none."""
    cuobjdump = Path(node_kernel._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    per_kernel, name = collections.Counter(), None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HMMA" in line:
            per_kernel[name] += 1
    if not per_kernel:
        raise RuntimeError(f"no HMMA instruction in the SASS of {lib.name}")
    phase(f"tensor cores: {sum(per_kernel.values())} HMMA instructions in "
          f"{len(per_kernel)} kernels of {lib.name} ("
          + ", ".join(f"{n}" for n in per_kernel.values()) + " each)")


def pvtol_chain(dev, gen, card):
    """K1 where PVTOL's constraint chain calls it: three chained steps at
    256 rows and (6, 2), gradients of u_t (through all three), of x (one
    call) and of the parameters against the plain version's; then the
    call's device time against the plain version's and the bound."""
    params = node_params(6, 2, gen, dev)
    x0 = torch.randn(PVTOL_ROWS, 6, device=dev, generator=gen)
    u0 = torch.randn(PVTOL_ROWS, 2, device=dev, generator=gen,
                     requires_grad=True)
    resampled = [torch.randn(PVTOL_ROWS, 2, device=dev, generator=gen)
                 for _ in range(2)]
    cot = torch.randn(3, PVTOL_ROWS, 6, device=dev, generator=gen)

    def chain(step):
        ys, x, u = [], x0, u0
        for k in range(3):
            x = step(params, x, u, 0.02)
            ys.append(x)
            if k < 2:
                u = resampled[k]
        return torch.stack(ys)

    y_k, y_p = chain(node_kernel.node_euler_step), chain(
        node_kernel.node_euler_step_plain)
    err = (y_k - y_p).abs().max().item()
    torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    inputs = [u0] + tree_leaves(params)
    grads = list(zip(torch.autograd.grad((y_k * cot).sum(), inputs),
                     torch.autograd.grad((y_p * cot).sum(), inputs)))
    x = x0.clone().requires_grad_(True)
    grads += zip(*(torch.autograd.grad(
        (step(params, x, u0, 0.02) * cot[0]).sum(), [x, u0])
        for step in (node_kernel.node_euler_step,
                     node_kernel.node_euler_step_plain)))
    g_err = max((a - b).abs().max().item() for a, b in grads)
    for a, b in grads:
        torch.testing.assert_close(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)

    with torch.no_grad():
        ms, call_ms = time_ms(lambda: node_kernel.node_euler_step(
            params, x0, resampled[0], 0.02))
        plain_ms, plain_call_ms = time_ms(
            lambda: node_kernel.node_euler_step_plain(params, x0,
                                                      resampled[0], 0.02))
    flops, nbytes = work(params, PVTOL_ROWS, 6, 2)
    bound_ms, bound_by = bound(flops, nbytes)
    bound_f32_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
    phase(f"pvtol chain rows={PVTOL_ROWS} (n_s,n_u)=(6,2), 3 chained calls: "
          f"forward max abs err {err:.3e}, gradient (u_t, x, parameters) "
          f"max abs err {g_err:.3e} (tolerance rtol {KERNEL_RTOL} atol "
          f"{KERNEL_ATOL}) ok; device kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms; issued from Python kernel {call_ms:.4f} ms, "
          f"plain {plain_call_ms:.4f} ms; bound {bound_ms:.5f} ms on the "
          f"tensor cores ({bound_by}), {bound_f32_ms:.5f} ms on the CUDA "
          f"cores; on {card}")
    return {"rows": PVTOL_ROWS, "dims": [6, 2], "max_abs_err": err,
            "grad_max_abs_err": g_err, "ms": ms, "plain_ms": plain_ms,
            "call_ms": call_ms, "plain_call_ms": plain_call_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_f32_ms": bound_f32_ms}


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds per call: a host clock around ``calls`` calls,
    with no synchronize inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_kernel(dev, gen, card):
    out = {}
    for rows in (128, 32768):
        params = node_params(3, 2, gen, dev)
        x = torch.randn(rows, 3, device=dev, generator=gen)
        u = torch.randn(rows, 2, device=dev, generator=gen)
        with torch.no_grad():
            ms, call_ms = time_ms(lambda: node_kernel.node_euler_step(
                params, x, u, 0.02))
            plain_ms, plain_call_ms = time_ms(
                lambda: node_kernel.node_euler_step_plain(params, x, u, 0.02))
        flops, nbytes = work(params, rows, 3, 2)
        bound_ms, bound_by = bound(flops, nbytes)
        bound_f32_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
        out[rows] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_tc_ms": bound_ms,
                     "bound_f32_ms": bound_f32_ms, "call_ms": call_ms,
                     "plain_call_ms": plain_call_ms}
        phase(f"time rows={rows}: device kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; issued from Python kernel {call_ms:.4f} "
              f"ms, plain {plain_call_ms:.4f} ms; bound {bound_ms:.5f} ms "
              f"on the tensor cores ({bound_by}; 3 TF32 passes at "
              f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {bound_f32_ms:.5f} "
              f"ms on the CUDA cores; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB; {flops / ms / 1e9:.2f} TFLOP/s "
              f"achieved, {bound_ms / ms:.1%} of the bound, on {card}")
        if rows == 128:
            u_grad = u.clone().requires_grad_(True)
            with torch.no_grad():
                us_nograd = host_us(lambda: node_kernel.node_euler_step(
                    params, x, u, 0.02))
            us_grad = host_us(lambda: node_kernel.node_euler_step(
                params, x, u_grad, 0.02))
            out[rows]["host_us_per_call"] = us_grad
            out[rows]["host_us_per_call_no_grad"] = us_nograd
            phase(f"host time per call at rows=128 ({HOST_CALLS} calls, no "
                  f"synchronize inside): {us_grad:.2f} us with u requiring "
                  f"a gradient (as the policy-loss rollout calls it), "
                  f"{us_nograd:.2f} us under no_grad, on {card}")
    return out


def sweep(dev, gen, card):
    """Device ms of every tile configuration at SWEEP_ROWS (unicycle
    dimensions), each checked against the plain version first."""
    for rows in SWEEP_ROWS:
        params = node_params(3, 2, gen, dev)
        x = torch.randn(rows, 3, device=dev, generator=gen)
        u = torch.randn(rows, 2, device=dev, generator=gen)
        cells = []
        with torch.no_grad():
            args = node_kernel.launch_args(params, x, u)
            y_p = node_kernel.node_euler_step_plain(params, x, u, 0.02)
            for cfg, tiles in enumerate(node_kernel.TILE_CONFIGS):
                y_k = node_kernel._launch(args, x, u, 0.02, cfg)
                torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL,
                                           atol=KERNEL_ATOL)
                ms, _ = time_ms(lambda: node_kernel._launch(
                    args, x, u, 0.02, cfg))
                cells.append(f"{tiles} {ms:.4f}")
        flops, nbytes = work(params, rows, 3, 2)
        tc_ms, _ = bound(flops, nbytes)
        f32_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
        picked = node_kernel.TILE_CONFIGS[node_kernel.tile_config(rows)]
        phase(f"sweep rows={rows}: device ms by (tile rows, warps): "
              + "; ".join(cells) + f"; the wrapper picks {picked}; bound "
              f"{tc_ms:.5f} ms (tensor cores), {f32_ms:.5f} ms (CUDA "
              f"cores); on {card}")


def to_device(ts, cfg, dev):
    """A copy of a TrainState on ``dev`` with fresh optimizers (the source
    state's optimizers must be fresh too)."""
    def move(p):
        return p.detach().to(dev, copy=True).requires_grad_(p.requires_grad)
    fields = {name: tree_map(move, getattr(ts, name)) for name in (
        "policy", "backup_policy", "critic", "critic_target", "lyap",
        "lyap_target", "barrier", "barrier_target", "node", "log_alpha",
        "backup_log_alpha")}
    return type(ts)(**fields, opt=make_optimizers(cfg, fields),
                    lag=type(ts.lag)(*(t.to(dev, copy=True) for t in ts.lag)),
                    updates=ts.updates)


def progress_rows(run_dir):
    """progress.txt as a list of {column: value} rows."""
    header, *rows = (run_dir / "progress.txt").read_text().splitlines()
    keys = header.split("\t")
    return [dict(zip(keys, map(float, r.split("\t")))) for r in rows]


def cli_run(preset, argv, card, label):
    """Train ``preset`` at its full widths through the CLI's ``main`` (the
    counts set to 0 just before, read just after) into a fresh directory
    under OUT; print its episodes and its env-steps/s. Returns (run dir,
    K1 launches, env steps, updates, seconds)."""
    out = OUT / label
    shutil.rmtree(out, ignore_errors=True)
    node_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["--preset", preset, "--quiet", "--seed", str(SEED),
              "--output", str(out)] + argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = node_kernel.launch_counts["node_euler"]
    (run,) = out.glob("*-run*/*/*_s*")
    rows = progress_rows(run)
    for r in rows:
        bad = [k for k, v in r.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"{label} episode {r['Episode']:.0f}: "
                               f"non-finite {bad}")
        barrier = (f" barrier_td {r['barrier_td_loss']:.4g}"
                   if "barrier_td_loss" in r else "")
        phase(f"{label} episode {r['Episode']:.0f}: steps "
              f"{r['episode_steps']:.0f} reward {r['reward_train']:.4g} "
              f"violations {r['cost_train']:.0f} goal "
              f"{r['goal_met']:.0f} updates "
              f"{r['updates']:.0f} qf1 {r['qf1_loss']:.4g} policy "
              f"{r['policy_loss']:.4g} node {r['node_loss']:.4g} rho "
              f"{r['rho']:.4g} alpha {r['alpha']:.4g}{barrier}")
    steps = int(sum(r["episode_steps"] for r in rows))
    updates = int(rows[-1]["updates"])
    files = ["config.json", "checkpoint.npz", "actor.pkl", "critic.pkl",
             "lyapunov.pkl", "node_model.pkl"]
    if "barrier_td_loss" in rows[-1]:
        files.append("barrier.pkl")
    for name in files:
        if not (run / name).is_file():
            raise RuntimeError(f"{label}: the CLI wrote no {name}")
    phase(f"{label} through nlbac-train-torch ({' '.join(argv)}): {steps} "
          f"env steps, {updates} updates in total, {launches} K1 launches "
          f"({launches / steps:.2f} per env step), {seconds:.2f} s for the "
          f"whole main() call, {steps / seconds:.2f} env-steps/s on {card}")
    return run, launches, steps, updates, seconds


def restored(preset, argv, run, dev, squash=DEFAULT_SQUASH):
    """The config of a CLI run and its final state, replays and generator,
    restored on ``dev`` from the run's checkpoint.npz (a run under
    ``squash``)."""
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", preset, "--seed", str(SEED)] + argv))
    gen = torch.Generator(dev).manual_seed(SEED)
    ts = create_train_state(cfg, gen, dev)
    rl, node = create_replays(cfg, dev)
    total, episode = restore_checkpoint(str(run / "checkpoint.npz"), ts, rl,
                                        node, gen, squash)
    return cfg, ts, rl, node, total, episode


def main_path(dev, card):
    """Unicycle at the preset's full widths through the CLI, the policy
    acting from the second episode, then resumed from its checkpoint for
    one more episode."""
    argv = ["--max_episodes", str(EPISODES), "--max_episode_steps",
            str(EPISODE_STEPS), "--start_steps", str(EPISODE_STEPS)]
    run, launches, steps, updates, seconds = cli_run("unicycle", argv, card,
                                                     "unicycle")
    # each update launches K1 twice at 128 rows (primary and backup
    # rollouts) and once more at 32768 rows on every 10th (the NODE fit)
    fits = launches - 2 * updates
    if updates <= 0 or fits != (updates + 9) // 10 or fits < 10:
        raise RuntimeError(f"{updates} updates and {launches} launches: "
                           f"{fits} NODE fits, expected "
                           f"{(updates + 9) // 10}")
    phase(f"main path: {updates} updates, {fits} NODE fits of 32768 rows, "
          f"{launches} K1 launches")

    resume_argv = ["--max_episodes", str(EPISODES + 1),
                   "--max_episode_steps", str(EPISODE_STEPS),
                   "--start_steps", str(EPISODE_STEPS), "--resume",
                   str(run / "checkpoint.npz")]
    run2, launches2, steps2, _, _ = cli_run("unicycle", resume_argv, card,
                                            "unicycle_resumed")
    rows = progress_rows(run2)
    _, ts, _, _, total, episode = restored("unicycle", resume_argv, run2, dev)
    if ([r["Episode"] for r in rows] != [EPISODES] or episode != EPISODES
            or total != steps + steps2 or launches2 <= 0):
        raise RuntimeError(f"resume: episodes {[r['Episode'] for r in rows]}"
                           f", checkpoint at episode {episode} after "
                           f"{total} steps, {launches2} launches")
    phase(f"resume: episode {EPISODES} continued from episode "
          f"{EPISODES - 1}'s checkpoint, {total} env steps and {ts.updates} "
          f"updates in all")
    cfg, ts, rl, node, _, _ = restored("unicycle", argv, run, dev)
    one_seed = {"run": run, "steps": steps, "seconds": seconds}
    return cfg, ts, rl, node, launches, {"unicycle": launches,
                                         "unicycle_resumed": launches2}, \
        one_seed


def profile_steps(cfg, ts, rl, node, dev, card, steps=10):
    """A torch.profiler window of ``steps`` env steps of the trained agent
    (updates on, the policy acting): the device's busy share of the window
    and the ops that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, max_episode_steps=steps))
    run = make_episode_runner(short, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    run(ts, rl, node, gen, EPISODES, 10 ** 6)  # warm-up, not profiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, m, _ = run(ts, rl, node, gen, EPISODES, 10 ** 6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel and copy records; user annotations (e.g. the
    # optimizer's step range) also carry device spans and would count twice
    spans = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            spans[e.name] += e.time_range.elapsed_us() / 1e6
    busy = sum(spans.values())
    if busy <= 0:
        phase("profile: the profiler recorded no device time (not measured)")
        return
    kern = sum(v for k, v in spans.items() if "node_euler" in k)
    tops = "; ".join(f"{k[:40]} {v * 1e3:.2f} ms"
                     for k, v in spans.most_common(5))
    phase(f"profile: {m.steps} env steps, {m.updates_done} updates in "
          f"{wall:.3f} s under the profiler; device busy {busy:.4f} s "
          f"({busy / wall:.1%} of the window, idle {1 - busy / wall:.1%}); "
          f"node_euler kernel {kern * 1e3:.3f} ms; top device ops: {tops} "
          f"on {card}")


def timed_updates(update, cfg, ts) -> str:
    """Host ms per ``update()`` (which steps ``ts``) over a window of
    UPDATE_TIMING (Euler) or DOPRI5_UPDATE_TIMING updates after its
    warm-up ones, ending in a synchronize; under dopri5 every update ends
    in one, and the fit updates and the others are also timed apart.
    Returns the phase line's text."""
    warm, n = UPDATE_TIMING if cfg.node.solver == "euler" \
        else DOPRI5_UPDATE_TIMING
    interval = cfg.node.update_interval
    limit = cfg.node.fit_episode_limit
    if n % interval or (limit is not None and limit < 0):
        raise RuntimeError(f"{n} timed updates hold no fixed share of the "
                           f"NODE fits (every {interval}th, limit {limit})")
    each = cfg.node.solver != "euler"
    for _ in range(warm):
        update()
    torch.cuda.synchronize()
    fit_ms, rest_ms = [], []
    t0 = time.perf_counter()
    for _ in range(n):
        fit = ts.updates % interval == 0
        t1 = time.perf_counter()
        update()
        if each:
            torch.cuda.synchronize()
            (fit_ms if fit else rest_ms).append(
                (time.perf_counter() - t1) * 1e3)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / n * 1e3
    text = (f"{ms:.2f} ms per update (host clock over {n} updates after "
            f"{warm}, {n // interval} NODE fit(s) of {cfg.node.max_batch} "
            "rows included")
    if each:
        text += (f"; each update synchronized: the fit update "
                 f"{np.mean(fit_ms):.2f} ms, the other {len(rest_ms)} "
                 f"{np.mean(rest_ms):.2f} ms each")
    return text + ")"


def time_updates(cfg, ts, rl, node, dev, card):
    """Host ms per update of a trained state on its replays (the batch
    sampling and the NODE fits included)."""
    agent = make_agent(cfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 4)
    text = timed_updates(lambda: agent.update(ts, rl, node, gen, 0), cfg, ts)
    solver = cfg.node.solver
    if solver == "dopri5":
        solver += " " + cfg.node.adaptive_impl
    phase(f"{cfg.run.exp_name} ({solver}): {text} on {card}")


def check_preset(preset, argv, run, dev, card):
    """A CLI run's final state restored on the card: its time per update,
    then one full-width update from a fresh state on the card against the
    CPU."""
    cfg, ts, rl, node, _, _ = restored(preset, argv, run, dev)
    time_updates(cfg, ts, rl, node, dev, card)
    update_on_card_vs_cpu(cfg, rl, node, dev)


def update_on_card_vs_cpu(cfg, rl, node, dev, node_rows=None,
                          rtol=UPDATE_RTOL, atol=UPDATE_ATOL,
                          squash=DEFAULT_SQUASH):
    """One full-width update from a fresh state on the card (kernel) and
    on the CPU (plain version), with the same batches and draws; the NODE
    fit on ``node_rows`` rows (default: the config's 32768); the policy's
    tanh ``squash``'s; every metric within ``rtol`` / ``atol``. Returns
    the card's K1 launches."""
    gen_cpu = torch.Generator().manual_seed(SEED + 1)
    ts_cpu = create_train_state(cfg, gen_cpu, "cpu")
    ts_dev = to_device(ts_cpu, cfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    batch = sample(rl, gen, cfg.sac.batch_size)
    node_batch = sample(node, gen, node_rows or cfg.node.max_batch)
    noise = {k: torch.randn(cfg.sac.batch_size, cfg.action_dim,
                            generator=gen_cpu)
             for k in ("next", "pi", "backup")}
    n_resample = RESAMPLES[cfg.constraint.kind]
    if n_resample:
        noise.update({k: torch.randn(n_resample, cfg.sac.batch_size,
                                     cfg.action_dim, generator=gen_cpu)
                      for k in ("resample", "backup_resample")})

    def run(ts, device):
        agent = make_agent(cfg, device, squash=squash)
        to = {k: v.to(device) for k, v in noise.items()}
        nb = {k: v.to(device) for k, v in node_batch.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        _, m = agent.update_core(ts, b, lambda: nb, None, 0, noise=to)
        return {k: v.item() for k, v in m.items()}

    node_kernel.reset_launch_counts()
    m_dev = run(ts_dev, dev)
    launches = node_kernel.launch_counts["node_euler"]
    m_cpu = run(ts_cpu, "cpu")
    worst = 0.0
    for k in m_cpu:
        err = abs(m_dev[k] - m_cpu[k])
        worst = max(worst, err / (atol + rtol * abs(m_cpu[k])))
        if err > atol + rtol * abs(m_cpu[k]):
            raise RuntimeError(f"{cfg.env.name} update metric {k}: card "
                               f"{m_dev[k]} vs CPU {m_cpu[k]}")
    solver = (f" ({cfg.node.solver} {cfg.node.adaptive_impl}, NODE fit "
              f"on {node_rows} rows)" if cfg.node.solver == "dopri5" else "")
    if cfg.node.compute_dtype is not None:
        solver += (f" (NODE in {cfg.node.compute_dtype}, {launches} K1 "
                   "launches)")
    if squash != DEFAULT_SQUASH:
        solver += f" (squash {squash})"
    phase(f"{cfg.run.exp_name} full-width update{solver}, card vs CPU: "
          f"{len(m_cpu)} metrics within rtol "
          f"{rtol} atol {atol} (worst at {worst:.3f} of the "
          f"tolerance; node_loss {m_dev['node_loss']:.6g} vs "
          f"{m_cpu['node_loss']:.6g}; barrier_td_loss "
          f"{m_dev['barrier_td_loss']:.6g} vs "
          f"{m_cpu['barrier_td_loss']:.6g}) ok")
    return launches


def nbc_calls(dev, gen, card):
    """K1 where the learned barrier calls it: one call, x without
    gradient, u with, at nbc_unicycle's and nbc_pvtol's batch and
    dimensions; forward and the gradient with respect to u against the
    plain version. Returns the largest forward error."""
    worst = 0.0
    for preset, ((n_s, n_u), rows) in NBC_CALLS.items():
        params = node_params(n_s, n_u, gen, dev)
        x = torch.randn(rows, n_s, device=dev, generator=gen)
        u = torch.randn(rows, n_u, device=dev, generator=gen,
                        requires_grad=True)
        cot = torch.randn(rows, n_s, device=dev, generator=gen)
        y_k = node_kernel.node_euler_step(params, x, u, 0.02)
        y_p = node_kernel.node_euler_step_plain(params, x, u, 0.02)
        err = (y_k - y_p).abs().max().item()
        torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        (g_k,) = torch.autograd.grad((y_k * cot).sum(), [u])
        (g_p,) = torch.autograd.grad((y_p * cot).sum(), [u])
        g_err = (g_k - g_p).abs().max().item()
        torch.testing.assert_close(g_k, g_p, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        worst = max(worst, err)
        phase(f"learned barrier's call ({preset}) rows={rows} "
              f"(n_s,n_u)=({n_s},{n_u}): forward max abs err {err:.3e}, "
              f"gradient of u max abs err {g_err:.3e} (tolerance rtol "
              f"{KERNEL_RTOL} atol {KERNEL_ATOL}) ok on {card}")
    return worst


def last_barrier_td(label, run):
    """The last episode's barrier_td_loss, which must be finite and
    nonzero."""
    value = progress_rows(run)[-1]["barrier_td_loss"]
    if not math.isfinite(value) or value == 0:
        raise RuntimeError(f"{label}: last barrier_td_loss {value}")
    return value


def nbc_run(preset, card):
    """One learned-barrier preset with K1 (control-affine NODE) at its full
    widths through the CLI: K1 runs once per update (the policy loss's
    single rollout; no backup) and once more on every 10th (the fit)."""
    episodes, steps_cap = NBC_RUNS[preset]
    argv = ["--max_episodes", str(episodes), "--max_episode_steps",
            str(steps_cap)]
    run, launches, steps, updates, seconds = cli_run(preset, argv, card,
                                                     preset)
    fits = launches - updates
    if updates <= 0 or fits != (updates + 9) // 10:
        raise RuntimeError(f"{preset}: {updates} updates and {launches} K1 "
                           f"launches: {fits} NODE fits, expected "
                           f"{(updates + 9) // 10}")
    barrier = last_barrier_td(preset, run)
    phase(f"{preset}: {steps} env steps, {updates} updates, {fits} NODE "
          f"fits of 32768 rows, {launches} K1 launches "
          f"({launches / steps:.2f} per env step), "
          f"{steps / seconds:.2f} env-steps/s, last barrier_td_loss "
          f"{barrier:.6g}, barrier.pkl written, on {card}")
    return run, argv, launches


def quad_run(card):
    """The quadrotor at its full widths through the CLI, with its kill
    penalty, the mix spawn curriculum and both pre-tanh regularizers,
    resumed QUAD_CHUNK episodes at a time until it has taken
    QUAD_MIN_STEPS env steps and QUAD_MIN_UPDATES updates. Its mlp NODE
    has no kernel, so K1 must not launch."""
    steps = updates = launches = chunk = 0
    seconds = 0.0
    goals, resume = 0, []
    while steps < QUAD_MIN_STEPS or updates < QUAD_MIN_UPDATES:
        chunk += 1
        if chunk > 20:
            raise RuntimeError(f"quadrotor: {steps} steps and {updates} "
                               f"updates after {chunk - 1} chunks")
        argv = ["--max_episodes", str(chunk * QUAD_CHUNK),
                "--max_episode_steps", str(QUAD_EPISODE_STEPS)] + \
            QUAD_FLAGS + resume
        run, n_k1, n_steps, updates, secs = cli_run(
            "quadrotor", argv, card, f"quadrotor_{chunk}")
        launches += n_k1
        steps += n_steps
        seconds += secs
        goals += int(sum(r["goal_met"] for r in progress_rows(run)))
        resume = ["--resume", str(run / "checkpoint.npz")]
    if launches:
        raise RuntimeError(f"quadrotor: {launches} K1 launches (its mlp "
                           "NODE has no kernel)")
    barrier = last_barrier_td("quadrotor", run)
    phase(f"quadrotor: {steps} env steps, {updates} updates in {chunk} "
          f"chunks of {QUAD_CHUNK} episodes, {goals} goals reached, 0 K1 "
          f"launches, {steps / seconds:.2f} env-steps/s, last "
          f"barrier_td_loss {barrier:.6g}, barrier.pkl written, on {card}")
    return run, argv


def events_ms(fn, calls, warm=True):
    """Device ms per call: CUDA events around ``calls`` calls issued from
    Python (the while form reads the device once per trial step, so it
    cannot be captured in a graph), after one warm-up call if ``warm``."""
    if warm:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def dopri5_on_card(dev, gen, card):
    """The adaptive solver on the unicycle NODE field at full width over
    the span dt: both forms on the card against the CPU (values, time
    reached, trial counts), the adjoint's gradients against the scan
    form's, and the time of each, forward and with the gradient."""
    cfg = get_config("unicycle")
    ncfg, dt = cfg.node, cfg.env.dt
    field = make_field(ncfg)
    params = node_params(3, 2, gen, dev)
    params_cpu = tree_map(lambda p: p.detach().cpu(), params)
    scale = torch.tensor(get_env("unicycle").SPEC.action_high, device=dev)
    forms = {"while": 512, "scan": ncfg.adaptive_scan_steps}
    for rows in DOPRI5_ROWS:
        x = torch.randn(rows, 3, device=dev, generator=gen)
        u = (torch.rand(rows, 2, device=dev, generator=gen) * 2 - 1) * scale
        s0 = pack_input(ncfg, x, u)
        cot = torch.randn(rows, 5, device=dev, generator=gen)
        grads = {}
        for impl, max_steps in forms.items():
            kw = dict(impl=impl, max_steps=max_steps)
            with torch.no_grad():
                trace_d, trace_c = [], []
                y_d, t_d = solve_adaptive(field, params, s0, 0.0, dt,
                                          return_final_t=True,
                                          trace=trace_d, **kw)
                y_c, t_c = solve_adaptive(field, params_cpu, s0.cpu(), 0.0,
                                          dt, return_final_t=True,
                                          trace=trace_c, **kw)
                n_d = sum(int(active) for _, _, active in trace_d)
                n_c = sum(int(active) for _, _, active in trace_c)
                err = (y_d.cpu() - y_c).abs().max().item()
                torch.testing.assert_close(y_d.cpu(), y_c, rtol=DOPRI5_RTOL,
                                           atol=DOPRI5_ATOL)
                if min(float(t_d), float(t_c)) < float(np.float32(dt)):
                    raise RuntimeError(f"dopri5 {impl} rows={rows}: reached "
                                       f"t {float(t_d)} (card), "
                                       f"{float(t_c)} (CPU) of {dt}")
                ms = events_ms(lambda: solve_adaptive(field, params, s0, 0.0,
                                                      dt, **kw), calls=5)

            def with_gradient():
                s_g = s0.clone().requires_grad_(True)
                y = (odeint_adjoint(field, params, s_g, 0.0, dt,
                                    method="dopri5") if impl == "while"
                     else solve_adaptive(field, params, s_g, 0.0, dt, **kw))
                grads[impl] = torch.autograd.grad(
                    (y * cot).sum(), tree_leaves(params) + [s_g])

            # the adjoint's backward takes seconds at 32768 rows: one call
            once = impl == "while" and rows > 128
            ms_grad = events_ms(with_gradient, calls=1 if once else 3,
                                warm=not once)
            phase(f"dopri5 {impl} rows={rows} (width 100, span {dt}): max "
                  f"abs err {err:.3e} card vs CPU (rtol {DOPRI5_RTOL} atol "
                  f"{DOPRI5_ATOL}), t reached {float(t_d):.9g} / "
                  f"{float(t_c):.9g}, trials {n_d} / {n_c}; {ms:.3f} ms per "
                  f"call forward, {ms_grad:.3f} ms with the gradient"
                  f"{' (adjoint)' if impl == 'while' else ''} on {card}")
        worst = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(grads["while"], grads["scan"]))
        if not worst <= ADJOINT_FRAC:
            raise RuntimeError(f"dopri5 rows={rows}: adjoint gradients off "
                               f"the scan form's by {worst:.3e} of a leaf's "
                               "largest entry")
        phase(f"dopri5 rows={rows}: the adjoint's parameter and y0 gradients "
              f"within {worst:.3e} of the scan form's (of each leaf's "
              f"largest entry; limit {ADJOINT_FRAC}) on {card}")


def dopri5_run(dev, card):
    """Unicycle with the scan-form dopri5 NODE through the CLI, its time
    per update, then one full-width update on the card against the CPU
    under each form. K1 must not launch (each stage needs f + g u alone)."""
    episodes, steps = DOPRI5_RUN
    argv = ["--max_episodes", str(episodes), "--max_episode_steps",
            str(steps), "--node_solver", "dopri5", "--node_adaptive_impl",
            "scan"]
    shorts = []
    warn = cli.warn_short
    cli.warn_short = lambda i, n: (shorts.append(n), warn(i, n))
    try:
        run, launches, n_steps, updates, seconds = cli_run(
            "unicycle", argv, card, "unicycle_dopri5_scan")
    finally:
        cli.warn_short = warn
    if launches or updates <= 0 or len(shorts) != episodes:
        raise RuntimeError(f"dopri5 scan: {launches} K1 launches, {updates} "
                           f"updates, {len(shorts)} episode counts")
    phase(f"unicycle dopri5 scan: {n_steps} env steps, {updates} updates, "
          f"{(updates + 9) // 10} NODE fits of 32768 rows (every 10th "
          f"update), {sum(shorts):.0f} integrations ended short of dt, 0 K1 "
          f"launches, {n_steps / seconds:.2f} env-steps/s on {card}")
    cfg, ts, rl, node, _, _ = restored("unicycle", argv, run, dev)
    time_updates(cfg, ts, rl, node, dev, card)
    for impl in ("scan", "while"):
        node_cfg = dataclasses.replace(cfg.node, adaptive_impl=impl)
        update_on_card_vs_cpu(dataclasses.replace(cfg, node=node_cfg), rl,
                              node, dev, DOPRI5_CHECK_NODE_ROWS)
    return launches


def host_checkpoint(run):
    """(extra, counters) of a host-loop run's checkpoint.npz."""
    with np.load(run / "checkpoint.npz") as z:
        return (json.loads(bytes(z["extra"]).decode()),
                [int(v) for v in z["counters"]])


def time_host_updates(argv, run, dev, card):
    """Host ms per update of a host-loop run's final state, as the host
    loop runs it: a batch sampled from the native ring, one copy to the
    card, ``update_presampled`` (the NODE fit every 10th included)."""
    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "unicycle", "--seed", str(SEED)] + argv))
    spec = get_env(cfg.env.name).SPEC
    gen = torch.Generator(dev).manual_seed(SEED)
    ts = create_train_state(cfg, gen, dev)
    rings = HostRings(cfg, spec, seed=SEED)
    node = create_replay(cfg.replay.node_capacity, spec.obs_dim,
                         spec.action_dim, spec.lyap_dim, dev)
    restore_host_checkpoint(str(run / "checkpoint.npz"), ts, rings.rl, node,
                            gen, torch.Generator())
    agent = make_agent(cfg, dev)

    def update():
        rows = torch.from_numpy(rings.rl.sample(cfg.sac.batch_size))
        batch = unpack_rows(rings.layout, rows.pin_memory().to(
            dev, non_blocking=True))
        agent.update_presampled(ts, batch, node, gen, 0)

    phase(f"{cfg.run.exp_name} host loop ({cfg.node.solver}): "
          f"{timed_updates(update, cfg, ts)}, the ring's sampling and the "
          f"copy included, on {card}")


def host_loop_runs(dev, card):
    """Unicycle under --host_loop: Euler (K1 on the path) for
    HOST_RUNS['euler'] episodes, resumed for one more, then dopri5 (the
    while form, adjoint gradients). Returns the K1 launches by run."""
    episodes, steps = HOST_RUNS["euler"]
    argv = ["--max_episodes", str(episodes), "--max_episode_steps",
            str(steps), "--host_loop"]
    opened = []
    writer_init = runtime_native.NativeTsvWriter.__init__

    def tap(self, path):
        opened.append(Path(path).resolve())
        writer_init(self, path)

    runtime_native.NativeTsvWriter.__init__ = tap
    try:
        run, launches, n_steps, updates, _ = cli_run(
            "unicycle", argv, card, "unicycle_host_loop")
        fits = launches - 2 * updates
        extra, counters = host_checkpoint(run)
        if (updates <= 0 or fits != (updates + 9) // 10
                or extra["mode"] != "host_loop"
                or counters != [updates, n_steps, episodes - 1]
                or (run / "progress.txt").resolve() not in opened):
            raise RuntimeError(f"host loop: {updates} updates, {launches} K1 "
                               f"launches, checkpoint {extra} {counters}, "
                               f"native writer opened {opened}")
        phase(f"unicycle host loop: {updates} updates, {fits} NODE fits of "
              f"32768 rows, {launches} K1 launches "
              f"({launches / n_steps:.2f} per env step); checkpoint.npz "
              f"mode {extra['mode']}; progress.txt written by the native "
              f"writer (runtime/host_buffer.cpp) on {card}")
        resume_argv = ["--max_episodes", str(episodes + 1),
                       "--max_episode_steps", str(steps), "--host_loop",
                       "--resume", str(run / "checkpoint.npz")]
        run2, launches2, steps2, updates2, _ = cli_run(
            "unicycle", resume_argv, card, "unicycle_host_loop_resumed")
    finally:
        runtime_native.NativeTsvWriter.__init__ = writer_init
    rows = progress_rows(run2)
    _, counters = host_checkpoint(run2)
    if ([r["Episode"] for r in rows] != [episodes] or launches2 <= 0
            or counters != [updates2, n_steps + steps2, episodes]):
        raise RuntimeError(f"host-loop resume: episodes "
                           f"{[r['Episode'] for r in rows]}, checkpoint "
                           f"counters {counters}, {launches2} launches")
    phase(f"host-loop resume: episode {episodes} continued from episode "
          f"{episodes - 1}'s checkpoint, {counters[1]} env steps and "
          f"{counters[0]} updates in all")

    episodes, steps = HOST_RUNS["dopri5"]
    argv = ["--max_episodes", str(episodes), "--max_episode_steps",
            str(steps), "--host_loop", "--node_solver", "dopri5"]
    run3, launches3, _, updates3, _ = cli_run(
        "unicycle", argv, card, "unicycle_host_loop_dopri5")
    if launches3 or updates3 <= 0:
        raise RuntimeError(f"host loop dopri5: {launches3} K1 launches, "
                           f"{updates3} updates")
    time_host_updates(argv, run3, dev, card)
    return {"unicycle_host_loop": launches,
            "unicycle_host_loop_resumed": launches2,
            "unicycle_host_loop_dopri5": launches3}


def tanh_saturation(card):
    """Where ``torch.tanh`` first returns exactly 1.0 on the card and on the
    CPU, and the policy's squash term log(scale (1 - tanh^2) + 1e-6) on
    each against a float64 evaluation, below |x| = 7.99 and over the rest
    of tests/test_torch_port_squash.py's float32 grid (|x| in [3, 9.1];
    XLA's CPU tanh saturates from 7.9988, the CPU's torch.tanh from
    9.0108)."""
    half = np.linspace(3.0, 9.1, 122001, dtype=np.float32)
    x = np.concatenate([-half[::-1], half])
    below = np.abs(x) < 7.99
    y64 = np.tanh(x.astype(np.float64))
    found = {}
    for where in ("cuda", "cpu"):
        xt = torch.from_numpy(x).to(where)
        y = torch.tanh(xt)
        sat = (y.abs() == 1.0).cpu().numpy()
        first = float(np.abs(x[sat]).min()) if sat.any() else None
        gaps = []
        for scale in TANH_SCALES:
            term = torch.log(torch.tensor(scale, device=where)
                             * (1.0 - torch.square(y)) + 1e-6)
            ref = np.log(scale * (1.0 - np.square(y64)) + 1e-6)
            err = np.abs(term.cpu().numpy() - ref)
            gaps.append((float(err[below].max()), float(err[~below].max())))
        found[where] = (first, gaps, y.cpu().numpy())
    if found["cuda"][0] is None:
        raise RuntimeError("tanh: no grid point saturates on the card")
    apart = int((found["cuda"][2] != found["cpu"][2]).sum())
    scales = "/".join(f"{s:g}" for s in TANH_SCALES)

    def show(gaps, i):
        return "/".join(f"{g[i]:.4f}" for g in gaps)

    phase(f"tanh: torch.tanh first returns 1.0 at |x| = "
          f"{found['cuda'][0]:.5f} on the card, {found['cpu'][0]:.5f} on "
          f"the CPU ({apart} of {x.size} grid values differ); squash term's "
          f"largest gap to float64 at scales {scales}, over [3, 7.99): card "
          f"{show(found['cuda'][1], 0)}, CPU {show(found['cpu'][1], 0)}; "
          f"over [7.99, 9.1]: card {show(found['cuda'][1], 1)}, CPU "
          f"{show(found['cpu'][1], 1)} nats, on {card}")
    return {"first_saturated_cuda": found["cuda"][0],
            "first_saturated_cpu": found["cpu"][0],
            "gap_to_f64_below_7_99_cuda": [g[0] for g in found["cuda"][1]],
            "gap_to_f64_below_7_99_cpu": [g[0] for g in found["cpu"][1]],
            "gap_to_f64_cuda": [g[1] for g in found["cuda"][1]],
            "gap_to_f64_cpu": [g[1] for g in found["cpu"][1]]}


def xla_tanh_on_card(dev, card):
    """The XLA-form tanh (``--squash xla``) on the card against the CPU,
    bit for bit: forward over a float32 grid on [-10, 10], every float32
    in [7.9988, 7.9989] and within TANH_TINY_ULPS of +-0.0004 (both
    signs), and its gradient at the same points for seeded normal
    cotangents; then one soft target update of a full-width critic on the
    card against the CPU, bit for bit. Returns the figures."""
    grid = np.linspace(-10.0, 10.0, TANH_GRID, dtype=np.float32)
    sat = np.arange(np.float32(7.9988).view(np.int32),
                    np.float32(7.9989).view(np.int32) + 1,
                    dtype=np.int32).view(np.float32)
    t = np.float32(0.0004).view(np.int32)
    tiny = np.arange(t - TANH_TINY_ULPS, t + TANH_TINY_ULPS + 1,
                     dtype=np.int32).view(np.float32)
    x = np.concatenate([grid, sat, -sat, tiny, -tiny])
    g = np.random.default_rng(SEED).standard_normal(x.size).astype(
        np.float32)
    out = []
    for where in (dev, "cpu"):
        xt = torch.from_numpy(x).to(where).requires_grad_()
        y = xla_tanh(xt)
        y.backward(torch.from_numpy(g).to(where))
        out.append([a.detach().cpu().numpy().view(np.int32)
                    for a in (y, xt.grad)])
    fwd, bwd = (int((a != b).sum()) for a, b in zip(*out))
    y = out[0][0].view(np.float32)
    first = float(np.abs(x[np.abs(y) == 1.0]).min())

    cfg = get_config("unicycle")
    gen = torch.Generator().manual_seed(SEED + 5)
    ts = create_train_state(cfg, gen, "cpu")
    online = tree_map(lambda p: p.detach() + 0.01 * torch.randn(
        p.shape, generator=gen), ts.critic)
    target = tree_map(lambda p: p.detach().clone(), ts.critic_target)
    target_dev = tree_map(lambda p: p.to(dev), target)
    soft_update(target, online, cfg.sac.tau)
    soft_update(target_dev, tree_map(lambda p: p.to(dev), online),
                cfg.sac.tau)
    soft = sum(int((a.cpu().numpy().view(np.int32)
                    != b.numpy().view(np.int32)).sum())
               for a, b in zip(tree_leaves(target_dev), tree_leaves(target)))
    n_soft = sum(p.numel() for p in tree_leaves(target))
    if fwd or bwd or soft:
        raise RuntimeError(f"card vs CPU: XLA-form tanh {fwd} values and "
                           f"{bwd} gradients of {x.size} differ, the soft "
                           f"update {soft} of {n_soft} entries")
    phase(f"xla tanh: card vs CPU bit for bit over {x.size} float32 "
          f"inputs (forward and gradient; the grid, [7.9988, 7.9989] and "
          f"+-0.0004 +- {TANH_TINY_ULPS} ulps), first +-1 at |x| = "
          f"{first:.7f}; the soft update of a full-width critic "
          f"({n_soft} entries) bit for bit, on {card}")
    return {"inputs": int(x.size), "forward_apart": fwd,
            "gradient_apart": bwd, "first_saturated": first,
            "soft_update_entries": n_soft, "soft_update_apart": soft}


def squash_on_card(cfg, ts, rl, node, dev, card):
    """Phase 5's squash checks: one full-width update from a fresh state
    under ``squash="torch"`` (the option; phase 5 holds the default's) on
    the card against the CPU (UPDATE_RTOL / UPDATE_ATOL), then ms per
    update of ``ts`` (stepped in place) on its replays under each squash,
    in SQUASH_BLOCKS interleaved blocks of SQUASH_BLOCK updates (each
    block holds one NODE fit). Returns the figures."""
    update_on_card_vs_cpu(cfg, rl, node, dev, squash="torch")
    agents = {s: make_agent(cfg, dev, squash=s) for s in ("torch", "xla")}
    gen = torch.Generator(dev).manual_seed(SEED + 6)
    for agent in agents.values():  # warm-up
        agent.update(ts, rl, node, gen, 0)
    times = {s: [] for s in agents}
    for _ in range(SQUASH_BLOCKS):
        for s, agent in agents.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(SQUASH_BLOCK):
                agent.update(ts, rl, node, gen, 0)
            torch.cuda.synchronize()
            times[s].append((time.perf_counter() - t0) / SQUASH_BLOCK * 1e3)
    med = {s: statistics.median(v) for s, v in times.items()}
    phase(f"squash: ms per update (host clock, median of {SQUASH_BLOCKS} "
          f"interleaved blocks of {SQUASH_BLOCK}, a NODE fit in each): "
          f"torch {med['torch']:.2f}, xla {med['xla']:.2f} "
          f"({med['xla'] / med['torch']:.3f} times) on {card}")
    return {"ms_per_update": med, "block_ms": times}


def squash_only(dev, card):
    """``--squash``: the squash's checks alone (the module's note)."""
    t0 = time.perf_counter()
    lib = node_kernel.build(verbose=True)
    phase(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    figures = {"tanh": xla_tanh_on_card(dev, card)}
    episodes, steps = SQUASH_RUN
    argv = ["--max_episodes", str(episodes), "--max_episode_steps",
            str(steps), "--start_steps", str(steps), "--squash", "xla"]
    run, launches, _, _, _ = cli_run("unicycle", argv, card, "unicycle_xla")
    if launches <= 0 or not (run / "squash.json").is_file():
        raise RuntimeError(f"--squash xla: {launches} K1 launches, "
                           f"squash.json {(run / 'squash.json').is_file()}")
    cfg, ts, rl, node, _, _ = restored("unicycle", argv, run, dev, "xla")
    figures["update"] = squash_on_card(cfg, ts, rl, node, dev, card)
    print(json.dumps({"squash": figures}), flush=True)
    phase(f"squash checks: {time.perf_counter() - t0:.2f} s on {card}")
    return 0


def main_run_dir():
    (run,) = (OUT / "unicycle").glob("*-run*/*/*_s*")
    return run


def eval_runs(card, quad_dir):
    """The evaluator on the card: ``--mode eval`` through the CLI on the
    main path's run directory, ``python -m nlbac_tpu_torch.utils.evaluate
    ... --json`` in its own process, and the quadrotor's deterministic
    rollouts on the card held against the CPU's."""
    from nlbac_tpu_torch.utils.evaluate import load_trained_state, run_policy

    run = main_run_dir()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli.main(["--preset", "unicycle", "--mode", "eval", "--seed", str(SEED),
              "--max_episode_steps", str(EPISODE_STEPS), "--output",
              str(run)])
    torch.cuda.synchronize()
    phase(f"eval: nlbac-train-torch --mode eval, 5 episodes of at most "
          f"{EPISODE_STEPS} steps, {time.perf_counter() - t0:.2f} s on "
          f"{card}")

    path = OUT / "eval.json"
    proc = subprocess.run(
        [sys.executable, "-m", "nlbac_tpu_torch.utils.evaluate", str(run),
         "--preset", "unicycle", "--episodes", "2", "--json", str(path)],
        cwd=Path(__file__).resolve().parent, capture_output=True, text=True,
        timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"evaluate: rc {proc.returncode}\n{proc.stderr}")
    data = json.loads(path.read_text())
    ms = [float(v) for v in re.findall(r" ms=([0-9.]+)", proc.stdout)]
    if (list(data) != ["preset", "run_dir", "seed", "deterministic",
                       "episodes", "mean"] or len(data["episodes"]) != 2
            or len(ms) != 2 or not all(math.isfinite(v) for e in
                                       data["episodes"] for v in e.values())):
        raise RuntimeError(f"evaluate --json: {data}\n{proc.stdout}")
    for i, (e, t) in enumerate(zip(data["episodes"], ms)):
        phase(f"evaluate --json episode {i} (unicycle, full 1200-step "
              f"budget): return {e['return']:.4f} length {e['length']} "
              f"violations {e['violations']:.0f}, {t:.1f} ms for the "
              f"episode ({t / e['length']:.3f} ms per step, one device read "
              f"each) on {card}")

    cfg = cli.config_from_args(cli.build_parser().parse_args(
        ["--preset", "quadrotor", "--seed", str(SEED), "--max_episode_steps",
         str(EVAL_QUAD_STEPS)] + QUAD_FLAGS))
    res = {}
    for where in ("cuda", "cpu"):
        ts = load_trained_state(cfg, str(quad_dir), torch.device(where))
        res[where] = run_policy(cfg, ts, episodes=2, seed=SEED)
    worst = 0.0
    for a, b in zip(res["cuda"], res["cpu"]):
        for k in ("return", "length", "violations"):
            gap = abs(a[k] - b[k])
            if gap > UPDATE_ATOL + UPDATE_RTOL * abs(b[k]):
                raise RuntimeError(f"quadrotor eval, card vs CPU: {k} "
                                   f"{a[k]} vs {b[k]}")
            worst = max(worst, gap)
    phase(f"quadrotor eval (the run's weights, ground start, at most "
          f"{EVAL_QUAD_STEPS} steps), card vs CPU: returns "
          + ", ".join(f"{a['return']:.5f}/{b['return']:.5f}"
                      for a, b in zip(res["cuda"], res["cpu"]))
          + f", lengths {[a['length'] for a in res['cuda']]}, violations "
          f"{[a['violations'] for a in res['cuda']]}; largest gap {worst:.3g}"
          f" (rtol {UPDATE_RTOL} / atol {UPDATE_ATOL}) on {card}")


def export_run(dev, card):
    """The main path's policy exported with torch.export (on the card, and
    on the CPU then moved with .to), loaded back and held against the
    policy's deterministic head on the card; host µs per call at batch
    1."""
    from nlbac_tpu_torch.nn import ActionSpec, policy_mean_action
    from nlbac_tpu_torch.utils.evaluate import load_trained_state
    from nlbac_tpu_torch.utils.export_policy import export_policy, load_policy

    run = main_run_dir()
    cfg = get_config("unicycle")
    acts = {}
    for where in ("cuda", "cpu"):
        ts = load_trained_state(cfg, str(run), torch.device(where))
        path = OUT / f"policy_{where}.pt2"
        t0 = time.perf_counter()
        export_policy(cfg, ts, str(path))
        secs = time.perf_counter() - t0
        act, manifest = load_policy(str(path))
        acts[where] = (act.to(dev), secs, path.stat().st_size)
        if where == "cuda":
            ts_card = ts
    spec = ActionSpec.from_bounds(get_env("unicycle").SPEC.action_low,
                                  get_env("unicycle").SPEC.action_high, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 5)
    worst = 0.0
    with torch.no_grad():
        for n in EXPORT_BATCHES:
            obs = torch.randn(n, cfg.obs_dim, device=dev, generator=gen)
            det = policy_mean_action(ts_card.policy, obs, spec)
            for where, (act, _, _) in acts.items():
                err = (act(obs) - det).abs().max().item()
                if not err <= EXPORT_ATOL:
                    raise RuntimeError(f"export ({where}) at batch {n}: "
                                       f"{err} from det_action")
                worst = max(worst, err)
        obs1 = torch.randn(1, cfg.obs_dim, device=dev, generator=gen)
        act = acts["cuda"][0]
        us = host_us(lambda: act(obs1))
        us_plain = host_us(lambda: policy_mean_action(ts_card.policy, obs1,
                                                      spec))
    phase(f"export: torch.export of the deterministic head (symbolic batch, "
          f"{acts['cuda'][2]} bytes) in {acts['cuda'][1]:.2f} s on the card, "
          f"{acts['cpu'][1]:.2f} s on the CPU; loaded, at batch "
          f"{'/'.join(map(str, EXPORT_BATCHES))} within {worst:.3g} of "
          f"det_action on the card (both artifacts, the CPU one moved with "
          f".to('cuda'); limit {EXPORT_ATOL}); host {us:.2f} µs per call at "
          f"batch 1 ({us_plain:.2f} µs for the policy's own head) on {card}")


def profile_run(card):
    """A 2-episode unicycle run with --profile_dir: the trace of episode 1
    holds the card's kernels, K1 among them. The trace is read, then
    removed (it is tens of MB)."""
    trace_dir = OUT / "profile_trace"
    shutil.rmtree(trace_dir, ignore_errors=True)
    episodes, steps = PROFILE_RUN
    argv = ["--max_episodes", str(episodes), "--max_episode_steps",
            str(steps), "--profile_dir", str(trace_dir)]
    _, launches, _, updates, _ = cli_run("unicycle", argv, card,
                                         "unicycle_profiled")
    traces = sorted(trace_dir.iterdir())
    if [t.name for t in traces] != ["episode1.trace.json"]:
        raise RuntimeError(f"profile: traces {traces}")
    size = traces[0].stat().st_size
    events = json.loads(traces[0].read_text())["traceEvents"]
    shutil.rmtree(trace_dir)
    kernels = [e for e in events if e.get("cat") == "kernel"]
    k1 = [e for e in kernels if "node_euler" in e.get("name", "")]
    if not k1 or updates <= 0:
        raise RuntimeError(f"profile: {len(kernels)} kernel events, "
                           f"{len(k1)} of K1, {updates} updates")
    k1_ms = sum(e.get("dur", 0) for e in k1) / 1e3
    phase(f"profile: episode 1's trace {size} bytes, {len(events)} events, "
          f"{len(kernels)} CUDA kernel events, {len(k1)} of them K1 "
          f"({k1_ms:.3f} ms; {launches} K1 launches in the run, {updates} "
          f"updates) on {card}")
    return launches


def custom_env_runs(card):
    """The point-mass envs of examples/torch_custom_env.py (a hand-written
    CBF) and examples/torch_custom_barrier_env.py (a learned barrier, its
    builder USES_BARRIER), each registered at runtime and trained
    CUSTOM_RUN episodes on the card through the CLI module's train();
    their control-affine NODE runs K1. Returns the K1 launches of each."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import torch_custom_barrier_env
    import torch_custom_env
    from nlbac_tpu_torch.train.cli import train

    episodes, steps = CUSTOM_RUN
    launches = {}
    for name, example, make in (
            ("custom_env", torch_custom_env, torch_custom_env.make_config),
            ("custom_barrier_env", torch_custom_barrier_env,
             torch_custom_barrier_env.make_barrier_config)):
        example.register()
        cfg = make(max_episodes=episodes)
        cfg = dataclasses.replace(cfg, env=dataclasses.replace(
            cfg.env, max_episode_steps=steps))
        out = OUT / name
        shutil.rmtree(out, ignore_errors=True)
        node_kernel.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, _, _ = train(cfg, output_dir=str(out), quiet=True,
                         device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches[name] = node_kernel.launch_counts["node_euler"]
        rows = progress_rows(out)
        bad = [k for r in rows for k, v in r.items() if not math.isfinite(v)]
        n_steps = int(sum(r["episode_steps"] for r in rows))
        barrier = cfg.env.barrier_signals
        btd = max(r.get("barrier_td_loss", 0.0) for r in rows)
        if (bad or len(rows) != episodes or ts.updates <= 0
                or launches[name] <= 0 or (barrier and not btd > 0)):
            raise RuntimeError(f"{name}: rows {rows}, {ts.updates} "
                               f"updates, {launches[name]} K1 launches, "
                               f"non-finite {bad}")
        phase(f"{name} ({cfg.env.name}, registered at runtime): {n_steps} "
              f"env steps, {ts.updates} updates, {launches[name]} K1 "
              f"launches, rewards "
              f"{[round(r['reward_train'], 3) for r in rows]}"
              + (f", largest barrier_td_loss {btd:.4g}" if barrier else "")
              + f", {n_steps / secs:.2f} env-steps/s on {card}")
    return launches


def seeds_run(dev, card, one_seed):
    """``--n_seeds SEEDS`` at the main path's depth through the CLI's
    ``train_multi_seed`` (its worker processes; each worker's K1 counts
    start at 0 with it and come back with every episode), with
    ``--start_steps`` one episode so that the policy acts from the second
    episode on: each seed's env steps, updates and K1 launches, the
    aggregate env-steps/s beside the main path's one-seed run of this call
    (the same argv for one seed), and seed 0's first episode (all random
    warm-up actions) against that run's. Returns K1's launches by path and the
    run's output directory, env steps, seconds and env-steps/s."""
    out = OUT / "unicycle_seeds"
    shutil.rmtree(out, ignore_errors=True)
    argv = ["--preset", "unicycle", "--quiet", "--seed", str(SEED),
            "--n_seeds", str(SEEDS), "--max_episodes", str(EPISODES),
            "--max_episode_steps", str(EPISODE_STEPS), "--start_steps",
            str(EPISODE_STEPS)]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    node_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, launches = cli.train_multi_seed(cfg, SEEDS, str(out), quiet=True,
                                       device=dev)
    seconds = time.perf_counter() - t0
    steps_all = 0
    for i in range(SEEDS):
        rows = progress_rows(out / f"s{SEED + i}")
        steps = int(sum(r["episode_steps"] for r in rows))
        updates = int(rows[-1]["updates"])
        bad = [k for r in rows for k, v in r.items() if not math.isfinite(v)]
        if bad or len(rows) != EPISODES or updates <= 0 or launches[i] <= 0:
            raise RuntimeError(f"seed {SEED + i}: {len(rows)} episodes, "
                               f"{updates} updates, {launches[i]} K1 "
                               f"launches, non-finite {bad}")
        steps_all += steps
        phase(f"seeds: seed {SEED + i}: {steps} env steps, {updates} "
              f"updates, {launches[i]} K1 launches, rewards "
              f"{[round(r['reward_train'], 3) for r in rows]}")
    first = progress_rows(out / f"s{SEED}")[0]
    alone = progress_rows(one_seed["run"])[0]
    gaps = {k: abs(first[k] - alone[k]) / max(abs(alone[k]), 1e-30)
            for k in ("reward_train", "node_loss")}
    if any(g > 1e-5 for g in gaps.values()):
        raise RuntimeError(f"seeds: seed {SEED}'s first episode vs the "
                           f"standalone run: relative gaps {gaps}")
    rate, rate1 = steps_all / seconds, one_seed["steps"] / one_seed["seconds"]
    phase(f"seeds: --n_seeds {SEEDS} ({EPISODES} x {EPISODE_STEPS} steps "
          f"each, worker processes, the policy acting from step "
          f"{EPISODE_STEPS}): {steps_all} env steps in "
          f"{seconds:.2f} s for the whole train_multi_seed() call (the "
          f"workers' start included), {rate:.2f} env-steps/s in all, "
          f"against {rate1:.2f} for the one-seed run of phase 5 "
          f"({rate / rate1:.3f} times); {sum(launches)} K1 launches; seed "
          f"{SEED}'s first episode vs the standalone run: reward relative "
          f"gap {gaps['reward_train']:.3e}, node_loss "
          f"{gaps['node_loss']:.3e} (limit 1e-5) on {card}")
    return {"unicycle_seeds": sum(launches)}, {
        "out": out, "steps": steps_all, "seconds": seconds, "rate": rate}


def gang_cfg():
    cfg = get_config("unicycle")
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env, max_episode_steps=GANG_STEPS),
        run=dataclasses.replace(cfg.run, max_episodes=1, seed=SEED))


def state_arrays(ts):
    """A whole state on the host, in a fixed order: ``params`` (the
    parameters, targets and Lagrangian state) and ``moments`` (every Adam
    moment, per optimizer group), with the update count."""
    params = [t.detach().cpu().numpy() for name in (
        "policy", "backup_policy", "critic", "critic_target", "lyap",
        "lyap_target", "barrier", "barrier_target", "node", "log_alpha",
        "backup_log_alpha") for t in tree_leaves(getattr(ts, name))]
    params += [t.cpu().numpy() for t in ts.lag]
    moments = [opt.state[p][k].cpu().numpy() for opt in ts.opt.values()
               for p in opt.param_groups[0]["params"] if p in opt.state
               for k in ("exp_avg", "exp_avg_sq")]
    return {"params": params, "moments": moments}, ts.updates


def one_episode(cfg, place, run, dev):
    """One episode from seed SEED's state and generator (given to every
    rank by ``place``), the policy acting from the first update on (the
    replay then holds more than a batch), K1's launches counted and the
    time taken around it alone; the same episode runs once before,
    untimed, so that the process's first-call set-up (cuBLAS, K1's
    library) is not timed."""
    for _ in range(2):  # an untimed first pass, then the timed one
        gen = torch.Generator(dev).manual_seed(SEED)
        ts = create_train_state(cfg, gen, dev)
        rl, node = create_replays(cfg, dev)
        first_update = cfg.sac.batch_size + 1
        ts, rl, node, gen, total = place(
            (ts, rl, node, gen, cfg.sac.start_steps - first_update))
        torch.cuda.synchronize()
        node_kernel.reset_launch_counts()
        t0 = time.perf_counter()
        ts, rl, node, m, total = run(ts, rl, node, gen, 0, total)
        host = episode_to_host(m)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    return ts, {"reward": host["reward"], "steps": host["steps"],
                "train": host["train"], "seconds": seconds,
                "launches": node_kernel.launch_counts["node_euler"],
                "rows": dict(node_kernel.launches_by_rows)}


def gang_rank(rank, world, coordinator, device):
    """One rank of the gangs sharing ``device`` (the card) over gloo: in
    each layout of GANG_LAYOUTS one episode, then its (under tp, the
    gathered) whole state to OUT/gang_<layout>_r<rank>.pkl."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    parallel.init_distributed(coordinator, world, rank, backend="gloo",
                              device=dev)
    cfg = gang_cfg()
    for name, (dp, tp) in GANG_LAYOUTS:
        grid = parallel.make_mesh((dp, tp))
        place, run = parallel.make_parallel_runner(cfg, grid, dev)
        ts, result = one_episode(cfg, place, run, dev)
        whole = parallel.gather_state_tp(ts) if tp > 1 else ts
        result["state"] = state_arrays(whole)
        (OUT / f"gang_{name}_r{rank}.pkl").write_bytes(pickle.dumps(result))


def relative_gap(a, b) -> float:
    """||a - b|| / ||b|| (0 when both are 0, inf when only b is)."""
    den = float(np.linalg.norm(b))
    num = float(np.linalg.norm(np.asarray(a, np.float64) - b))
    return num / den if den > 0 else (0.0 if num == 0 else math.inf)


def gang_runs(dev, card):
    """A dp=2 and a tp=2 gang of two ranks on this one card (gloo, as
    ranks that share a card must), each one full-width unicycle episode,
    the policy acting from the first update on, against one rank from the
    same state and seed."""
    cfg = gang_cfg()
    ts1, one = one_episode(cfg, lambda tree: tree,
                           make_episode_runner(cfg, dev), dev)
    want, updates = state_arrays(ts1)
    if one["launches"] <= 0 or updates <= 0:
        raise RuntimeError(f"gangs: one rank ran {updates} updates, "
                           f"{one['launches']} K1 launches")
    phase(f"gangs: one rank: {one['steps']} steps (the policy's from the "
          f"first update's), {updates} updates, {one['launches']} K1 "
          f"launches by rows {one['rows']}, "
          f"{one['seconds']:.2f} s, reward {one['reward']:.6g} on {card}")
    launches = {}
    rank_dev = "cuda:0" if dev.type == "cuda" else str(dev)
    failed = []
    for name, _ in GANG_LAYOUTS:
        for r in range(2):
            (OUT / f"gang_{name}_r{r}.pkl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    parallel.run_gang(gang_rank, 2, (rank_dev,),
                      timeout=GANG_TIMEOUT * len(GANG_LAYOUTS))
    wall = time.perf_counter() - t0
    for name, (dp, tp) in GANG_LAYOUTS:
        ranks = [pickle.loads((OUT / f"gang_{name}_r{r}.pkl").read_bytes())
                 for r in range(2)]
        got, got_updates = ranks[0]["state"]
        other, other_updates = ranks[1]["state"]
        same = got_updates == other_updates and all(
            np.array_equal(a, b) for key in got
            for a, b in zip(got[key], other[key]))
        pairs = [(a, b) for key in got for a, b in zip(got[key], want[key])]
        gap = max(float(np.max(np.abs(a - b))) for a, b in pairs)
        state_ok = got_updates == updates and all(
            np.allclose(a, b, rtol=GANG_STATE_RTOL, atol=GANG_STATE_ATOL)
            for a, b in pairs)
        moment_gap = max(relative_gap(a, b)
                         for a, b in zip(got["moments"], want["moments"]))
        moments_ok = moment_gap <= GANG_STATE_RTOL
        metric_gaps = {k: relative_gap(ranks[0]["train"][k],
                                       one["train"][k])
                       for k in GANG_METRICS}
        metrics_ok = max(metric_gaps.values()) <= GANG_METRIC_RTOL
        losses = ", ".join(f"{k} {v:.3e}" for k, v in metric_gaps.items())
        reward_gap = abs(ranks[0]["reward"] - one["reward"])
        reward_ok = reward_gap <= GANG_REWARD_ATOL + \
            GANG_REWARD_RTOL * abs(one["reward"])
        half = {rows // dp: n for rows, n in one["rows"].items()}
        k1_ok = all((r["rows"] == half) if name == "dp"
                    else r["launches"] == 0 for r in ranks)
        for r, res in enumerate(ranks):
            launches[f"unicycle_{name}2_rank{r}"] = res["launches"]
        phase(f"gangs: {name}=2 on one card (gloo): rank seconds "
              f"{[round(r['seconds'], 2) for r in ranks]} for the episode "
              f"(one rank {one['seconds']:.2f}), {wall:.2f} s for the "
              f"gangs of {len(GANG_LAYOUTS)} layouts with their one spawn; "
              f"reward {ranks[0]['reward']:.6g} (gap "
              f"{reward_gap:.3e}); whole state's largest gap {gap:.3e} "
              f"(rtol {GANG_STATE_RTOL} atol {GANG_STATE_ATOL}); Adam "
              f"moments' largest relative gap {moment_gap:.3e} (limit "
              f"{GANG_STATE_RTOL}); last update's losses' relative gaps "
              f"{losses} (limit {GANG_METRIC_RTOL}); ranks bit-equal "
              f"{same}; K1 "
              f"launches by rows per rank {[r['rows'] for r in ranks]} "
              f"on {card}")
        if not (same and state_ok and moments_ok and metrics_ok
                and reward_ok and k1_ok):
            failed.append(f"{name}=2 vs one rank: state ok {state_ok}, "
                          f"moments ok {moments_ok}, losses ok "
                          f"{metrics_ok}, reward ok {reward_ok}, ranks "
                          f"equal {same}, K1 ok {k1_ok}")
    if failed:
        raise RuntimeError(f"gangs: {'; '.join(failed)}")
    return launches

# ---------------------------------------------------------------------------
# dopri5 in gangs, the experimental levers, the bf16 NODE, the start-up path
# ---------------------------------------------------------------------------

class TrialCounter:
    """Counts this process's adaptive trial steps that advance (the scan
    form's frozen trials step by 0) on the device, with no host read: it
    wraps the solver's trial for the life of the process."""

    def __init__(self, dev):
        self.n = torch.zeros((), dtype=torch.int64, device=dev)
        inner = solvers._trial

        def counted(field, params, t, y, dt, *rest):
            self.n += (dt != 0).sum()  # (S,) steps under a seed axis
            return inner(field, params, t, y, dt, *rest)

        solvers._trial = counted


def timed_update_block(cfg, times):
    """An ``_update_step`` hook running the default block of
    ``updates_per_step`` updates, each timed alone between two
    synchronizes (host ms appended to ``times``)."""
    def step(agent, c, gen, i_episode):
        ts, m, shorts = c.ts, c.train, 0
        for _ in range(cfg.sac.updates_per_step):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ts, m = agent.update(ts, c.rl_replay, c.node_replay, gen,
                                 i_episode)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            shorts = shorts + m["short_integrations"]
        return ts, {**m, "short_integrations": shorts}

    return step


def dopri5_gang_cfg(impl):
    cfg = get_config("unicycle")
    return dataclasses.replace(
        cfg, env=dataclasses.replace(cfg.env,
                                     max_episode_steps=DOPRI5_GANG_STEPS),
        node=dataclasses.replace(cfg.node, solver="dopri5",
                                 adaptive_impl=impl),
        run=dataclasses.replace(cfg.run, max_episodes=1, seed=SEED))


def dopri5_gang_episode(cfg, grid, dev, trials, ulp=False):
    """One episode of ``cfg`` on ``grid`` (None: one rank), from seed
    SEED's state (with ``ulp``, its NODE weights moved one ulp up), the
    policy acting from the first update block; each update timed. Returns
    the state and the episode's numbers."""
    dp_group = grid.dp_comm if grid is not None and grid.dp > 1 else None
    agent = make_agent(cfg, dev, dp_group=dp_group)
    times = []
    run = make_episode_runner(cfg, dev, agent=agent,
                              _update_step=timed_update_block(cfg, times))
    gen = torch.Generator(dev).manual_seed(SEED)
    ts = create_train_state(cfg, gen, dev)
    if ulp:
        with torch.no_grad():
            for p in tree_leaves(ts.node):
                p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
    rl, node = create_replays(cfg, dev)
    tree = (ts, rl, node, gen, cfg.sac.start_steps - cfg.sac.batch_size - 1)
    if grid is not None:
        tree = parallel.broadcast(tree, grid.comm, dev)
        if grid.tp > 1:
            tree = (parallel.shard_state_tp(tree[0], grid),) + tree[1:]
    ts, rl, node, gen, total = tree
    torch.cuda.synchronize()
    trials.n.zero_()
    node_kernel.reset_launch_counts()
    ts, rl, node, m, total = run(ts, rl, node, gen, 0, total)
    host = episode_to_host(m)
    return ts, {"reward": host["reward"], "steps": host["steps"],
                "shorts": host["short_integrations"], "ms": times,
                "trials": int(trials.n),
                "launches": node_kernel.launch_counts["node_euler"]}


def dopri5_gang_rank(rank, world, coordinator, device):
    """One rank of the dopri5 gangs sharing ``device`` over gloo: in each
    layout of GANG_LAYOUTS an episode per form, then its (under tp,
    gathered) whole state and numbers to
    OUT/dopri5_gang_<layout>_r<rank>.pkl."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    parallel.init_distributed(coordinator, world, rank, backend="gloo",
                              device=dev)
    trials = TrialCounter(dev)
    for name, (dp, tp) in GANG_LAYOUTS:
        grid = parallel.make_mesh((dp, tp))
        out = {}
        for impl in DOPRI5_IMPLS:
            ts, res = dopri5_gang_episode(dopri5_gang_cfg(impl), grid, dev,
                                          trials)
            res["state"] = parallel.state_arrays(
                parallel.gather_state_tp(ts) if tp > 1 else ts)
            out[impl] = res
        (OUT / f"dopri5_gang_{name}_r{rank}.pkl").write_bytes(
            pickle.dumps(out))


def _flat(state, key):
    return [a for x in state[key]
            for a in (x if isinstance(x, tuple) else (x,))]


def dopri5_state_gaps(got, want):
    """(ok outside the NODE, the largest gap outside the NODE, the NODE's
    largest gap over its leaf's largest entry and where it is, the
    largest relative gap of an Adam moment outside the NODE) of a state
    against one rank's."""
    ok = got["updates"] == want["updates"]
    gap = node_frac = moment_gap = 0.0
    where = None
    for key in want:
        if key == "updates":
            continue
        for i, (a, b) in enumerate(zip(_flat(got, key), _flat(want, key))):
            if key in ("node", "adam/node"):
                scale = float(np.max(np.abs(b))) if b.size else 0.0
                diff = float(np.max(np.abs(a - b))) if b.size else 0.0
                frac = diff / scale if scale else diff
                if frac > node_frac:
                    node_frac, where = frac, f"{key}[{i}]"
                continue
            if b.size:
                gap = max(gap, float(np.max(np.abs(a - b))))
            ok = ok and np.allclose(a, b, rtol=GANG_STATE_RTOL,
                                    atol=GANG_STATE_ATOL)
            if key.startswith("adam/"):
                moment_gap = max(moment_gap, relative_gap(a, b))
    ok = ok and moment_gap <= GANG_STATE_RTOL
    return ok, gap, node_frac, where, moment_gap


def dopri5_gang_runs(dev, card):
    """``--node_solver dopri5`` in a dp=2 and a tp=2 gang of two ranks on
    this one card (gloo), each form's episode against one rank's from the
    same state and seed: reward, state and Adam-moment gaps, the ranks'
    bit-equality and trial counts, and ms per update."""
    trials = TrialCounter(dev)
    one, floor = {}, {}
    for impl in DOPRI5_IMPLS:
        ts, res = dopri5_gang_episode(dopri5_gang_cfg(impl), None, dev,
                                      trials)
        res["state"] = parallel.state_arrays(ts)
        one[impl] = res
        ts_ulp, _ = dopri5_gang_episode(dopri5_gang_cfg(impl), None, dev,
                                        trials, ulp=True)
        _, _, floor[impl], where, _ = dopri5_state_gaps(
            parallel.state_arrays(ts_ulp), res["state"])
        phase(f"dopri5 gangs: one rank, {impl}: the NODE's weights one ulp "
              f"up move its state by {floor[impl]:.3e} of a leaf's largest "
              f"entry (at {where}): the float32 noise floor on {card}")
        phase(f"dopri5 gangs: one rank, {impl}: {res['steps']} steps, "
              f"updates {res['state']['updates']}, the fit update "
              f"({dopri5_gang_cfg(impl).node.max_batch} rows) "
              f"{res['ms'][0]:.2f} ms, the other "
              f"{len(res['ms']) - 1} {np.mean(res['ms'][1:]):.2f} ms each, "
              f"{res['trials']} trial steps, {res['shorts']:.0f} short "
              f"integrations, {res['launches']} K1 launches, reward "
              f"{res['reward']:.6g} on {card}")
    launches, failed = {}, []
    rank_dev = "cuda:0" if dev.type == "cuda" else str(dev)
    for name, _ in GANG_LAYOUTS:
        for r in range(2):
            (OUT / f"dopri5_gang_{name}_r{r}.pkl").unlink(missing_ok=True)
    t0 = time.perf_counter()
    parallel.run_gang(dopri5_gang_rank, 2, (rank_dev,),
                      timeout=GANG_TIMEOUT * len(GANG_LAYOUTS))
    wall = time.perf_counter() - t0
    for name, _ in GANG_LAYOUTS:
        ranks = [pickle.loads(
            (OUT / f"dopri5_gang_{name}_r{r}.pkl").read_bytes())
            for r in range(2)]
        for impl in DOPRI5_IMPLS:
            r0, r1 = ranks[0][impl], ranks[1][impl]
            want = one[impl]
            same = (r0["reward"] == r1["reward"]
                    and r0["trials"] == r1["trials"]
                    and r0["state"]["updates"] == r1["state"]["updates"]
                    and all(np.array_equal(a, b) for key in r0["state"]
                            if key != "updates"
                            for a, b in zip(_flat(r0["state"], key),
                                            _flat(r1["state"], key))))
            ok, gap, node_frac, where, moment_gap = dopri5_state_gaps(
                r0["state"], want["state"])
            node_limit = max(DOPRI5_GANG_NODE_FRAC[impl],
                             NOISE_FACTOR * floor[impl])
            ok = ok and node_frac <= node_limit
            reward_gap = abs(r0["reward"] - want["reward"])
            reward_ok = reward_gap <= GANG_REWARD_ATOL + \
                GANG_REWARD_RTOL * abs(want["reward"])
            k1_ok = all(r[impl]["launches"] == 0 for r in ranks)
            for r, res in enumerate(ranks):
                launches[f"unicycle_dopri5_{impl}_{name}2_rank{r}"] = \
                    res[impl]["launches"]
            fit_ms = [r[impl]["ms"][0] for r in ranks]
            rest_ms = [float(np.mean(r[impl]["ms"][1:])) for r in ranks]
            rest_one = float(np.mean(want["ms"][1:]))
            phase(f"dopri5 gangs: {name}=2 {impl} on one card (gloo): "
                  f"ms per update: the fit {[round(v, 2) for v in fit_ms]} "
                  f"(one rank {want['ms'][0]:.2f}), the other "
                  f"{[round(v, 2) for v in rest_ms]} (one rank "
                  f"{rest_one:.2f}, {rest_ms[0] / rest_one:.2f} times); "
                  f"trial steps {r0['trials']} / {r1['trials']} "
                  f"(one rank {want['trials']}); reward gap "
                  f"{reward_gap:.3e}; state's largest gap outside the "
                  f"NODE {gap:.3e} (rtol {GANG_STATE_RTOL} atol "
                  f"{GANG_STATE_ATOL}), the NODE's {node_frac:.3e} of a "
                  f"leaf's largest entry at {where} (limit "
                  f"{node_limit:.3e}), Adam moments' largest "
                  f"relative gap {moment_gap:.3e} (limit "
                  f"{GANG_STATE_RTOL}); ranks bit-equal {same}; K1 "
                  f"launches {[r[impl]['launches'] for r in ranks]}; "
                  f"{wall:.2f} s for the gangs of {len(GANG_LAYOUTS)} "
                  f"layouts with their one spawn on {card}")
            if not (same and ok and reward_ok and k1_ok):
                failed.append(f"{name}=2 {impl}: state ok {ok}, reward ok "
                              f"{reward_ok}, ranks equal {same}, K1 ok "
                              f"{k1_ok}")
    if failed:
        raise RuntimeError(f"dopri5 gangs: {'; '.join(failed)}")
    return launches


class IndexQueue:
    """Each replay's indices taken in order from one fixed list, however
    they are grouped into draws (a stand-in for ``sample_indices`` that
    gives the default path and the fused gather the same index draws)."""

    def __init__(self, dev):
        self.idx = torch.randint(0, 1 << 30, (1 << 16,), device=dev,
                                 generator=torch.Generator(dev).manual_seed(
                                     SEED + 7))
        self.at = {}

    def __call__(self, replay, gen, n):
        at = self.at.get(id(replay), 0)
        self.at[id(replay)] = at + n
        return self.idx[at:at + n] % max(replay.size, 1)


def lever_checks(cfg, rl, node, dev, card):
    """On the card: the stacked state's update against the plain one's,
    the fused gather's batches against the default path's given the same
    index draws, and the decoupled agent's TD losses against the default
    agent's (one update block each, from identical fresh states)."""
    B = cfg.sac.batch_size

    def fresh():
        return create_train_state(cfg, torch.Generator(dev).manual_seed(
            SEED + 6), dev)

    gen = torch.Generator(dev).manual_seed(SEED + 8)
    batch = sample(rl, gen, B)
    node_batch = sample(node, gen, cfg.node.max_batch)
    noise = {k: torch.randn(B, cfg.action_dim, device=dev, generator=gen)
             for k in ("next", "pi", "backup")}

    def one_update(ts, agent):
        return agent.update_core(ts, batch, lambda: node_batch, None, 0,
                                 noise=noise)

    agent = make_agent(cfg, dev)
    ts_p, m_p = one_update(fresh(), agent)
    ts_s, m_s = one_update(experimental.stack_twin_q_state(cfg, fresh()),
                           agent)
    worst = 0.0
    for k, v in m_p.items():
        a, b = float(m_s[k]), float(v)
        worst = max(worst, abs(a - b) / (UPDATE_ATOL + UPDATE_RTOL * abs(b)))
    for a, b in zip(tree_leaves(twin_q_unstack(ts_s.critic)),
                    tree_leaves(ts_p.critic)):
        err = (a - b).abs() / (UPDATE_ATOL + UPDATE_RTOL * b.abs())
        worst = max(worst, float(err.detach().max()))
    if worst > 1:
        raise RuntimeError(f"levers: the stacked update is off the plain "
                           f"one by {worst:.3f} of the tolerance")
    _, m_d = one_update(fresh(), experimental.make_decoupled_agent(cfg, dev))
    td = ("qf1_loss", "qf2_loss", "lf_loss", "node_loss")
    td_equal = all(float(m_d[k]) == float(m_p[k]) for k in td)

    seen = {}
    unpack, draw = replay_buffer.unpack_rows, replay_buffer.sample_indices
    try:
        for fused in (False, True):
            rows = seen.setdefault(fused, [])

            def recorded(layout, r):
                rows.append(r.clone())
                return unpack(layout, r)

            replay_buffer.unpack_rows = recorded
            replay_buffer.sample_indices = IndexQueue(dev)
            g = torch.Generator(dev).manual_seed(SEED + 9)
            carry = UpdateCarry(fresh(), rl, node, {})
            if fused:
                experimental.fused_gather_update_step(cfg)(agent, carry, g, 0)
            else:
                ts = carry.ts
                for _ in range(cfg.sac.updates_per_step):
                    ts, _ = agent.update(ts, rl, node, g, 0)
    finally:
        replay_buffer.unpack_rows, replay_buffer.sample_indices = unpack, draw
    fused_equal = len(seen[True]) == len(seen[False]) > 0 and all(
        torch.equal(a, b) for a, b in zip(seen[True], seen[False]))
    phase(f"levers on the card: the stacked update vs the plain one, "
          f"metrics and critic within rtol {UPDATE_RTOL} atol {UPDATE_ATOL} "
          f"(worst at {worst:.3f} of it); the fused gather's "
          f"{len(seen[True])} batches equal to the default path's given "
          f"the same index draws: {fused_equal}; the decoupled agent's TD "
          f"and fit losses equal to the default's: {td_equal} on {card}")
    if not (fused_equal and td_equal):
        raise RuntimeError(f"levers: fused batches equal {fused_equal}, "
                           f"decoupled TD losses equal {td_equal}")


def levers_ab(dev, card, run):
    """The default update block against the stacked, decoupled and
    fused-gather ones, interleaved in one call: each path from the main
    path's final state (restored from its checkpoint, on its own copy),
    LEVER_BLOCKS blocks each in turns, each block timed alone between two
    synchronizes, with K1's launches counted (the count set to 0 just
    before each block and read just after)."""
    argv = ["--max_episodes", str(EPISODES), "--max_episode_steps",
            str(EPISODE_STEPS)]
    paths = {}
    for name in LEVERS:
        cfg, ts, rl, node, _, episode = restored("unicycle", argv, run, dev)
        if name == "stacked":
            ts = experimental.stack_twin_q_state(cfg, ts)
        agent = (experimental.make_decoupled_agent(cfg, dev)
                 if name == "decoupled" else make_agent(cfg, dev))
        paths[name] = {"ts": ts, "rl": rl, "node": node, "agent": agent,
                       "gen": torch.Generator(dev).manual_seed(SEED + 5),
                       "ms": [], "launches": 0}
    lever_checks(cfg, paths["default"]["rl"], paths["default"]["node"], dev,
                 card)
    fused = experimental.fused_gather_update_step(cfg)
    i_episode = episode + 1

    def block(name, p):
        if name == "fused":
            p["ts"], _ = fused(p["agent"], UpdateCarry(
                p["ts"], p["rl"], p["node"], {}), p["gen"], i_episode)
        else:
            for _ in range(cfg.sac.updates_per_step):
                p["ts"], _ = p["agent"].update(p["ts"], p["rl"], p["node"],
                                               p["gen"], i_episode)

    for name, p in paths.items():  # one untimed block each
        block(name, p)
    for i in range(LEVER_BLOCKS):
        for name in LEVERS[i % 4:] + LEVERS[:i % 4]:
            p = paths[name]
            torch.cuda.synchronize()
            node_kernel.reset_launch_counts()
            t0 = time.perf_counter()
            block(name, p)
            torch.cuda.synchronize()
            p["ms"].append((time.perf_counter() - t0) * 1e3)
            p["launches"] += node_kernel.launch_counts["node_euler"]
    base = statistics.median(paths["default"]["ms"])
    out = {}
    for name, p in paths.items():
        med = statistics.median(p["ms"])
        q1, _, q3 = statistics.quantiles(p["ms"], n=4)
        out[name] = {"ms": med, "ratio": med / base, "q1": q1, "q3": q3,
                     "launches": p["launches"]}
        phase(f"levers: {name}: {med:.3f} ms per update block (median of "
              f"{LEVER_BLOCKS} blocks of {cfg.sac.updates_per_step} "
              f"updates, quartiles {q1:.3f} / {q3:.3f}), {med / base:.4f} "
              f"times the default; {p['launches']} K1 launches on {card}")
        if p["launches"] <= 0:
            raise RuntimeError(f"levers: {name} launched no K1")
    return out


def bf16_update(rl, node, dev, card):
    """One full-width unicycle update with the NODE in bf16 on the card
    (the plain bf16 field; K1 computes float32 only) against the CPU."""
    cfg = get_config("unicycle")
    cfg = dataclasses.replace(cfg, node=dataclasses.replace(
        cfg.node, compute_dtype="bfloat16"))
    launches = update_on_card_vs_cpu(cfg, rl, node, dev, rtol=BF16_RTOL,
                                     atol=BF16_ATOL)
    if launches:
        raise RuntimeError(f"bf16 update: {launches} K1 launches")
    return launches


def startup_child(t_spawn: float) -> None:
    """``--startup T``: a fresh process's way to its first update's end,
    T being the parent's clock at the spawn. Prints one JSON line: the
    seconds to the end of the imports, of the set-up (the CUDA context,
    the state and replays), of ``cached_episode_runner`` (K1's library
    built or loaded) and of the first episode, whose last step is the
    first update block."""
    t_imported = time.time()
    dev = torch.device("cuda")
    cfg = get_config("unicycle")
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, max_episode_steps=STARTUP_STEPS))
    gen = torch.Generator(dev).manual_seed(SEED)
    ts = create_train_state(cfg, gen, dev)
    rl, node = create_replays(cfg, dev)
    torch.cuda.synchronize()
    t_setup = time.time()
    built = any(node_kernel._BUILD_DIR.glob("libnode_euler-*.so"))
    run = cached_episode_runner(cfg, (ts, rl, node, gen, 0, 0))
    t_loaded = time.time()
    node_kernel.reset_launch_counts()
    ts, rl, node, m, _ = run(ts, rl, node, gen, 0, 0)
    host = episode_to_host(m)
    t_end = time.time()
    print(json.dumps({
        "import_s": t_imported - t_spawn, "setup_s": t_setup - t_imported,
        "library_s": t_loaded - t_setup, "episode_s": t_end - t_loaded,
        "total_s": t_end - t_spawn, "library_was_built": built,
        "updates": m.updates_done, "steps": host["steps"],
        "launches": node_kernel.launch_counts["node_euler"]}), flush=True)


def startup_runs(card):
    """Process start to the first update's end, in a fresh process, on a
    copy of the package under OUT/startup: first with its ``_build/``
    empty (and no byte-compiled modules), then again with both warm."""
    root = OUT / "startup"
    shutil.rmtree(root, ignore_errors=True)
    pkg = Path(node_kernel.__file__).resolve().parent.parent
    shutil.copytree(pkg, root / pkg.name, ignore=shutil.ignore_patterns(
        "_build", "__pycache__"))
    shutil.copy2(Path(__file__).resolve(), root / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = {}
    for label in ("cold", "warm"):
        t_spawn = time.time()
        res = subprocess.run(
            [sys.executable, "chip_smoke.py", "--startup", repr(t_spawn)],
            cwd=root, env=env, capture_output=True, text=True, timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"start-up ({label}) failed:\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-4000:]}")
        r = json.loads(res.stdout.strip().splitlines()[-1])
        if r["library_was_built"] != (label == "warm") or r["updates"] <= 0 \
                or r["launches"] <= 0:
            raise RuntimeError(f"start-up ({label}): {r}")
        out[label] = r
        phase(f"start-up ({label}: _build/ "
              f"{'holding K1' if label == 'warm' else 'empty'}): "
              f"{r['total_s']:.2f} s from the spawn to the first update's "
              f"end: import {r['import_s']:.2f} s, set-up "
              f"{r['setup_s']:.2f} s, K1's library "
              f"{'loaded' if label == 'warm' else 'built and loaded'} "
              f"{r['library_s']:.2f} s, first episode ({r['steps']} steps, "
              f"{r['updates']} updates, {r['launches']} K1 launches) "
              f"{r['episode_s']:.2f} s on {card}")
    shutil.rmtree(root, ignore_errors=True)
    return out


def stacked_node_params(n_seeds, gen, dev, dims=(3, 2)):
    """``n_seeds`` NODE parameter sets of ``dims`` (n_s, n_u; non-zero
    biases) stacked on a leading seed axis, as a lockstep state holds
    them."""
    sets = [node_params(*dims, gen, dev) for _ in range(n_seeds)]
    return tree_map(lambda *ps: torch.stack([p.detach() for p in ps]
                                            ).requires_grad_(True), *sets)


def lockstep_kernel(dev, gen, card):
    """K1 seed-batched at LOCKSTEP_KERNEL (unicycle dimensions): one launch
    against its seed-batched plain version and against one launch per
    seed, forward and gradients (u and every parameter); then the device
    ms of the launch (both tile configurations), of the launches one per
    seed and of the plain version, beside the bound (the seeds' work at
    the tensor cores' rate). Returns the numbers by "seeds x rows"."""
    out = {}
    for n_seeds, rows in LOCKSTEP_KERNEL:
        params = stacked_node_params(n_seeds, gen, dev)
        x = torch.randn(n_seeds, rows, 3, device=dev, generator=gen)
        u = (torch.rand(n_seeds, rows, 2, device=dev, generator=gen) * 2
             - 1) * 3.5
        u.requires_grad_(True)
        cot = torch.randn(n_seeds, rows, 3, device=dev, generator=gen)
        ones = [tree_map(lambda p: p[i], params) for i in range(n_seeds)]
        before = node_kernel.launch_counts["node_euler"]
        y_k = node_kernel.node_euler_step(params, x, u, 0.02)
        if node_kernel.launch_counts["node_euler"] != before + 1:
            raise RuntimeError("the seed-batched call took more than one "
                               "launch")
        y_p = node_kernel.node_euler_step_plain(params, x, u, 0.02)
        y_s = torch.stack([node_kernel.node_euler_step(ones[i], x[i], u[i],
                                                       0.02)
                           for i in range(n_seeds)])
        torch.cuda.synchronize()
        inputs = [u] + tree_leaves(params)
        errs = {}
        for name, y in (("plain", y_p), ("per seed", y_s)):
            torch.testing.assert_close(y_k, y, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
            g_k = torch.autograd.grad((y_k * cot).sum(), inputs,
                                      retain_graph=True)
            g = torch.autograd.grad((y * cot).sum(), inputs)
            for a, b in zip(g_k, g):
                torch.testing.assert_close(a, b, rtol=KERNEL_RTOL,
                                           atol=KERNEL_ATOL)
            errs[name] = ((y_k - y).abs().max().item(),
                          max((a - b).abs().max().item()
                              for a, b in zip(g_k, g)))
        xs, us = list(x.unbind()), [t.detach() for t in u.unbind()]
        with torch.no_grad():
            ms, call_ms = time_ms(lambda: node_kernel.node_euler_step(
                params, x, u, 0.02))
            single_ms, single_call_ms = time_ms(lambda: [
                node_kernel.node_euler_step(ones[i], xs[i], us[i], 0.02)
                for i in range(n_seeds)])
            plain_ms, _ = time_ms(lambda: node_kernel.node_euler_step_plain(
                params, x, u, 0.02))
            args = node_kernel.launch_args(params, x, u)
            tiles = {}
            for cfg_i, tile in enumerate(node_kernel.TILE_CONFIGS):
                tiles[str(tile)], _ = time_ms(lambda: node_kernel._launch(
                    args, x, u.detach(), 0.02, cfg_i))
        flops, nbytes = work(ones[0], rows, 3, 2)
        bound_ms, bound_by = bound(flops * n_seeds, nbytes * n_seeds)
        picked = node_kernel.TILE_CONFIGS[node_kernel.tile_config(
            n_seeds * rows)]
        out[f"{n_seeds}x{rows}"] = {
            "ms": ms, "call_ms": call_ms, "single_launches_ms": single_ms,
            "single_launches_call_ms": single_call_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "tiles_ms": tiles,
            "picked": str(picked),
            "max_abs_err": max(e[0] for e in errs.values())}
        phase(f"lockstep K1 {n_seeds} seeds x {rows} rows: one launch "
              f"against the plain version: forward max abs err "
              f"{errs['plain'][0]:.3e}, gradients {errs['plain'][1]:.3e}; "
              f"against {n_seeds} single launches: "
              f"{errs['per seed'][0]:.3e}, {errs['per seed'][1]:.3e} "
              f"(rtol {KERNEL_RTOL} atol {KERNEL_ATOL}) ok; device "
              f"{ms:.4f} ms (tiles: " + ", ".join(
                  f"{k} {v:.4f}" for k, v in tiles.items())
              + f"; the wrapper picks {picked}) against {single_ms:.4f} ms "
              f"for {n_seeds} single launches ({single_ms / ms:.2f} "
              f"times), plain {plain_ms:.4f} ms; issued from Python "
              f"{call_ms:.4f} / {single_call_ms:.4f} ms; bound "
              f"{bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.1%} of it, "
              f"on {card}")
    return out


def lockstep_cfg():
    """Phase 16's config: the unicycle preset at full width, EPISODES x
    EPISODE_STEPS, the policy acting from the second episode."""
    argv = ["--preset", "unicycle", "--quiet", "--seed", str(SEED),
            "--max_episodes", str(EPISODES), "--max_episode_steps",
            str(EPISODE_STEPS), "--start_steps", str(EPISODE_STEPS)]
    return cli.config_from_args(cli.build_parser().parse_args(argv))


def lockstep_episodes(run_fn, state, episode_seconds=None):
    """EPISODES episodes of ``run_fn`` from ``state`` (K1's counts set to
    0 just before, read just after): the new state, each episode's
    per-seed host metrics, the seconds of the run_fn calls, the launches
    and the launches by rows; each episode's seconds are appended to
    ``episode_seconds`` where given."""
    ts, rl, node, gens, total = state
    node_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = t_ep = time.perf_counter()
    episodes = []
    for ep in range(EPISODES):
        ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, ep, total)
        episodes.append(parallel.episode_to_host_seeds(m))
        if episode_seconds is not None:
            now = time.perf_counter()
            episode_seconds.append(now - t_ep)
            t_ep = now
    seconds = time.perf_counter() - t0
    return ((ts, rl, node, gens, total), episodes, seconds,
            node_kernel.launch_counts["node_euler"],
            dict(node_kernel.launches_by_rows))


def lockstep_launches(n_seeds, episodes, launches, by_rows, label):
    """Check K1's launches of a lockstep run: two at n_seeds x 128 rows a
    lockstep update (the primary and backup rollouts of every seed), one
    n_seeds x 32768 fit whenever a seed fits. Returns (updates, fits)."""
    # a lockstep update serves every seed that updates at that step: the
    # seed with the most updates in an episode took part in each of them
    calls = sum(max(r["updates_done"] for r in ep) for ep in episodes)
    fits = by_rows.get(n_seeds * 32768, 0)
    rows_ok = set(by_rows) <= {n_seeds * 128, n_seeds * 32768}
    if (not rows_ok or by_rows.get(n_seeds * 128, 0) != 2 * calls
            or not 1 <= fits <= calls
            or launches != 2 * calls + fits):
        raise RuntimeError(f"{label}: {launches} K1 launches by rows "
                           f"{by_rows} for {calls} lockstep updates")
    return calls, fits


def lockstep_update_check(cfg, dev, state):
    """One lockstep update of the SEEDS seeds of ``state`` (as the runner
    trained them), set to LOCKSTEP_COUNTERS with LOCKSTEP_UPDATE_ON
    updating, against each updating seed's one-seed update on the same
    device from the same batches (sampled from each seed's rings) and
    draws: every metric, parameter, target, Adam moment and multiplier
    within UPDATE_RTOL/UPDATE_ATOL, each seed's short integrations equal
    to its one-seed update's; a seed that sits out keeps its whole state
    bit for bit. Then two noise floors on the seed with the largest gap:
    its one-seed update from the same state with every NODE weight, then
    every network weight (targets included), one ulp up, against its
    one-seed update, as a share of the same tolerance. Under dopri5 the
    NODE's parameters and Adam moments (the fit's gradient through the
    adaptive solve) are held apart, as a fraction of each leaf's largest
    entry, within the larger of DOPRI5_GANG_NODE_FRAC and NOISE_FACTOR
    times the same fraction of the one-ulp NODE floor on the seed with the
    largest such gap. Returns ((the largest gap as a share of its
    tolerance, where), {the floor's name: (its share, where)}, the seeds
    that fit, {"shorts": each seed's short integrations, lockstep and one
    seed, "node": (the NODE's largest fraction, where, its limit, the
    floor's fraction, where) under dopri5, else None})."""
    from nlbac_tpu_torch.agent.state import (
        PARAM_FIELDS,
        stack_states,
        unstack_state,
    )
    from nlbac_tpu_torch.agent.update import METRIC_NAMES

    ts, rl, node, _, _ = state

    def seed_state(i):
        one = unstack_state(cfg, ts, i)  # copies
        one.updates = LOCKSTEP_COUNTERS[i]
        return one

    ones = [seed_state(i) for i in range(SEEDS)]
    stacked = stack_states(cfg, ones)  # copies
    on = list(LOCKSTEP_UPDATE_ON)
    draws = [torch.Generator(dev).manual_seed(SEED + 100 + i)
             for i in range(SEEDS)]
    every = [True] * SEEDS
    batch = replay_buffer.sample_seeds(rl, draws, cfg.sac.batch_size, every)
    node_batch = replay_buffer.sample_seeds(node, draws, cfg.node.max_batch,
                                            every)
    noise = {k: torch.randn(batch["action"].shape, device=dev,
                            generator=draws[0])
             for k in ("next", "pi", "backup")}
    # a resample draw per chain step, the seeds stacked inside each
    n_resample = RESAMPLES[cfg.constraint.kind]
    if n_resample:
        noise.update({k: torch.randn((n_resample,) + batch["action"].shape,
                                     device=dev, generator=draws[0])
                      for k in ("resample", "backup_resample")})

    def seed_noise(i):
        return {k: v[:, i] if k in ("resample", "backup_resample") else v[i]
                for k, v in noise.items()}

    agent = make_agent(cfg, dev)
    fits = []
    stacked, m = agent.update_core(
        stacked, batch, lambda fit: fits.append(fit) or node_batch, None,
        EPISODES, noise=noise, seeds=on)
    want_updates = [n + int(o) for n, o in zip(LOCKSTEP_COUNTERS, on)]
    if stacked.updates != want_updates:
        raise RuntimeError(f"lockstep update: counters {stacked.updates}, "
                           f"expected {want_updates}")

    def one_seed_update(one, i):
        return agent.update_core(
            one, {k: v[i] for k, v in batch.items()},
            lambda: {k: v[i] for k, v in node_batch.items()}, None,
            EPISODES, noise=seed_noise(i))

    def bit_equal(a, b):
        if isinstance(a, (list, tuple)):
            return len(a) == len(b) and all(map(bit_equal, a, b))
        return np.array_equal(a, b)

    def named_leaves(arrays):
        """(name, array) of every leaf of ``parallel.state_arrays``' dict
        but the update count, each Adam moment on its own."""
        for key, vals in arrays.items():
            if key == "updates":
                continue
            for j, v in enumerate(vals):
                moments = zip(("exp_avg", "exp_avg_sq"), v) \
                    if isinstance(v, tuple) else [("", v)]
                for name, a in moments:
                    yield (f"{key}[{j}]{'.' if name else ''}{name} "
                           f"{tuple(np.shape(a))}", a)

    dopri5 = cfg.node.solver == "dopri5"

    def gaps(got_state, got_m, want_state, want_m, label):
        """(the largest gap, leaf or metric, as a share of the tolerance;
        under dopri5 the NODE leaves' largest gap as a fraction of the
        leaf's largest entry), each with where it is."""
        worst, node = (0.0, None), (0.0, "no gap")
        got, want = map(parallel.state_arrays, (got_state, want_state))
        pairs = [(name, a, b) for (name, a), (_, b) in
                 zip(named_leaves(got), named_leaves(want))]
        pairs += [(k, got_m[k].item(), want_m[k].item())
                  for k in METRIC_NAMES]
        for name, a, b in pairs:
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            if not np.all(np.isfinite(a)):
                raise RuntimeError(f"lockstep update: {label} {name} is "
                                   f"not finite")
            if dopri5 and name.startswith(("node[", "adam/node[")):
                scale = float(np.max(np.abs(b), initial=0.0))
                diff = float(np.max(np.abs(a - b), initial=0.0))
                node = max(node, (diff / scale if scale else diff,
                                  f"{label} {name}"), key=lambda w: w[0])
                continue
            share = float(np.max(np.abs(a - b) / (UPDATE_ATOL + UPDATE_RTOL
                                                  * np.abs(b)), initial=0.0))
            worst = max(worst, (share, f"{label} {name}"),
                        key=lambda w: w[0])
        return worst, node

    shorts = m["short_integrations"].tolist()
    one_shorts = [0] * SEEDS
    worst, worst_seed, results = (0.0, None), None, {}
    node_worst, node_seed = (0.0, "no gap"), None
    for i in range(SEEDS):
        got_state = unstack_state(cfg, stacked, i)
        if not on[i]:
            got = parallel.state_arrays(got_state)
            want = parallel.state_arrays(ones[i])
            for key in want:
                if not bit_equal(got[key], want[key]):
                    raise RuntimeError(f"lockstep update: seed {i} sat out"
                                       f" but its {key} changed")
            if shorts[i]:
                raise RuntimeError(f"lockstep update: seed {i} sat out but "
                                   f"counts {shorts[i]} short integrations")
            continue
        one, m1 = one_seed_update(ones[i], i)
        results[i] = (one, m1)
        if one.updates != got_state.updates:
            raise RuntimeError(f"lockstep update: seed {i} at "
                               f"{got_state.updates} updates, one seed's at "
                               f"{one.updates}")
        one_shorts[i] = int(m1["short_integrations"])
        if shorts[i] != one_shorts[i]:
            raise RuntimeError(f"lockstep update: seed {i} counts "
                               f"{shorts[i]} short integrations, its "
                               f"one-seed update {one_shorts[i]}")
        gap, node_gap = gaps(got_state, {k: v[i] for k, v in m.items()},
                             one, m1, f"seed {i}")
        if gap[0] > 1:
            raise RuntimeError(f"lockstep update: {gap[1]} off by "
                               f"{gap[0]:.3f} of its tolerance")
        if worst_seed is None or gap[0] > worst[0]:
            worst, worst_seed = gap, i
        if node_seed is None or node_gap[0] > node_worst[0]:
            node_worst, node_seed = node_gap, i

    # the noise floors: one ulp of some weights in the one-seed update
    floors = {}
    for name, fields in (("node", ("node",)), ("every weight",
                                               PARAM_FIELDS)):
        nudged = seed_state(worst_seed)
        with torch.no_grad():
            for p in tree_leaves([getattr(nudged, f) for f in fields]):
                if isinstance(p, torch.Tensor):
                    p.copy_(torch.nextafter(p, torch.full_like(p,
                                                               math.inf)))
        floors[name] = gaps(*one_seed_update(nudged, worst_seed),
                            *results[worst_seed],
                            f"seed {worst_seed} {name} one ulp")[0]
    node = None
    if dopri5:
        # the NODE's floor on the seed with its largest gap (one that fits)
        nudged = seed_state(node_seed)
        with torch.no_grad():
            for p in tree_leaves(nudged.node):
                p.copy_(torch.nextafter(p, torch.full_like(p, math.inf)))
        floor = gaps(*one_seed_update(nudged, node_seed),
                     *results[node_seed], f"seed {node_seed} node one ulp")[1]
        limit = max(DOPRI5_GANG_NODE_FRAC[cfg.node.adaptive_impl],
                    NOISE_FACTOR * floor[0])
        node = (node_worst[0], node_worst[1], limit, floor[0], floor[1])
        if node_worst[0] > limit:
            raise RuntimeError(f"lockstep update: {node_worst[1]} off by "
                               f"{node_worst[0]:.3e} of the leaf's largest "
                               f"entry (limit {limit:.3e})")
    return worst, floors, fits, {"shorts": shorts, "one_seed_shorts":
                                 one_shorts, "node": node}


def floors_text(floors):
    """``lockstep_update_check``'s floors for a phase line."""
    return "; ".join(f"the one-ulp {name} floor {share:.4f}, {where}"
                     for name, (share, where) in floors.items())


def lockstep_runs(dev, card, one_seed, seeds_info):
    """The lockstep seed runner at full width: SEEDS seeds against phase
    16's, LOCKSTEP_BIG seeds (SEEDS seeds and their one-ulp twins) for
    the noise floor and the rate; ms per lockstep update; a profiled
    window. Returns (its numbers, K1's launches by path)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nlbac_tpu_torch.agent.state import stack_states, unstack_state
    from nlbac_tpu_torch.replay import stack_replays

    cfg = lockstep_cfg()
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, SEEDS, dev)
    t0 = time.perf_counter()
    state = init_fn(SEED)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    ep_secs4, ep_secs8 = [], []
    state, eps4, secs4, launches4, rows4 = lockstep_episodes(run_fn, state,
                                                             ep_secs4)
    calls4, fits4 = lockstep_launches(SEEDS, eps4, launches4, rows4,
                                      f"lockstep {SEEDS} seeds")
    # the SEEDS seeds as the runner left them, for phase 24's shard 0
    ref = {"episodes": eps4, "launches": launches4,
           "fetched": [parallel.lockstep.seed_on_host(cfg, state, i)
                       for i in range(SEEDS)],
           "states": [unstack_state(cfg, state[0], i)
                      for i in range(SEEDS)]}
    (update_share, update_worst), update_floors, update_fits, _ = \
        lockstep_update_check(cfg, dev, state)
    phase(f"lockstep update: {SEEDS} trained seeds at update counts "
          f"{list(LOCKSTEP_COUNTERS)}, updating {list(LOCKSTEP_UPDATE_ON)} "
          f"(fitting {update_fits[0]}), one lockstep update against each "
          f"seed's one-seed update on the card: every metric, parameter, "
          f"target, Adam moment and multiplier within rtol {UPDATE_RTOL} "
          f"atol {UPDATE_ATOL} (worst at {update_share:.4f} of it, "
          f"{update_worst}; {floors_text(update_floors)}), the seed that "
          f"sat out bit for bit, ok on {card}")

    # the noise floor: seeds SEED..SEED+3 and their twins, every weight
    # one ulp up, each twin drawing from its seed's generator
    twins = LOCKSTEP_BIG - SEEDS
    gens8, states8 = [], []
    for i in range(LOCKSTEP_BIG):
        gen = torch.Generator(dev).manual_seed(SEED + i % SEEDS)
        ts = create_train_state(cfg, gen, dev)
        if i >= SEEDS:
            with torch.no_grad():
                for name in ("policy", "backup_policy", "critic",
                             "critic_target", "lyap", "lyap_target",
                             "barrier", "barrier_target", "node"):
                    for p in tree_leaves(getattr(ts, name)):
                        p.copy_(torch.nextafter(
                            p, torch.full_like(p, math.inf)))
        gens8.append(gen)
        states8.append(ts)
    rings = [create_replays(cfg, dev) for _ in range(LOCKSTEP_BIG)]
    state8 = (stack_states(cfg, states8),
              stack_replays([r[0] for r in rings]),
              stack_replays([r[1] for r in rings]), gens8,
              [0] * LOCKSTEP_BIG)
    del states8, rings
    _, run8 = parallel.make_seed_parallel_runner(cfg, LOCKSTEP_BIG, dev)
    state8, eps8, secs8, launches8, rows8 = lockstep_episodes(run8, state8,
                                                              ep_secs8)
    calls8, fits8 = lockstep_launches(LOCKSTEP_BIG, eps8, launches8, rows8,
                                      f"lockstep {LOCKSTEP_BIG} seeds")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    ref.update(big_episodes=eps8, episode_seconds=[ep_secs4, ep_secs8])
    later = [(ep, k) for ep in range(EPISODES)
             for k in (("reward", "node_loss") if ep else ("node_loss",))]

    def value(host, k):
        return host["reward"] if k == "reward" else host["train"][k]

    floors = {f"episode {ep} {k}": max(
        rel(value(eps8[ep][i + SEEDS], k), value(eps8[ep][i], k))
        for i in range(twins)) for ep, k in later}
    limits = {key: max(LOCKSTEP_LATER_RTOL, NOISE_FACTOR * v)
              for key, v in floors.items()}
    failed = []
    for i in range(SEEDS):
        rows = progress_rows(seeds_info["out"] / f"s{SEED + i}")
        first = rel(eps4[0][i]["reward"], rows[0]["reward_train"])
        gaps = {f"episode {ep} {k}": rel(
            value(eps4[ep][i], k),
            rows[ep]["reward_train" if k == "reward" else k])
            for ep, k in later}
        steps = [ep[i]["steps"] for ep in eps4]
        phase(f"lockstep: seed {SEED + i}: steps {steps} (phase 16: "
              f"{[int(r['episode_steps']) for r in rows]}), updates "
              f"{state[0].updates[i]} (phase 16: {int(rows[-1]['updates'])})"
              f", rewards {[round(ep[i]['reward'], 3) for ep in eps4]} "
              f"(phase 16: {[round(r['reward_train'], 3) for r in rows]}); "
              f"first episode's reward relative gap {first:.3e} (limit "
              f"{LOCKSTEP_FIRST_RTOL}); later gaps " + ", ".join(
                  f"{k} {v:.3e} (limit {limits[k]:.3e})"
                  for k, v in gaps.items()))
        bad = [v for v in ep_values(eps4, i) if not math.isfinite(v)]
        if first > LOCKSTEP_FIRST_RTOL or bad or any(
                v > limits[k] for k, v in gaps.items()):
            failed.append(f"seed {SEED + i}: first {first:.3e}, later "
                          f"{gaps}, non-finite {bad}")

    # ms per lockstep update at both widths, the seeds' replays as trained:
    # a window as timed_updates times one seed's, then the same count of
    # updates each synchronized, the fit updates (a seed fits: every seed's
    # fit is computed) and the others apart
    def update_ms(run_state, n_seeds):
        agent = make_agent(cfg, dev)
        ts, rl, node, gens, _ = run_state
        warm, n = UPDATE_TIMING
        on = [True] * n_seeds
        for _ in range(warm):
            agent.update(ts, rl, node, gens, EPISODES, seeds=on)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            agent.update(ts, rl, node, gens, EPISODES, seeds=on)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) / n * 1e3
        fit_ms, rest_ms = [], []
        for _ in range(n):
            fit = any(u % cfg.node.update_interval == 0 for u in ts.updates)
            t1 = time.perf_counter()
            agent.update(ts, rl, node, gens, EPISODES, seeds=on)
            torch.cuda.synchronize()
            (fit_ms if fit else rest_ms).append(
                (time.perf_counter() - t1) * 1e3)
        return ms, float(np.mean(fit_ms)), float(np.mean(rest_ms))

    (ms4, fit4, rest4), (ms8, fit8, rest8) = (
        update_ms(state, SEEDS), update_ms(state8, LOCKSTEP_BIG))

    # a profiled window of LOCKSTEP_PROFILE_STEPS env steps at SEEDS seeds
    short = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, max_episode_steps=LOCKSTEP_PROFILE_STEPS))
    _, run_short = parallel.make_seed_parallel_runner(short, SEEDS, dev)
    ts, rl, node, gens, total = state
    run_short(ts, rl, node, gens, EPISODES, total)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        _, _, _, _, m, _ = run_short(ts, rl, node, gens, EPISODES, total)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    spans = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            spans[e.name] += e.time_range.elapsed_us() / 1e6
    busy = sum(spans.values())
    kern = sum(v for k, v in spans.items() if "node_euler" in k)

    steps4 = sum(ep[i]["steps"] for ep in eps4 for i in range(SEEDS))
    steps8 = sum(ep[i]["steps"] for ep in eps8 for i in range(LOCKSTEP_BIG))
    rate1 = one_seed["steps"] / one_seed["seconds"]
    rate4, rate8 = steps4 / secs4, steps8 / secs8
    phase(f"lockstep: {SEEDS} seeds ({EPISODES} x {EPISODE_STEPS} steps, "
          f"one process): {steps4} env steps in {secs4:.2f} s of run_fn "
          f"calls ({init_s:.2f} s more for init_fn), {rate4:.2f} env-steps/s "
          f"in all; {LOCKSTEP_BIG} seeds: {steps8} in {secs8:.2f} s, "
          f"{rate8:.2f} env-steps/s; against --n_seeds {SEEDS} (phase 16, "
          f"worker processes, start included) {seeds_info['rate']:.2f} and "
          f"one seed (phase 5) {rate1:.2f}: {rate4 / seeds_info['rate']:.3f}"
          f" / {rate8 / seeds_info['rate']:.3f} times phase 16's, "
          f"{rate4 / rate1:.3f} / {rate8 / rate1:.3f} times one seed's; "
          f"{ms4:.2f} / {ms8:.2f} ms per lockstep update ({UPDATE_TIMING[1]} "
          f"updates after {UPDATE_TIMING[0]}, every seed updating, "
          f"{UPDATE_TIMING[1] // 10} NODE fit(s) of {SEEDS} / "
          f"{LOCKSTEP_BIG} x 32768 rows; each synchronized, a fit update "
          f"{fit4:.2f} / {fit8:.2f} ms, the others {rest4:.2f} / "
          f"{rest8:.2f} ms); K1: {launches4} / {launches8} "
          f"launches for {calls4} / {calls8} lockstep updates ({fits4} / "
          f"{fits8} fits); noise floor (a seed against its one-ulp twin) "
          + ", ".join(f"{k} {v:.3e}" for k, v in floors.items())
          + f" on {card}")
    if busy > 0:
        phase(f"lockstep profile: {SEEDS} seeds x {LOCKSTEP_PROFILE_STEPS} "
              f"env steps ({sum(m.updates_done)} seed-updates) in "
              f"{wall:.3f} s under the profiler; device busy {busy:.4f} s "
              f"({busy / wall:.1%} of the window, idle "
              f"{1 - busy / wall:.1%}); node_euler kernel "
              f"{kern * 1e3:.3f} ms on {card}")
    else:
        phase("lockstep profile: the profiler recorded no device time (not "
              "measured)")
    if failed:
        raise RuntimeError(f"lockstep against phase 16: {'; '.join(failed)}")
    numbers = {
        "seeds": SEEDS, "big": LOCKSTEP_BIG, "steps": [steps4, steps8],
        "seconds": [secs4, secs8], "init_seconds": init_s,
        "env_steps_per_s": [rate4, rate8],
        "n_seeds_env_steps_per_s": seeds_info["rate"],
        "one_seed_env_steps_per_s": rate1, "ms_per_update": [ms4, ms8],
        "fit_update_ms": [fit4, fit8], "other_update_ms": [rest4, rest8],
        "updates": [calls4, calls8], "fits": [fits4, fits8],
        "noise_floor": floors, "later_limit": limits,
        "update_check_share": update_share,
        "update_check_worst": update_worst,
        "update_check_floors": update_floors,
        "busy_share": busy / wall if busy > 0 else None}
    ref.update(state=state, numbers=numbers)
    return numbers, {f"unicycle_lockstep_{SEEDS}": launches4,
                     f"unicycle_lockstep_{LOCKSTEP_BIG}": launches8}, ref


def k1_against_plain(run, inputs, cot):
    """``run(step)`` with the kernel and with its plain version: the forward
    and the gradients of ``inputs`` within KERNEL_RTOL/KERNEL_ATOL. Returns
    (forward, gradient) max abs errors."""
    y_k, y_p = run(node_kernel.node_euler_step), run(
        node_kernel.node_euler_step_plain)
    torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    g_k = torch.autograd.grad((y_k * cot).sum(), inputs)
    g_p = torch.autograd.grad((y_p * cot).sum(), inputs)
    for a, b in zip(g_k, g_p):
        torch.testing.assert_close(a, b, rtol=KERNEL_RTOL, atol=KERNEL_ATOL)
    return ((y_k - y_p).abs().max().item(),
            max((a - b).abs().max().item() for a, b in zip(g_k, g_p)))


def lockstep_k1_calls(dev, gen, card):
    """K1 seed-batched where the presets' constraints call it in a lockstep
    update of SEEDS seeds: PVTOL's chain (3 chained calls at SEEDS x 256
    rows (6, 2): the gradients of u_t through all three, of x through one
    and of every parameter) and the learned barrier's one call (SEEDS x 128
    (3, 2), SEEDS x 256 (6, 2): the gradients of u and the parameters),
    against the plain version; each one launch a call. Then the device ms
    of the seed-batched calls against SEEDS single launches a call and the
    plain version, beside the bound. Returns the numbers by call."""
    out = {}
    for name, (n_s, n_u), rows, calls in (
            ("pvtol_chain", (6, 2), PVTOL_ROWS, 3),
            ("barrier_nbc_unicycle", (3, 2), 128, 1),
            ("barrier_nbc_pvtol", (6, 2), PVTOL_ROWS, 1)):
        params = stacked_node_params(SEEDS, gen, dev, (n_s, n_u))
        sets = [tree_map(lambda p: p[i], params) for i in range(SEEDS)]
        x0 = torch.randn(SEEDS, rows, n_s, device=dev, generator=gen)
        u0 = torch.randn(SEEDS, rows, n_u, device=dev, generator=gen,
                         requires_grad=True)
        resampled = [torch.randn(SEEDS, rows, n_u, device=dev,
                                 generator=gen) for _ in range(calls - 1)]
        cot = torch.randn(calls, SEEDS, rows, n_s, device=dev, generator=gen)

        def chain(step, params=params, x=x0, u=u0, draws=resampled):
            ys = []
            for k in range(calls):
                x = step(params, x, u, 0.02)
                ys.append(x)
                if k + 1 < calls:
                    u = draws[k]
            return torch.stack(ys)

        before = node_kernel.launch_counts["node_euler"]
        err, g_err = k1_against_plain(chain, [u0] + tree_leaves(params), cot)
        took = node_kernel.launch_counts["node_euler"] - before
        if took != calls:
            raise RuntimeError(f"{name}: the seed-batched calls took {took}"
                               f" launches, expected {calls}")
        x = x0.clone().requires_grad_(True)
        g_x = k1_against_plain(lambda step: step(params, x, u0, 0.02),
                               [x], cot[0])[1]
        with torch.no_grad():
            ms, _ = time_ms(lambda: chain(node_kernel.node_euler_step))
            plain_ms, _ = time_ms(
                lambda: chain(node_kernel.node_euler_step_plain))
            singles = [(sets[i], x0[i].contiguous(),
                        u0[i].detach().contiguous(),
                        [d[i].contiguous() for d in resampled])
                       for i in range(SEEDS)]
            single_ms, _ = time_ms(lambda: [
                chain(node_kernel.node_euler_step, p, xi, ui, di)
                for p, xi, ui, di in singles])
        flops, nbytes = work(sets[0], rows, n_s, n_u)
        bound_ms, bound_by = bound(flops * SEEDS * calls,
                                   nbytes * SEEDS * calls)
        out[name] = {"seeds": SEEDS, "rows": rows, "dims": [n_s, n_u],
                     "calls": calls, "max_abs_err": err,
                     "grad_max_abs_err": max(g_err, g_x), "ms": ms,
                     "single_launches_ms": single_ms, "plain_ms": plain_ms,
                     "bound_ms": bound_ms, "bound_by": bound_by}
        phase(f"lockstep K1 {name}: {calls} call(s) at {SEEDS} seeds x "
              f"{rows} rows (n_s,n_u)=({n_s},{n_u}), one launch each, "
              f"against the plain version: forward max abs err {err:.3e}, "
              f"gradients (u_t, parameters) {g_err:.3e}, x {g_x:.3e} (rtol "
              f"{KERNEL_RTOL} atol {KERNEL_ATOL}) ok; device {ms:.4f} ms "
              f"against {single_ms:.4f} ms for {SEEDS * calls} single "
              f"launches ({single_ms / ms:.2f} times), plain {plain_ms:.4f} "
              f"ms; bound {bound_ms:.5f} ms ({bound_by}), {bound_ms / ms:.1%}"
              f" of it, on {card}")
    return out


class CountedAgent:
    """The lockstep runner's agent, recording for every update call the
    episode, the seeds' counters and the seeds that update; the calls
    pass through."""

    def __init__(self, agent, calls):
        self.agent, self.calls = agent, calls

    def update(self, ts, rl, node, gens, i_episode, seeds=None):
        self.calls.append((i_episode, list(ts.updates), list(seeds)))
        return self.agent.update(ts, rl, node, gens, i_episode, seeds=seeds)

    def select_action(self, *args, **kwargs):
        return self.agent.select_action(*args, **kwargs)


def counted_runner(cfg, dev, calls):
    """``make_seed_parallel_runner(cfg, SEEDS, dev)`` whose agent records
    each update call in ``calls`` (``CountedAgent``)."""
    real = parallel.lockstep.make_agent
    parallel.lockstep.make_agent = lambda c, d, **kw: CountedAgent(
        real(c, d, **kw), calls)
    try:
        return parallel.make_seed_parallel_runner(cfg, SEEDS, dev)
    finally:
        parallel.lockstep.make_agent = real


def expected_k1(preset, cfg, calls):
    """K1's launches by rows for the lockstep update ``calls`` (episode,
    counters, seeds): K1_CHAIN_CALLS at SEEDS x batch rows an update, the
    backup branch's as many again when an updating seed takes it
    (PVTOL's), and one SEEDS x max_batch fit when an updating seed fits
    (the control-affine NODE's)."""
    if not uses_euler_kernel(cfg.node):
        return {}
    ccfg, ncfg = cfg.constraint, cfg.node
    chain = fits = 0
    for episode, counters, on in calls:
        live = [n for n, o in zip(counters, on) if o]
        chain += K1_CHAIN_CALLS[preset]
        if preset == "pvtol" and any(
                n % ccfg.backup_update_interval == 0 for n in live):
            chain += K1_CHAIN_CALLS[preset]
        limit = ncfg.fit_episode_limit
        if any(n % ncfg.update_interval == 0 for n in live) and (
                limit is None or episode <= limit):
            fits += 1
    return {k: v for k, v in ((SEEDS * cfg.sac.batch_size, chain),
                              (SEEDS * ncfg.max_batch, fits)) if v}


def lockstep_preset_cfg(preset):
    """The preset at full width for phase 22 (LOCKSTEP_PRESETS' note)."""
    steps = LOCKSTEP_PRESETS[preset]
    argv = ["--preset", preset, "--quiet", "--seed", str(SEED),
            "--max_episode_steps", str(steps), "--start_steps",
            str(steps // 2)]
    if preset == "quadrotor":
        argv += QUAD_FLAGS
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    if preset == "pvtol":
        cfg = dataclasses.replace(cfg, supervisor=dataclasses.replace(
            cfg.supervisor, enable_after_episodes=0))
    return cfg


def lockstep_preset_run(preset, dev, card):
    """One preset's lockstep runner at SEEDS seeds and one seed's run of
    the same episodes (LOCKSTEP_PRESETS' note); K1's launches against
    ``expected_k1``; then ``lockstep_update_check`` on the trained seeds.
    Returns (its numbers, its K1 launches)."""
    cfg = lockstep_preset_cfg(preset)
    calls = []
    init_fn, run_fn = counted_runner(cfg, dev, calls)
    ts, rl, node, gens, total = init_fn(SEED)
    episodes = []
    node_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens,
                                              len(episodes), total)
        episodes.append(parallel.episode_to_host_seeds(m))
        if preset != "quadrotor" or min(ts.updates) >= \
                LOCKSTEP_QUAD_UPDATES:
            break
        if len(episodes) == LOCKSTEP_QUAD_EPISODES:
            raise RuntimeError(f"lockstep quadrotor: updates {ts.updates} "
                               f"after {len(episodes)} episodes")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = node_kernel.launch_counts["node_euler"]
    by_rows = dict(node_kernel.launches_by_rows)
    want = expected_k1(preset, cfg, calls)
    if by_rows != want or launches != sum(want.values()):
        raise RuntimeError(f"lockstep {preset}: K1 launches by rows "
                           f"{by_rows}, expected {want} for {len(calls)} "
                           f"lockstep updates")
    steps = [sum(ep[i]["steps"] for ep in episodes) for i in range(SEEDS)]
    bad = [i for i in range(SEEDS) for v in ep_values(episodes, i)
           if not math.isfinite(v)]
    if bad or min(ts.updates) <= 0:
        raise RuntimeError(f"lockstep {preset}: updates {ts.updates}, "
                           f"non-finite metrics of seeds {sorted(set(bad))}")

    # one seed (the lockstep's seed 0) over the same episodes
    gen = torch.Generator(dev).manual_seed(SEED)
    one = create_train_state(cfg, gen, dev)
    rl1, node1 = create_replays(cfg, dev)
    run1 = make_episode_runner(cfg, dev)
    total1, steps1, rewards1 = 0, 0, []
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for ep in range(len(episodes)):
        one, rl1, node1, m1, total1 = run1(one, rl1, node1, gen, ep, total1)
        steps1 += m1.steps
        rewards1.append(m1.reward)
    rewards1 = torch.stack(rewards1).tolist()
    torch.cuda.synchronize()
    seconds1 = time.perf_counter() - t1
    del one, rl1, node1

    (share, where), floors, fits, _ = lockstep_update_check(
        cfg, dev, (ts, rl, node, gens, total))
    rate, rate1 = sum(steps) / seconds, steps1 / seconds1
    rewards = [round(sum(ep[i]["reward"] for ep in episodes), 3)
               for i in range(SEEDS)]
    per_update = {str(k): v / len(calls) for k, v in want.items()}
    phase(f"lockstep {preset}: {SEEDS} seeds x {len(episodes)} episode(s) "
          f"of at most {cfg.env.max_episode_steps} steps (--start_steps "
          f"{cfg.sac.start_steps}): steps {steps}, updates {ts.updates}, "
          f"rewards {rewards} (one seed: {steps1} steps, rewards "
          f"{[round(r, 3) for r in rewards1]}); {len(calls)} lockstep "
          f"updates, K1 {launches} launches by rows {by_rows} (per update "
          f"{per_update}), as expected; {sum(steps)} env steps in "
          f"{seconds:.2f} s, {rate:.2f} env-steps/s, against one seed's "
          f"{rate1:.2f} ({steps1} in {seconds1:.2f} s): {rate / rate1:.3f} "
          f"times; update check at counters {list(LOCKSTEP_COUNTERS)}, "
          f"updating {list(LOCKSTEP_UPDATE_ON)} (fitting "
          f"{fits[0] if fits else None}): "
          f"worst at {share:.4f} of rtol {UPDATE_RTOL} atol {UPDATE_ATOL} "
          f"({where}; {floors_text(floors)}), "
          f"the seed that sat out bit for bit, ok on {card}")
    return {"episodes": len(episodes), "steps": steps,
            "updates": list(ts.updates), "lockstep_updates": len(calls),
            "k1_launches": launches, "k1_by_rows": {str(k): v for k, v in
                                                     by_rows.items()},
            "seconds": seconds, "env_steps_per_s": rate,
            "one_seed_steps": steps1, "one_seed_seconds": seconds1,
            "one_seed_env_steps_per_s": rate1, "ratio": rate / rate1,
            "update_check_share": share, "update_check_worst": where,
            "update_check_floors": floors}, \
        launches


def lockstep_presets(dev, card):
    """Phase 22: every preset but the unicycle in the lockstep runner.
    Returns (the numbers by preset, K1's launches by path)."""
    numbers, by_path = {}, {}
    for preset in LOCKSTEP_PRESETS:
        numbers[preset], by_path[f"{preset}_lockstep_{SEEDS}"] = \
            lockstep_preset_run(preset, dev, card)
    return numbers, by_path


def lockstep_dopri5_solver(dev, gen, card):
    """Phase 23 (a): ``solve_adaptive`` with a seed axis on SEEDS x
    LOCKSTEP_DOPRI5_ROWS rows of the unicycle NODE at full width (seed i's
    weights scaled by LOCKSTEP_DOPRI5_SCALES[i]), in both forms, against
    each seed's one-seed solve on the card: the trials per seed, the
    values, the gradients of the parameters and y0 (through the adjoint
    under ``while``, autograd under ``scan``); the forward's device ms
    against SEEDS one-seed solves. Returns the numbers by form."""
    cfg = get_config("unicycle")
    ncfg, dt = cfg.node, cfg.env.dt
    field = make_field(ncfg)
    params = stacked_node_params(SEEDS, gen, dev)
    scales = torch.tensor(LOCKSTEP_DOPRI5_SCALES, device=dev)
    with torch.no_grad():
        for p in tree_leaves(params):
            p.mul_(scales.view((-1,) + (1,) * (p.dim() - 1)))
    ones = [tree_map(lambda p: p[i].detach(), params) for i in range(SEEDS)]
    rows = LOCKSTEP_DOPRI5_ROWS
    high = torch.tensor(get_env("unicycle").SPEC.action_high, device=dev)
    x = torch.randn(SEEDS, rows, 3, device=dev, generator=gen)
    u = (torch.rand(SEEDS, rows, 2, device=dev, generator=gen) * 2 - 1) * high
    s0 = pack_input(ncfg, x, u)
    # a batch mean's cotangent, as the fit's loss sends it: with randn's
    # the adjoint's backward solve takes hundreds of trials at these scales
    # (g_theta in its error norm), each seconds of the phase's budget
    cot = torch.randn(SEEDS, rows, 5, device=dev, generator=gen) / (rows * 3)
    out = {}
    for impl, max_steps in (("while", 512),
                            ("scan", ncfg.adaptive_scan_steps)):
        kw = dict(impl=impl, max_steps=max_steps)

        def solve(p, y, seeds, trace=None):
            return solve_adaptive(field, p, y, 0.0, dt, seed_axis=seeds,
                                  return_final_t=True, trace=trace, **kw)

        def grads(p, y, c, seeds):
            """(the gradients of the parameters and y0, host ms)."""
            p = tree_map(lambda v: v.detach().requires_grad_(True), p)
            y = y.clone().requires_grad_(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            y1 = (odeint_adjoint(field, p, y, 0.0, dt, method="dopri5",
                                 seed_axis=seeds) if impl == "while"
                  else solve_adaptive(field, p, y, 0.0, dt, seed_axis=seeds,
                                      **kw))
            g = torch.autograd.grad((y1 * c).sum(), tree_leaves(p) + [y])
            torch.cuda.synchronize()
            return g, (time.perf_counter() - t0) * 1e3

        with torch.no_grad():
            trace = []
            y_s, t_s = solve(params, s0, True, trace)
            trials = [sum(int(a[i]) for _, _, a in trace)
                      for i in range(SEEDS)]
        g_s, _ = grads(params, s0, cot, True)  # the first call: warm-up
        errs, fracs, one_trials, one_grads, one_grad_ms = [], [], [], [], 0.0
        for i in range(SEEDS):
            with torch.no_grad():
                tr = []
                y_1, t_1 = solve(ones[i], s0[i], False, tr)
                one_trials.append(sum(int(a) for _, _, a in tr))
            torch.testing.assert_close(y_s[i], y_1, rtol=LOCKSTEP_DOPRI5_RTOL,
                                       atol=LOCKSTEP_DOPRI5_ATOL)
            errs.append((y_s[i] - y_1).abs().max().item())
            if min(float(t_s[i]), float(t_1)) < float(np.float32(dt)):
                raise RuntimeError(f"lockstep dopri5 {impl}: seed {i} "
                                   f"reached t {float(t_s[i])} (one seed "
                                   f"{float(t_1)}) of {dt}")
            g_1, ms_1 = grads(ones[i], s0[i], cot[i], False)
            one_grad_ms += ms_1
            one_grads.append(g_1)
            fracs.append(largest_frac([a[i] for a in g_s], g_1))
        # the float32 noise floor: the worst seed's one-seed gradient with
        # its weights one ulp up, against its one-seed gradient
        w = int(np.argmax(fracs))
        with torch.no_grad():
            nudged = tree_map(lambda p: torch.nextafter(
                p, torch.full_like(p, math.inf)), ones[w])
        floor = largest_frac(grads(nudged, s0[w], cot[w], False)[0],
                             one_grads[w])
        limit = LOCKSTEP_DOPRI5_GRAD_FRAC[impl]
        if trials != one_trials or len(set(trials)) < 2 or \
                max(fracs) > limit:
            raise RuntimeError(f"lockstep dopri5 {impl}: trials {trials} "
                               f"(one seed {one_trials}), gradients off by "
                               f"{fracs} of a leaf's largest entry (limit "
                               f"{limit}; one-ulp floor {floor:.3e})")
        _, grad_ms = grads(params, s0, cot, True)
        with torch.no_grad():
            ms = events_ms(lambda: solve(params, s0, True), calls=3)
            one_ms = events_ms(lambda: [solve(ones[i], s0[i], False)
                                        for i in range(SEEDS)], calls=3)
        out[impl] = {"trials": trials, "max_abs_err": max(errs),
                     "grad_frac": max(fracs), "grad_floor": floor,
                     "ms": ms, "one_seed_ms": one_ms,
                     "grad_ms": grad_ms, "one_seed_grad_ms": one_grad_ms}
        phase(f"lockstep dopri5 solver {impl}: {SEEDS} seeds x {rows} rows "
              f"(width 100, weights scaled {list(LOCKSTEP_DOPRI5_SCALES)}): "
              f"trials per seed {trials}, each its one-seed solve's; values "
              f"within {max(errs):.3e} of the one-seed solves (rtol "
              f"{LOCKSTEP_DOPRI5_RTOL} atol {LOCKSTEP_DOPRI5_ATOL}); the "
              f"{'adjoint' if impl == 'while' else 'autograd'} gradients of "
              f"the parameters and y0 within {max(fracs):.3e} of a leaf's "
              f"largest entry (limit {limit}; seed {w}'s one-ulp floor "
              f"{floor:.3e}); forward {ms:.3f} ms "
              f"against {one_ms:.3f} ms for {SEEDS} one-seed solves "
              f"({one_ms / ms:.2f} times), with the gradient {grad_ms:.1f} "
              f"ms against {one_grad_ms:.1f} ms (host clock, one warm call "
              f"each) on {card}")
    return out


def largest_frac(got, want):
    """The largest gap of ``got``'s leaves from ``want``'s, as a fraction of
    the leaf's largest entry."""
    return max(((a - b).abs().max() / b.abs().max()).item()
               for a, b in zip(got, want))


def lockstep_dopri5_cfg(impl=None, kind=None):
    """Unicycle at full width for one episode of LOCKSTEP_DOPRI5_STEPS
    steps, the policy acting in its second half, under dopri5 with
    ``impl`` (None: Euler) and with the constraint ``kind`` if given."""
    steps = LOCKSTEP_DOPRI5_STEPS
    argv = ["--preset", "unicycle", "--quiet", "--seed", str(SEED),
            "--max_episode_steps", str(steps), "--start_steps",
            str(steps // 2)]
    if impl is not None:
        argv += ["--node_solver", "dopri5", "--node_adaptive_impl", impl]
    cfg = cli.config_from_args(cli.build_parser().parse_args(argv))
    if kind is not None:
        cfg = dataclasses.replace(cfg, constraint=dataclasses.replace(
            cfg.constraint, kind=kind))
    return cfg


def lockstep_episode(cfg, dev, trials):
    """One episode of SEEDS seeds of ``cfg`` in the lockstep runner (K1's
    counts and ``trials`` set to 0 just before, read just after). Returns
    (the state, each seed's host metrics, the update calls, seconds, K1's
    launches and its launches by rows)."""
    calls = []
    init_fn, run_fn = counted_runner(cfg, dev, calls)
    ts, rl, node, gens, total = init_fn(SEED)
    node_kernel.reset_launch_counts()
    trials.n.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ts, rl, node, gens, m, total = run_fn(ts, rl, node, gens, 0, total)
    host = parallel.episode_to_host_seeds(m)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    bad = [i for i in range(SEEDS) for v in ep_values([host], i)
           if not math.isfinite(v)]
    if bad or min(ts.updates) <= 0:
        raise RuntimeError(f"lockstep {cfg.run.exp_name}: updates "
                           f"{ts.updates}, non-finite metrics of seeds "
                           f"{sorted(set(bad))}")
    return ((ts, rl, node, gens, total), host, calls, seconds,
            node_kernel.launch_counts["node_euler"],
            dict(node_kernel.launches_by_rows))


def dopri5_update_times(cfg, dev, state):
    """Host ms of a fit update and LOCKSTEP_DOPRI5_TIMED others of the
    lockstep state (every seed updating) and of its seed 0 alone (on its
    rings), in turns, each between two synchronizes, with the counters set
    so that the gates are those of a fit update and of others. Returns
    {path: (fit ms, the others' mean ms, ms per update over a fit
    cycle)}."""
    from nlbac_tpu_torch.agent.state import unstack_state
    from nlbac_tpu_torch.replay import unstack_replay

    agent = make_agent(cfg, dev)
    ts, rl, node, gens, _ = state
    one = unstack_state(cfg, ts, 0)
    rl1, node1 = unstack_replay(rl, 0), unstack_replay(node, 0)
    gen1 = torch.Generator(dev).manual_seed(SEED + 200)
    on = [True] * SEEDS

    def lockstep(n):
        ts.updates = [n] * SEEDS
        agent.update(ts, rl, node, gens, 1, seeds=on)

    def single(n):
        one.updates = n
        agent.update(one, rl1, node1, gen1, 1)

    interval = cfg.node.update_interval
    plan = [interval * k + 1 for k in range(LOCKSTEP_DOPRI5_TIMED)] + \
        [interval * 100]
    times = {"lockstep": ([], []), "one seed": ([], [])}
    paths = (("lockstep", lockstep), ("one seed", single))
    for turn, n in enumerate(plan):
        for name, fn in (paths if turn % 2 == 0 else paths[::-1]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(n)
            torch.cuda.synchronize()
            times[name][n % interval == 0].append(
                (time.perf_counter() - t0) * 1e3)
    out = {}
    for name, (rest, fit) in times.items():
        other = float(np.mean(rest))
        out[name] = (fit[0], other, (fit[0] + (interval - 1) * other)
                     / interval)
    return out


def lockstep_dopri5_run(impl, dev, card, trials):
    """Phase 23 (b): SEEDS unicycle seeds under dopri5 ``impl`` for one
    episode, then ``lockstep_update_check`` and the update times. Returns
    (its numbers, K1's launches)."""
    cfg = lockstep_dopri5_cfg(impl)
    state, host, calls, seconds, launches, _ = lockstep_episode(cfg, dev,
                                                                trials)
    fits = sum(1 for _, counters, on in calls
               if any(o and n % cfg.node.update_interval == 0
                      for n, o in zip(counters, on)))
    steps = [h["steps"] for h in host]
    shorts = [h["short_integrations"] for h in host]
    if launches or not fits:
        raise RuntimeError(f"lockstep dopri5 {impl}: {launches} K1 "
                           f"launches, {fits} fit updates")
    n_trials = int(trials.n)
    updates = list(state[0].updates)
    (share, where), floors, fit_seeds, extra = lockstep_update_check(
        cfg, dev, state)
    node_frac, node_where, node_limit, node_floor, floor_where = \
        extra["node"]
    times = dopri5_update_times(cfg, dev, state)
    lock, one = times["lockstep"], times["one seed"]
    phase(f"lockstep dopri5 {impl}: {SEEDS} seeds x 1 episode of "
          f"{cfg.env.max_episode_steps} steps: steps {steps}, updates "
          f"{updates} ({len(calls)} lockstep updates, {fits} "
          f"fitting {SEEDS} x {cfg.node.max_batch} rows), {n_trials} trial "
          f"steps over all seeds, short integrations per seed {shorts}, K1 "
          f"0 launches; {sum(steps) / seconds:.2f} env-steps/s in all; "
          f"update check at counters {list(LOCKSTEP_COUNTERS)}, updating "
          f"{list(LOCKSTEP_UPDATE_ON)} (fitting {fit_seeds[0]}): worst at "
          f"{share:.4f} of rtol {UPDATE_RTOL} atol {UPDATE_ATOL} ({where}), "
          f"the NODE's leaves within {node_frac:.3e} of a leaf's largest "
          f"entry ({node_where}; limit {node_limit:.3e}, its one-ulp floor "
          f"{node_floor:.3e} at {floor_where}); {floors_text(floors)}; "
          f"short integrations per seed "
          f"{extra['shorts']} (one seed {extra['one_seed_shorts']}); ms per "
          f"update: lockstep fit {lock[0]:.2f}, others {lock[1]:.2f}, over "
          f"a fit cycle {lock[2]:.2f}; one seed fit {one[0]:.2f}, others "
          f"{one[1]:.2f}, over a fit cycle {one[2]:.2f} "
          f"({lock[2] / one[2]:.3f} times one seed's for {SEEDS} seeds) on "
          f"{card}")
    return {"steps": steps, "updates": updates,
            "lockstep_updates": len(calls), "fits": fits,
            "trial_steps": n_trials, "short_integrations": shorts,
            "seconds": seconds, "update_check_share": share,
            "update_check_worst": where, "update_check_floors": floors,
            "node_frac": node_frac, "node_limit": node_limit,
            "node_floor": node_floor,
            "update_check_shorts": extra["shorts"],
            "one_seed_shorts": extra["one_seed_shorts"],
            "ms_per_update": {k: {"fit": v[0], "other": v[1], "cycle": v[2]}
                              for k, v in times.items()}}, launches


def lockstep_per_seed_builder(dev, card, trials):
    """Phase 23 (c): unicycle's builder registered again without SEED_AXIS,
    one Euler episode of SEEDS seeds: K1's launches against SEEDS a
    rollout call (the primary's, and the backup branch's when an updating
    seed takes it) plus one seed-batched launch a fit; then
    ``lockstep_update_check``. Returns (its numbers, K1's launches)."""
    from nlbac_tpu_torch.constraints import register_builder
    from nlbac_tpu_torch.constraints import unicycle as builder

    kind = "unicycle_per_seed"
    register_builder(kind, types.SimpleNamespace(
        terms=builder.terms, NUM_PRIMARY=builder.NUM_PRIMARY,
        NUM_BACKUP=builder.NUM_BACKUP))
    cfg = lockstep_dopri5_cfg(kind=kind)
    state, host, calls, seconds, launches, by_rows = lockstep_episode(
        cfg, dev, trials)
    ccfg, ncfg = cfg.constraint, cfg.node
    rollouts = fits = 0
    for _, counters, on in calls:
        live = [n for n, o in zip(counters, on) if o]
        rollouts += 1 + int(ccfg.use_backup and any(
            ccfg.backup_update_interval <= 1
            or n % ccfg.backup_update_interval == 0 for n in live))
        fits += int(any(n % ncfg.update_interval == 0 for n in live))
    want = {k: v for k, v in ((cfg.sac.batch_size, SEEDS * rollouts),
                              (SEEDS * ncfg.max_batch, fits)) if v}
    if by_rows != want or launches != sum(want.values()):
        raise RuntimeError(f"lockstep per-seed builder: K1 launches by rows "
                           f"{by_rows}, expected {want} for {len(calls)} "
                           f"lockstep updates")
    (share, where), floors, fit_seeds, _ = lockstep_update_check(cfg, dev,
                                                                 state)
    steps = [h["steps"] for h in host]
    phase(f"lockstep per-seed builder ({kind}, no SEED_AXIS, Euler): "
          f"{SEEDS} seeds x 1 episode of {cfg.env.max_episode_steps} steps: "
          f"steps {steps}, updates {state[0].updates}; K1 {launches} "
          f"launches by rows {by_rows} for {len(calls)} lockstep updates "
          f"({rollouts} rollout calls, {SEEDS} launches each; {fits} "
          f"seed-batched fits), as expected; {sum(steps) / seconds:.2f} "
          f"env-steps/s in all; update check (fitting {fit_seeds[0]}): "
          f"worst at {share:.4f} of rtol {UPDATE_RTOL} atol {UPDATE_ATOL} "
          f"({where}; {floors_text(floors)}), the seed that sat out bit "
          f"for bit, ok on {card}")
    return {"steps": steps, "updates": list(state[0].updates),
            "lockstep_updates": len(calls), "rollout_calls": rollouts,
            "fits": fits, "k1_launches": launches,
            "k1_by_rows": {str(k): v for k, v in by_rows.items()},
            "seconds": seconds, "update_check_share": share,
            "update_check_worst": where,
            "update_check_floors": floors}, launches


def lockstep_dopri5(dev, gen, card):
    """Phase 23: (a) the seed-axis solver, (b) the runner under each
    dopri5 form, (c) a builder without SEED_AXIS. Returns (the numbers,
    K1's launches by path)."""
    trials = TrialCounter(dev)
    numbers = {"solver": lockstep_dopri5_solver(dev, gen, card)}
    by_path = {}
    for impl in DOPRI5_IMPLS:
        numbers[impl], by_path[f"unicycle_lockstep_dopri5_{impl}"] = \
            lockstep_dopri5_run(impl, dev, card, trials)
    numbers["per_seed_builder"], by_path["unicycle_lockstep_per_seed"] = \
        lockstep_per_seed_builder(dev, card, trials)
    return numbers, by_path


def host_leaves(x):
    """The arrays of a seed on the host (``ShardedSeedRunner.fetch``'s
    form), flattened in a fixed order, as float64."""
    if isinstance(x, dict):
        return [a for k in sorted(x) for a in host_leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [a for v in x for a in host_leaves(v)]
    return [np.asarray(x, np.float64)]


def host_gap(a, b) -> float:
    """The largest absolute gap between two seeds on the host (states,
    Adam moments, rings, totals and generator states)."""
    xs, ys = host_leaves(a), host_leaves(b)
    if len(xs) != len(ys) or any(x.shape != y.shape for x, y in
                                 zip(xs, ys)):
        raise RuntimeError("lockstep shards: two seeds' host states differ "
                           "in their shapes")
    return max((float(np.max(np.abs(x - y), initial=0.0))
                for x, y in zip(xs, ys)), default=0.0)


def plain_layout_arrays(one):
    """A one-seed state's parameters, targets, Adam moments and
    multipliers as named arrays, its critic's leaves and their moments in
    the plain twin-Q layout whichever layout it holds."""
    from nlbac_tpu_torch.agent.state import OPT_GROUPS, PARAM_FIELDS
    from nlbac_tpu_torch.tree import tree_unflatten

    def plain(field, tree):
        return twin_q_unstack(tree) if field in ("critic", "critic_target") \
            else tree

    out = {}
    for field in PARAM_FIELDS:
        for j, p in enumerate(tree_leaves(plain(field, getattr(one, field)))):
            out[f"{field}[{j}]"] = p
    for group, field in OPT_GROUPS.items():
        tree, state = getattr(one, field), one.opt[group].state
        for key in ("exp_avg", "exp_avg_sq"):
            moments = tree_unflatten(tree, [
                state[p][key] if p in state else torch.zeros_like(p)
                for p in tree_leaves(tree)])
            for j, t in enumerate(tree_leaves(plain(field, moments))):
                out[f"adam/{group}[{j}].{key}"] = t
    for j, t in enumerate(one.lag):
        out[f"lag[{j}]"] = t
    return {k: v.detach().cpu().numpy().astype(np.float64)
            for k, v in out.items()}


def stacked_twin_q_check(cfg, dev, ones, rl, node):
    """One lockstep update of the SEEDS seeds ``ones`` (one-seed states, as
    phase 21's runner left them) with the critic in the stacked twin-Q
    layout (``experimental.stack_twin_q_state`` of the seed-stacked state)
    against the same update in the plain layout, every seed updating, from
    the same batches and draws, the critic's Adam fresh in both (the
    stacked layout makes it anew): every metric, parameter, target, Adam
    moment and multiplier within UPDATE_RTOL/UPDATE_ATOL. Returns (the
    largest gap as a share of its tolerance, where)."""
    from nlbac_tpu_torch.agent.state import (
        make_optimizer,
        stack_states,
        unstack_state,
    )
    from nlbac_tpu_torch.agent.update import METRIC_NAMES

    plain = stack_states(cfg, [dataclasses.replace(one, opt={
        **one.opt, "critic": make_optimizer(cfg, "critic", one.critic)})
        for one in ones])
    stacked = experimental.stack_twin_q_state(cfg, stack_states(cfg, ones))
    if "q1" in stacked.critic or stacked.critic["w"][0].shape[:2] != (
            SEEDS, 2):
        raise RuntimeError("stacked twin-Q check: the critic is not in the "
                           "stacked layout with a seed axis")
    draws = [torch.Generator(dev).manual_seed(SEED + 200 + i)
             for i in range(SEEDS)]
    every = [True] * SEEDS
    batch = replay_buffer.sample_seeds(rl, draws, cfg.sac.batch_size, every)
    node_batch = replay_buffer.sample_seeds(node, draws, cfg.node.max_batch,
                                            every)
    noise = {k: torch.randn(batch["action"].shape, device=dev,
                            generator=draws[0])
             for k in ("next", "pi", "backup")}
    agent = make_agent(cfg, dev)
    out = {}
    for name, ts in (("plain", plain), ("stacked", stacked)):
        out[name] = agent.update_core(ts, batch, lambda fit: node_batch,
                                      None, EPISODES, noise=noise,
                                      seeds=every)
    (ts_p, m_p), (ts_s, m_s) = out["plain"], out["stacked"]
    if ts_p.updates != ts_s.updates:
        raise RuntimeError(f"stacked twin-Q check: counters {ts_s.updates}"
                           f" against {ts_p.updates}")
    worst = (0.0, "no gap")
    for i in range(SEEDS):
        got = plain_layout_arrays(unstack_state(cfg, ts_s, i))
        want = plain_layout_arrays(unstack_state(cfg, ts_p, i))
        got.update({k: m_s[k][i].item() for k in METRIC_NAMES})
        want.update({k: m_p[k][i].item() for k in METRIC_NAMES})
        for k, b in want.items():
            a, b = np.asarray(got[k], np.float64), np.asarray(b, np.float64)
            if a.shape != b.shape or not np.all(np.isfinite(a)):
                raise RuntimeError(f"stacked twin-Q check: seed {i} {k} is "
                                   f"not finite or not shaped {b.shape}")
            share = float(np.max(np.abs(a - b) / (UPDATE_ATOL + UPDATE_RTOL
                                                  * np.abs(b)), initial=0.0))
            worst = max(worst, (share, f"seed {i} {k}"), key=lambda w: w[0])
    if worst[0] > 1:
        raise RuntimeError(f"stacked twin-Q check: {worst[1]} off by "
                           f"{worst[0]:.3f} of its tolerance")
    return worst


def lockstep_cards(dev, card, ref):
    """Phase 24: LOCKSTEP_SHARDS x SEEDS unicycle seeds at full width in
    the sharded lockstep runner, every shard a worker process on this
    card, at phase 21's depth and base seed: the workers' start-up, each
    shard's K1 launches against the count per lockstep update, shard 0
    (seeds SEED..SEED+3) against phase 21's SEEDS-seed run of the same
    seeds (expected bit for bit: the same code on the same shapes), every
    seed's first episode against phase 21's LOCKSTEP_BIG-seed run where
    that run holds the seed, the aggregate env-steps/s beside phase 21's
    in-process and one-seed rates; then ``stacked_twin_q_check``. Returns
    (its numbers, K1's launches by path)."""
    cfg = lockstep_cfg()
    n_seeds = LOCKSTEP_SHARDS * SEEDS
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    devices = [str(dev)] * LOCKSTEP_SHARDS
    t0 = time.perf_counter()
    init_fn, run_fn = parallel.make_seed_parallel_runner(cfg, n_seeds,
                                                         devices)
    try:
        init_fn(SEED)
        start_s = time.perf_counter() - t0
        t1 = t_ep = time.perf_counter()
        episodes, ep_secs = [], []
        for ep in range(EPISODES):
            metrics, total = run_fn(ep)
            episodes.append(metrics)
            now = time.perf_counter()
            ep_secs.append(now - t_ep)
            t_ep = now
        secs = time.perf_counter() - t1
        fetched = [run_fn.fetch(i) for i in range(SEEDS)]
        worker_s = run_fn.start_seconds
        shards = run_fn.shards
    finally:
        run_fn.close()

    failed = []
    launches, by_path = [], {}
    for d, seeds in enumerate(shards):
        # K1 in the shard's worker: 2 at SEEDS x 128 rows a lockstep
        # update, one SEEDS x 32768 fit whenever a seed of it fits
        n = sum(ep[seeds[0]]["kernel_launches"] for ep in episodes)
        calls = sum(max(ep[i]["updates_done"] for i in seeds)
                    for ep in episodes)
        fits = n - 2 * calls
        launches.append({"launches": n, "updates": calls, "fits": fits})
        by_path[f"unicycle_lockstep_{LOCKSTEP_SHARDS}x{SEEDS}_shard{d}"] = n
        if not 1 <= fits <= calls:
            failed.append(f"shard {d}: {n} K1 launches for {calls} lockstep "
                          f"updates")
    if launches[0]["launches"] != ref["launches"]:
        failed.append(f"shard 0: {launches[0]['launches']} K1 launches, "
                      f"phase 21's {SEEDS} seeds {ref['launches']}")

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    # shard 0 against phase 21's run of the same seeds
    same_steps = all(episodes[ep][i][k] == ref["episodes"][ep][i][k]
                     for ep in range(EPISODES) for i in range(SEEDS)
                     for k in ("steps", "updates_done"))
    episode_gap = max(abs(a - b) for i in range(SEEDS) for a, b in
                      zip(ep_values(episodes, i),
                          ep_values(ref["episodes"], i)))
    state_gap = max(host_gap(fetched[i], ref["fetched"][i])
                    for i in range(SEEDS))
    bitwise = same_steps and episode_gap == 0 and state_gap == 0
    limits = ref["numbers"]["later_limit"]
    if not bitwise:
        # as phase 21 holds its seeds against phase 16's: the first
        # episode closely, the later ones within the float32 noise floor
        for i in range(SEEDS):
            gaps = {f"episode {ep} {k}": rel(
                episodes[ep][i]["reward"] if k == "reward" else
                episodes[ep][i]["train"][k],
                ref["episodes"][ep][i]["reward"] if k == "reward" else
                ref["episodes"][ep][i]["train"][k])
                for ep in range(EPISODES) for k in ("reward", "node_loss")}
            first = gaps.pop("episode 0 reward")
            if first > LOCKSTEP_FIRST_RTOL or any(
                    v > limits[k] for k, v in gaps.items()):
                failed.append(f"shard 0 seed {SEED + i} against phase 21: "
                              f"first {first:.3e}, later {gaps}")
    # every seed's first episode (warm-up actions) against phase 21's
    # LOCKSTEP_BIG-seed run, which holds seeds SEED..SEED+SEEDS-1 (its
    # others are their one-ulp twins, drawing from the same generators)
    firsts = {}
    for i in range(n_seeds):
        got = episodes[0][i]["reward"]
        if i < SEEDS:
            firsts[SEED + i] = rel(got, ref["big_episodes"][0][i]["reward"])
            if firsts[SEED + i] > LOCKSTEP_FIRST_RTOL:
                failed.append(f"seed {SEED + i}'s first episode "
                              f"{firsts[SEED + i]:.3e} off phase 21's")
        bad = [v for v in ep_values(episodes, i) if not math.isfinite(v)]
        if bad:
            failed.append(f"seed {SEED + i}: non-finite {bad}")

    steps = sum(ep[i]["steps"] for ep in episodes for i in range(n_seeds))
    rate = steps / secs
    rate4, rate8 = ref["numbers"]["env_steps_per_s"]
    rate1 = ref["numbers"]["one_seed_env_steps_per_s"]

    def last_rate(eps, ep_seconds):
        """The last episode's env-steps/s (a fresh worker's first episode
        holds its lazy set-up, a warm process's does not)."""
        return sum(s["steps"] for s in eps[-1]) / ep_seconds[-1]

    last = last_rate(episodes, ep_secs)
    last4, last8 = (last_rate(ref[k], t) for k, t in zip(
        ("episodes", "big_episodes"), ref["episode_seconds"]))
    for d, seeds in enumerate(shards):
        phase(f"lockstep shards: shard {d} (seeds {SEED + seeds[0]}.."
              f"{SEED + seeds[-1]}, a worker on {devices[d]}): steps "
              f"{[[ep[i]['steps'] for i in seeds] for ep in episodes]}, "
              f"updates {[episodes[-1][i]['updates'] for i in seeds]}, K1 "
              f"{launches[d]['launches']} launches for "
              f"{launches[d]['updates']} lockstep updates (2 at {SEEDS} x "
              f"128 rows each, {launches[d]['fits']} fits of {SEEDS} x "
              f"32768), rewards "
              f"{[[round(ep[i]['reward'], 3) for i in seeds] for ep in episodes]}"
              f"; worker set-up {worker_s[d]:.2f} s")
    phase(f"lockstep shards: shard 0 against phase 21's {SEEDS} seeds: "
          + ("bit for bit" if bitwise else
             f"largest gap {episode_gap:.3e} in the episodes' metrics, "
             f"{state_gap:.3e} in the states (steps and updates "
             f"{'equal' if same_steps else 'differ'})")
          + f" (episodes, whole states, Adam moments, rings, generators); "
          f"first episodes against phase 21's {LOCKSTEP_BIG} seeds: "
          + ", ".join(f"seed {k} {v:.3e}" for k, v in firsts.items())
          + f" (limit {LOCKSTEP_FIRST_RTOL}; phase 21 holds no seed "
          f"{SEED + SEEDS}..{SEED + n_seeds - 1}: those are held to finite "
          f"values and their shard's launch count)")
    phase(f"lockstep shards: {LOCKSTEP_SHARDS} x {SEEDS} seeds ({EPISODES} "
          f"x {EPISODE_STEPS} steps, {LOCKSTEP_SHARDS} worker processes on "
          f"one card): {steps} env steps in {secs:.2f} s of run_fn calls, "
          f"{rate:.2f} env-steps/s in all, {rate / rate8:.3f} times phase "
          f"21's {LOCKSTEP_BIG} seeds in one process ({rate8:.2f}), "
          f"{rate / rate4:.3f} times its {SEEDS} ({rate4:.2f}), "
          f"{rate / rate1:.3f} times one seed's ({rate1:.2f}); episodes "
          f"{[round(t, 2) for t in ep_secs]} s, the last at {last:.2f} "
          f"env-steps/s, {last / last8:.3f} / {last / last4:.3f} times phase "
          f"21's last at {LOCKSTEP_BIG} / {SEEDS} seeds ({last8:.2f} / "
          f"{last4:.2f}); start-up {start_s:.2f} s from the runner's call "
          f"to every worker ready (the workers' own set-up "
          f"{[round(w, 2) for w in worker_s]} s) on {card}")
    if failed:
        raise RuntimeError(f"lockstep shards: {'; '.join(failed)}")

    share, where = stacked_twin_q_check(cfg, dev, ref["states"],
                                        ref["state"][1], ref["state"][2])
    phase(f"lockstep stacked twin-Q: one lockstep update of {SEEDS} trained "
          f"seeds with the critic stacked (S, 2, in, out) against the plain "
          f"layout: every metric, parameter, target, Adam moment and "
          f"multiplier within rtol {UPDATE_RTOL} atol {UPDATE_ATOL} (worst "
          f"at {share:.4f} of it, {where}) on {card}")
    return {"shards": LOCKSTEP_SHARDS, "seeds": n_seeds, "steps": steps,
            "seconds": secs, "env_steps_per_s": rate,
            "ratio_to_in_process": [rate / rate4, rate / rate8],
            "ratio_to_one_seed": rate / rate1, "episode_seconds": ep_secs,
            "last_episode_env_steps_per_s": last,
            "last_episode_ratio_to_in_process": [last / last4, last / last8],
            "start_seconds": start_s,
            "worker_setup_seconds": worker_s, "launches": launches,
            "shard0_bit_for_bit": bitwise,
            "shard0_gaps": [episode_gap, state_gap],
            "first_episode_gaps": firsts,
            "stacked_twin_q_share": share, "stacked_twin_q_worst": where}, \
        by_path


def band_script(*args):
    return [sys.executable, str(Path(__file__).resolve().parent / "scripts"
                                / "band_torch.py")] + [str(a) for a in args]


def band_runs(card):
    """Phase 25: ``scripts/band_torch.py run`` for BAND_SEEDS seeds in
    chunks of one episode, beside seed SEED uncut in one chunk (the two
    runs side by side on the card); seed SEED's rows and final checkpoint
    must be bit for bit the uncut run's; then ``judge`` on the chunked
    seeds (printed, not a gate)."""
    shutil.rmtree(BAND, ignore_errors=True)
    common = ["--episodes", BAND_EPISODES, "--per_card", BAND_SEEDS + 1,
              f"--cli_args={BAND_CLI_ARGS}"]
    t0 = time.perf_counter()
    uncut = subprocess.Popen(
        band_script("run", "--seeds", SEED, "--chunk", BAND_EPISODES,
                    "--out", BAND / "uncut", "--work", BAND / "uncut_work",
                    *common),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        chunked = subprocess.run(
            band_script("run", "--seeds",
                        *range(SEED, SEED + BAND_SEEDS), "--chunk", 1,
                        "--out", BAND / "chunked", "--work",
                        BAND / "chunked_work", *common),
            capture_output=True, text=True, timeout=600)
        uncut_out, _ = uncut.communicate(timeout=600)
    finally:
        if uncut.poll() is None:
            uncut.kill()
            uncut.wait()
    seconds = time.perf_counter() - t0
    for name, rc, text in (("chunked", chunked.returncode,
                            chunked.stdout + chunked.stderr),
                           ("uncut", uncut.returncode, uncut_out)):
        if rc != 0:
            raise RuntimeError(f"band {name} run: exit code {rc}\n{text}")

    def kept(name, seed):
        work = BAND / f"{name}_work" / f"s{seed}"
        state = json.loads((work / "state.json").read_text())
        rows = (BAND / name / f"s{seed}" / "progress.txt").read_text()
        info = json.loads((BAND / name / f"s{seed}" / "run.json").read_text())
        return state, rows, work / state["checkpoint"], info

    c_state, c_rows, c_ckpt, c_info = kept("chunked", SEED)
    u_state, u_rows, u_ckpt, _ = kept("uncut", SEED)
    # the kept checkpoints are packed; the script's own reader unpacks them
    spec = importlib.util.spec_from_file_location("band_torch",
                                                  band_script()[1])
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    zc, zu = script.unpack_arrays(c_ckpt), script.unpack_arrays(u_ckpt)
    differ = sorted(set(zc) ^ set(zu)) + [
        k for k in sorted(set(zc) & set(zu))
        if zc[k].shape != zu[k].shape or zc[k].tobytes() != zu[k].tobytes()]
    chunks = [c["episodes"] for c in c_state["chunks"]]
    if (c_rows != u_rows or differ
            or chunks != [[e, e] for e in range(BAND_EPISODES)]
            or len(c_rows.splitlines()) != BAND_EPISODES + 1):
        raise RuntimeError(f"band: seed {SEED} chunked {chunks} against "
                           f"uncut: rows {'equal' if c_rows == u_rows else 'differ'}"
                           f", checkpoint arrays that differ: {differ}")
    rates = {}
    for seed in range(SEED, SEED + BAND_SEEDS):
        _, rows, _, info = kept("chunked", seed)
        if len(rows.splitlines()) != BAND_EPISODES + 1:
            raise RuntimeError(f"band: seed {seed} kept {rows!r}")
        rates[seed] = info["env_steps_per_s"]
    judged = subprocess.run(
        band_script("judge", "--port", BAND / "chunked", "--episodes",
                    BAND_EPISODES, "--json", BAND / "judge.json"),
        capture_output=True, text=True, timeout=120)
    if judged.returncode != 0:
        raise RuntimeError(f"band judge: {judged.stdout + judged.stderr}")
    verdict = judged.stdout.strip().splitlines()[-1]
    phase(f"band: {BAND_SEEDS} seeds x {BAND_EPISODES} chunks of 1 episode "
          f"({BAND_CLI_ARGS}) through scripts/band_torch.py run beside seed "
          f"{SEED} uncut: seed {SEED}'s rows and final checkpoint bit for "
          f"bit the uncut run's ({c_state['env_steps']} env steps); "
          f"env-steps/s per seed over its processes' lives {rates}; "
          f"{seconds:.2f} s for both runs; judge (not a gate): {verdict} "
          f"on {card}")
    for line in judged.stdout.splitlines():
        if line.startswith("port:"):
            phase(f"band judge {line}")
    shutil.rmtree(BAND / "chunked_work", ignore_errors=True)
    shutil.rmtree(BAND / "uncut_work", ignore_errors=True)
    return {"seeds": BAND_SEEDS, "episodes": BAND_EPISODES,
            "chunked_equals_uncut": True, "env_steps": c_state["env_steps"],
            "env_steps_per_s": rates, "seconds": seconds,
            "judge": verdict, "card": c_info["cards"]}


def ep_values(episodes, i):
    """Seed i's rewards and last-update metrics over the episodes."""
    return [v for ep in episodes
            for v in [ep[i]["reward"]] + list(ep[i]["train"].values())]


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--startup"]:
        startup_child(float(sys.argv[2]))
        return 0
    dev = torch.device("cuda")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(card)
    host = host_info()
    phase(f"host: {host['cpu_model']}; cores {host['affinity']} "
          f"({len(host['affinity'])}); probe {host['probe_ms']} ms (best of "
          f"{HOST_PROBE_REPEATS}, {HOST_PROBE_ITERS} iterations of a pure "
          f"Python loop)")
    phase(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    if sys.argv[1:2] == ["--squash"]:
        return squash_only(dev, card)

    start = t0 = time.perf_counter()
    marks = []  # (phase, seconds since the start) at each phase's end

    def mark(name):
        marks.append((name, round(time.perf_counter() - start, 2)))

    lib = node_kernel.build(verbose=True)
    phase(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    tensor_core_check(lib)
    tanh = tanh_saturation(card)
    tanh["xla"] = xla_tanh_on_card(dev, card)

    gen = torch.Generator(dev).manual_seed(SEED)
    max_err = check_kernel(dev, gen)
    times = time_kernel(dev, gen, card)
    chain = pvtol_chain(dev, gen, card)
    sweep(dev, gen, card)
    mark("kernel (2-4)")
    cfg, ts, rl, node, launches, by_path, one_seed = main_path(dev, card)
    profile_steps(cfg, ts, rl, node, dev, card)
    time_updates(cfg, ts, rl, node, dev, card)
    update_on_card_vs_cpu(cfg, rl, node, dev)
    squash = squash_on_card(cfg, ts, rl, node, dev, card)
    mark("main path (5)")
    for preset, (episodes, steps) in PRESET_RUNS.items():
        argv = ["--max_episodes", str(episodes), "--max_episode_steps",
                str(steps)]
        run, by_path[preset], _, _, _ = cli_run(preset, argv, card, preset)
        # cars' NODE is the mlp field, which has no kernel; PVTOL's is
        # control-affine and runs K1 in its fit and its chain
        if (by_path[preset] > 0) != (preset == "pvtol"):
            raise RuntimeError(f"{preset}: {by_path[preset]} K1 launches")
        check_preset(preset, argv, run, dev, card)

    nbc_err = nbc_calls(dev, gen, card)
    for preset in NBC_RUNS:
        run, argv, by_path[preset] = nbc_run(preset, card)
        check_preset(preset, argv, run, dev, card)
    quad_dir, argv = quad_run(card)
    by_path["quadrotor"] = 0
    check_preset("quadrotor", argv, quad_dir, dev, card)
    mark("presets (6-7)")

    dopri5_on_card(dev, gen, card)
    by_path["unicycle_dopri5_scan"] = dopri5_run(dev, card)
    by_path.update(host_loop_runs(dev, card))
    mark("dopri5, host loop (8-11)")

    eval_runs(card, quad_dir)
    export_run(dev, card)
    by_path["unicycle_profiled"] = profile_run(card)
    by_path.update(custom_env_runs(card))
    mark("eval, export, profile, custom envs (12-15)")
    seeds_by_path, seeds_info = seeds_run(dev, card, one_seed)
    by_path.update(seeds_by_path)
    by_path.update(gang_runs(dev, card))
    by_path.update(dopri5_gang_runs(dev, card))
    mark("seeds, gangs (16-17)")
    levers = levers_ab(dev, card, one_seed["run"])
    by_path.update({f"unicycle_lever_{k}": v["launches"]
                    for k, v in levers.items()})
    by_path["unicycle_bf16_update"] = bf16_update(rl, node, dev, card)
    startup = startup_runs(card)
    by_path.update({f"startup_{k}": v["launches"]
                    for k, v in startup.items()})
    mark("levers, bf16, start-up (18-20)")
    seed_batched = lockstep_kernel(dev, gen, card)
    lockstep, lockstep_by_path, lockstep_ref = lockstep_runs(
        dev, card, one_seed, seeds_info)
    by_path.update(lockstep_by_path)
    mark("lockstep unicycle (21)")
    lockstep_calls = lockstep_k1_calls(dev, gen, card)
    lockstep["presets"], presets_by_path = lockstep_presets(dev, card)
    by_path.update(presets_by_path)
    mark("lockstep presets (22)")
    lockstep["dopri5"], dopri5_by_path = lockstep_dopri5(dev, gen, card)
    by_path.update(dopri5_by_path)
    mark("lockstep dopri5, per-seed builder (23)")
    lockstep["cards"], cards_by_path = lockstep_cards(dev, card,
                                                      lockstep_ref)
    by_path.update(cards_by_path)
    mark("lockstep in shards, stacked twin-Q (24)")
    band = band_runs(card)
    mark("band script (25)")

    big = times[32768]
    print(json.dumps({"kernels": [{
        "name": "node_euler", "route": "cuda",
        "source": "nlbac_tpu_torch/csrc/node_euler.cu",
        "replaces": "nlbac_tpu/ops/node_kernel.py:104",
        "launches": launches, "max_abs_err": max_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None, "rows": 32768,
        "call_ms": big["call_ms"], "plain_call_ms": big["plain_call_ms"],
        "bound_tc_ms": big["bound_tc_ms"],
        "bound_f32_ms": big["bound_f32_ms"],
        "host_us_per_call": times[128]["host_us_per_call"],
        "at_128_rows": times[128], "pvtol_chain": chain,
        "nbc_calls_max_abs_err": nbc_err, "seed_batched": seed_batched,
        "seed_batched_calls": lockstep_calls,
        "launches_by_path": by_path}], "tanh": tanh, "levers": levers,
        "startup": startup, "lockstep": lockstep, "band": band,
        "squash": squash, "host": host,
        "phase_end_seconds": dict(marks)}), flush=True)
    phase(f"total: {time.perf_counter() - start:.2f} s from the build to "
          f"the end on {card}; seconds since the start at each phase's "
          f"end: {dict(marks)}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
