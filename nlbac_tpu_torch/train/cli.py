"""Training CLI of the port (port of ``nlbac_tpu/train/cli.py``):
``nlbac-train-torch --preset
unicycle|cars|pvtol|nbc_unicycle|nbc_pvtol|quadrotor``.

The flags, their defaults, the run-directory layout
(``<output>/<env>-run<N>/<exp_name>/<exp_name>_s<seed>/``), the
``progress.txt`` columns, ``config.json``, the reference-layout weight
files and the save cadence are the JAX CLI's; the full-state checkpoint
is the port's own ``.npz`` (``train/checkpoint.py``). Training runs on
the GPU unless ``--cpu`` is given. The policy squashes with XLA's CPU
tanh (the JAX package's squash as its CPU programs compute it,
``nn/xla_float.py``) unless ``--squash torch`` gives it ``torch.tanh``,
in every mode; the run's checkpoint and weight files record the squash
(an archive or weights directory with no record was trained under
``torch``), a ``--resume`` under another squash is refused, and ``--mode
eval`` follows the weights' record. ``--host_loop`` trains through the
host-loop mode (``train/host_loop.py``: the preset's env behind the host
gym API, the native RL ring, the updates on the device);
``--wandb``/``--tensorboard`` add those channels when installed;
``--profile_dir`` writes a ``torch.profiler`` trace of the second episode
the process runs. ``--mode eval`` rolls out the weights in ``--output``
(a run directory) for 5 episodes (``utils/evaluate.py``).

The parallel modes (``nlbac_tpu_torch/parallel``):

- ``--n_seeds N`` trains seeds ``seed .. seed+N-1`` side by side in
  worker processes (at most one per CPU core), round robin over the
  cards, into ``<run dir>/s<seed>/``, with an aggregate row per
  episode;
- ``--dp N`` / ``--tp N`` train one seed data-parallel (each rank takes
  its rows of every batch) and/or tensor-parallel (every network cut
  Megatron-style over the tp ranks) over ``dp x tp`` ranks, one process
  and one card each: on one host the CLI spawns them itself; with
  ``--coordinator host:port --num_processes P --process_id r`` each
  process is rank r of a gang of P = dp x tp ranks. Only rank 0 writes
  the run directory. Under ``--tp`` the NODE's nets are cut too, so its
  Euler step runs through the plain tp-aware layers and the fused NODE
  kernel is not launched;
- ``--n_seeds`` with ``--dp``/``--tp`` trains seed i on group ``i %
  groups`` of ``dp x tp`` ranks.

The checks of the JAX CLI run, in its order and with its messages,
before any run directory or process group exists.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
from collections import deque

import numpy as np
import torch
import torch.distributed

from nlbac_tpu_torch import resolve_device, runtime_native
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.config import NLBACConfig, get_config
from nlbac_tpu_torch.constraints import uses_barrier
from nlbac_tpu_torch.envs import as_host_env, get_env
from nlbac_tpu_torch.nn import DEFAULT_SQUASH
from nlbac_tpu_torch.parallel import (
    device_for_rank,
    gather_state_tp,
    init_distributed,
    is_rank0,
    make_async_seed_runner,
    make_grids,
    make_mesh,
    make_parallel_runner,
    run_gang,
)
from nlbac_tpu_torch.train.aot import cached_episode_runner
from nlbac_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    checkpoint_arrays,
    restore_checkpoint,
    save_model_weights,
)
from nlbac_tpu_torch.train.driver import (
    build_step_kwargs,
    create_replays,
    episode_to_host,
)
from nlbac_tpu_torch.train.host_loop import train_host_env
from nlbac_tpu_torch.train.logging import (
    EpochLogger,
    MetricsSink,
    StepTimer,
    colorize,
    warn_short,
)
from nlbac_tpu_torch.utils.output import get_output_folder, setup_logger_kwargs

# progress.txt's training columns, in the JAX CLI's order; the
# learned-barrier family appends barrier_td_loss
TRAIN_COLUMNS = ("qf1_loss", "qf2_loss", "lf_loss", "policy_loss",
                 "alpha_loss", "alpha", "node_loss", "rho", "lam_max")


def _str2bool(s: str) -> bool:
    v = s.strip().lower()
    if v in ("1", "true", "yes", "y", "on"):
        return True
    if v in ("0", "false", "no", "n", "off"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {s!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="NLBAC training on PyTorch/CUDA (nlbac_tpu_torch)")
    p.add_argument("--preset", default="unicycle",
                   choices=["unicycle", "cars", "pvtol", "nbc_unicycle",
                            "nbc_pvtol", "quadrotor"],
                   help="experiment preset")
    p.add_argument("--env-name", default=None,
                   choices=["Unicycle", "SimulatedCars", "Pvtol",
                            "Quadrotor"],
                   help="reference-style env name (maps onto a preset)")
    p.add_argument("--seed", type=int, default=12345)
    p.add_argument("--output", default="output")
    p.add_argument("--cpu", action="store_true",
                   help="train on the CPU (default: the GPU; without one "
                        "and without this flag the CLI raises)")
    p.add_argument("--policy", default=None,
                   choices=["Gaussian", "Deterministic"],
                   help="policy type (reference --policy flag)")
    # SAC
    p.add_argument("--gamma", type=float, default=None)
    p.add_argument("--tau", type=float, default=None)
    p.add_argument("--lr", type=float, default=None, help="policy lr")
    p.add_argument("--alpha", type=float, default=None)
    p.add_argument("--batch_size", type=int, default=None)
    p.add_argument("--hidden_size", type=int, default=None)
    p.add_argument("--updates_per_step", type=int, default=None)
    p.add_argument("--start_steps", type=int, default=None)
    p.add_argument("--target_update_interval", type=int, default=None)
    p.add_argument("--automatic_entropy_tuning", type=_str2bool,
                   default=None, help="true/false/1/0/yes/no")
    p.add_argument("--target_entropy", type=float, default=None,
                   help="SAC target entropy of both temperature updates "
                        "(default -dim(A))")
    # episodes / env
    p.add_argument("--max_episodes", type=int, default=None)
    p.add_argument("--max_episode_steps", type=int, default=None)
    # constraints
    p.add_argument("--gamma_b", type=float, default=None)
    p.add_argument("--gamma_l", type=float, default=None)
    p.add_argument("--rho_max", type=float, default=None,
                   help="cap on the augmented-Lagrangian coefficient rho")
    p.add_argument("--lambda_max", type=float, default=None,
                   help="cap on the Lagrange multipliers")
    p.add_argument("--rho_growth", type=float, default=None,
                   help="per-bump multiplicative growth of rho")
    p.add_argument("--lagrangian_warmup_episodes", type=int, default=None,
                   help="freeze multiplier ascent and rho growth for the "
                        "first N episodes (0 = off)")
    p.add_argument("--l_p", type=float, default=None)
    p.add_argument("--Lagrangian_multiplier_update_interval", type=int,
                   default=None)
    p.add_argument("--backup_update_interval", type=int, default=None)
    # NODE
    p.add_argument("--NODE_model_update_interval", type=int, default=None)
    p.add_argument("--NODE_fit_episode_limit", type=int, default=None,
                   help="fit the NODE only while episode <= N")
    p.add_argument("--node_solver", default=None,
                   choices=["euler", "midpoint", "heun", "rk4", "dopri5"])
    p.add_argument("--reference_time_labels", action="store_true",
                   help="push the reference's off-by-one-dt NODE-buffer "
                        "transition times (t=step*dt)")
    p.add_argument("--replay_size", type=int, default=None)
    # logging and checkpoints
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--checkpoint", default=None,
                   help="full-state checkpoint path to write (default "
                        "<run dir>/checkpoint.npz)")
    p.add_argument("--resume", default=None,
                   help="full-state checkpoint of this port to resume "
                        "from (parameters, optimizers, multipliers, "
                        "replays, generator, counters)")
    p.add_argument("--save_best", default=None,
                   choices=["reward", "goal_rate"],
                   help="track the trailing --save_best_window mean of "
                        "this per-episode metric and snapshot the best "
                        "weights to <run dir>/best/")
    p.add_argument("--save_best_window", type=int, default=None,
                   help="trailing window (episodes) for --save_best "
                        "(default 30)")
    p.add_argument("--save_best_after", type=int, default=None,
                   help="ignore episodes < N for --save_best")
    p.add_argument("--host_loop", action="store_true",
                   help="train in the host-loop mode: the env on the host, "
                        "the native C++ RL ring, the updates on the device")
    p.add_argument("--squash", default=None, choices=["torch", "xla"],
                   help="the policy's tanh: XLA's CPU tanh, as the JAX "
                        "package computes it (training's default), or "
                        "torch.tanh; --mode eval follows the weights' "
                        "record")
    p.add_argument("--mode", default="train", choices=["train", "eval"],
                   help="eval: roll out the weights in --output (a run "
                        "directory) for 5 episodes")
    p.add_argument("--n_seeds", type=int, default=1,
                   help="train seeds seed..seed+N-1 side by side (in "
                        "worker processes, round robin over the cards) "
                        "into <run dir>/s<seed>/")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel over N ranks (one card each): each "
                        "rank takes its rows of every batch, the ranks "
                        "sum the gradients")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel over N ranks: every network cut "
                        "Megatron-style (the hidden size must divide by "
                        "N). The NODE's nets are cut too, so the fused "
                        "NODE kernel is not launched under --tp; at these "
                        "widths it is a throughput loss")
    p.add_argument("--coordinator", default=None,
                   help="host:port of rank 0's rendezvous (multi-host "
                        "gangs: one process per rank, --dp x --tp == "
                        "--num_processes)")
    p.add_argument("--num_processes", type=int, default=1)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument("--spawn_curriculum_episodes", type=int, default=None)
    p.add_argument("--spawn_curriculum_mode", default=None,
                   choices=["anneal", "mix", "mix_early"])
    p.add_argument("--spawn_mix_alpha_min", type=float, default=None)
    p.add_argument("--kill_penalty", type=float, default=None)
    p.add_argument("--kill_attitude", type=float, default=None)
    p.add_argument("--pretanh_reg", type=float, default=None)
    p.add_argument("--probe_pretanh_reg", type=float, default=None)
    p.add_argument("--node_adaptive_impl", default=None,
                   choices=["while", "scan"],
                   help="dopri5 only: 'while' (a loop that reads the "
                        "device once per trial step; adjoint gradients) "
                        "or 'scan' (a fixed number of masked trials; "
                        "autograd through them)")
    p.add_argument("--node_adaptive_scan_steps", type=int, default=None,
                   help="trial steps of the 'scan' form (default 16); an "
                        "integration that runs out ends short of dt, and "
                        "the episode prints a warning")
    p.add_argument("--wandb", action="store_true",
                   help="also log each episode to wandb when installed")
    p.add_argument("--wandb_project", default=None)
    p.add_argument("--tensorboard", action="store_true",
                   help="also log each episode to <run dir>/tb when "
                        "tensorboard is installed")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler trace (Chrome JSON) of the "
                        "second episode this process runs into this "
                        "directory")
    return p


_ENV_NAME_TO_PRESET = {"Unicycle": "unicycle", "SimulatedCars": "cars",
                       "Pvtol": "pvtol", "Quadrotor": "quadrotor"}


def config_from_args(args) -> NLBACConfig:
    preset = args.preset
    if getattr(args, "env_name", None):
        preset = _ENV_NAME_TO_PRESET[args.env_name]
    cfg = get_config(preset)

    def rep(obj, **kw):
        kw = {k: v for k, v in kw.items() if v is not None}
        return dataclasses.replace(obj, **kw) if kw else obj

    cfg = dataclasses.replace(
        cfg,
        sac=rep(cfg.sac,
                policy_type=(args.policy.lower() if args.policy else None),
                gamma=args.gamma, tau=args.tau,
                policy_lr=args.lr, alpha_init=args.alpha,
                batch_size=args.batch_size, hidden_dim=args.hidden_size,
                updates_per_step=args.updates_per_step,
                start_steps=args.start_steps,
                target_update_interval=args.target_update_interval,
                automatic_entropy_tuning=args.automatic_entropy_tuning,
                target_entropy=args.target_entropy,
                pretanh_reg=args.pretanh_reg,
                probe_pretanh_reg=args.probe_pretanh_reg),
        env=rep(cfg.env, max_episode_steps=args.max_episode_steps,
                spawn_curriculum_episodes=args.spawn_curriculum_episodes,
                spawn_curriculum_mode=args.spawn_curriculum_mode,
                spawn_mix_alpha_min=args.spawn_mix_alpha_min,
                kill_penalty=args.kill_penalty,
                kill_attitude=args.kill_attitude),
        constraint=rep(cfg.constraint, gamma_b=args.gamma_b,
                       gamma_l=args.gamma_l, lookahead=args.l_p,
                       rho_max=args.rho_max, lambda_max=args.lambda_max,
                       rho_growth=args.rho_growth,
                       lagrangian_warmup_episodes=(
                           args.lagrangian_warmup_episodes),
                       lambda_update_interval=(
                           args.Lagrangian_multiplier_update_interval),
                       backup_update_interval=args.backup_update_interval),
        node=rep(cfg.node,
                 update_interval=args.NODE_model_update_interval,
                 fit_episode_limit=args.NODE_fit_episode_limit,
                 solver=args.node_solver,
                 adaptive_impl=args.node_adaptive_impl,
                 adaptive_scan_steps=args.node_adaptive_scan_steps,
                 reference_time_labels=(True if args.reference_time_labels
                                        else None)),
        run=rep(cfg.run, seed=args.seed,
                max_episodes=args.max_episodes, output=args.output,
                log_wandb=True if args.wandb else None,
                log_tensorboard=True if args.tensorboard else None,
                wandb_project=args.wandb_project,
                save_best_metric=args.save_best,
                save_best_window=args.save_best_window,
                save_best_after=args.save_best_after),
    )
    if args.replay_size is not None:
        cap = min(args.replay_size,
                  cfg.run.max_episodes * cfg.env.max_episode_steps + 1)
        cfg = dataclasses.replace(
            cfg, replay=dataclasses.replace(cfg.replay, capacity=cap,
                                            node_capacity=cap))
    return cfg


def check_gang_args(args) -> None:
    """The JAX CLI's argument-only checks of the parallel flags, raised as
    ``SystemExit`` before any process group forms (a bad flag set fails
    before the gang waits for its peers)."""
    if args.num_processes > 1:
        if not args.coordinator or args.process_id is None:
            raise SystemExit("--num_processes > 1 requires --coordinator "
                             "host:port and --process_id")
        if args.n_seeds > 1:
            raise SystemExit(
                "--n_seeds x --num_processes is not supported: the async "
                "seed runner lays seeds over this process's local "
                "devices; launch one seed per process instead")
    if args.dp < 1 or args.tp < 1:
        raise SystemExit("--dp/--tp must be >= 1")
    if (args.tp > 1 and args.hidden_size
            and args.hidden_size % args.tp != 0):
        raise SystemExit(
            f"--tp {args.tp} requires --hidden_size ({args.hidden_size}) "
            f"to be divisible by the tp width (nothing would shard)")


def check_gang_config(args, cfg: NLBACConfig) -> None:
    """The JAX CLI's checks of the parallel flags against the config, in
    its order and with its messages, then the port's own (one rank per
    process), all before any run directory."""
    ranks = args.dp * args.tp
    if args.num_processes > 1:
        if ranks != args.num_processes:
            raise SystemExit(
                f"--dp {args.dp} x --tp {args.tp} must equal "
                f"--num_processes {args.num_processes}: each process of "
                "nlbac_tpu_torch is one rank with one device")
    elif ranks > 1 and not args.cpu:
        seen = torch.cuda.device_count()
        if seen < ranks:
            raise SystemExit(f"--dp {args.dp} x --tp {args.tp} needs "
                             f"{ranks} devices; this process sees {seen} "
                             f"(cuda)")
    if args.tp > 1 and cfg.sac.hidden_dim % args.tp != 0:
        raise SystemExit(
            f"--tp {args.tp} requires the hidden dim "
            f"({cfg.sac.hidden_dim}) to be divisible by the tp width "
            f"(nothing would shard — N devices of redundant work)")
    if args.dp > 1 and (cfg.sac.batch_size % args.dp != 0
                        or cfg.node.max_batch % args.dp != 0):
        raise SystemExit(
            f"--dp {args.dp} requires batch_size "
            f"({cfg.sac.batch_size}) and the NODE max_batch "
            f"({cfg.node.max_batch}) to be divisible by the dp width")
    if args.n_seeds > 1:
        for flag in ("resume", "checkpoint", "profile_dir"):
            if getattr(args, flag, None):
                raise SystemExit(
                    f"--{flag} is a single-seed feature; it is not "
                    f"supported with --n_seeds > 1")
        if args.wandb:
            raise SystemExit("--wandb is a single-seed feature; it is "
                             "not supported with --n_seeds > 1")
        if args.tensorboard:
            raise SystemExit("--tensorboard is a single-seed feature; "
                             "it is not supported with --n_seeds > 1 "
                             "(per-seed progress.txt is the multi-seed "
                             "channel)")


def _validate_save_best(cfg: NLBACConfig, output_dir,
                        needs_dir: bool = True) -> None:
    metric = cfg.run.save_best_metric
    if metric is None:
        return
    if metric not in ("reward", "goal_rate"):
        raise ValueError(f"save_best_metric={metric!r} must be 'reward' "
                         "or 'goal_rate'")
    if cfg.run.save_best_window < 1:
        raise ValueError("save_best_window must be >= 1")
    if output_dir is None and needs_dir:
        raise ValueError("save_best_metric requires an output dir (weights "
                         "go to <output>/best/)")
    if cfg.run.save_best_after >= cfg.run.max_episodes:
        raise ValueError(
            f"save_best_after={cfg.run.save_best_after} must be < "
            f"max_episodes={cfg.run.max_episodes} (no episode would ever "
            "be tracked)")


def check_host_loop(args) -> None:
    """The JAX CLI's refusals for ``--host_loop`` (single seed, single
    device, training only, no best-window selection or profiling), raised
    as ``SystemExit`` before any run directory is made."""
    if args.mode == "eval":
        raise SystemExit("--host_loop is a training flag; it has no effect "
                         "with --mode eval")
    if args.n_seeds > 1 or args.dp > 1 or args.tp > 1 \
            or args.num_processes > 1:
        raise SystemExit("--host_loop is single-seed, single-device: "
                         "--n_seeds/--dp/--tp/--num_processes are "
                         "fused-device-mode flags")
    if args.save_best:
        raise SystemExit("--save_best is a fused-device-mode feature; it is "
                         "not supported with --host_loop")
    for flag in ("profile_dir", "save_best_window", "save_best_after"):
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag} is a fused-device-mode feature; it "
                             "is not supported with --host_loop")


def check_eval(args) -> None:
    """The JAX CLI's refusals for ``--mode eval``: flags that mean nothing
    for an evaluation, raised as ``SystemExit`` before anything runs."""
    for flag in ("resume", "checkpoint", "profile_dir", "wandb",
                 "tensorboard"):
        if getattr(args, flag, None):
            raise SystemExit(f"--{flag} has no effect with --mode eval; "
                             "drop it")
    if args.n_seeds > 1:
        raise SystemExit("--n_seeds has no effect with --mode eval — "
                         "evaluate each s<seed>/ run dir separately")
    if args.dp > 1 or args.tp > 1 or args.num_processes > 1:
        raise SystemExit("--dp/--tp/--num_processes are training flags; "
                         "they have no effect with --mode eval")


def start_profile(device):
    """A started ``torch.profiler`` of the host's ops, and the card's
    kernels when ``device`` is a GPU."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    return prof


def stop_profile(prof, device, profile_dir: str, i_episode: int) -> None:
    """Stop ``prof`` once the card has finished the episode's work, and
    write its Chrome trace to ``<profile_dir>/episode<N>.trace.json``."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, f"episode{i_episode}.trace.json")
    prof.export_chrome_trace(path)
    print(colorize(f"profile of episode {i_episode} -> {path}", "yellow"))


# pvtol's per-cause counts and costs in the wandb dict, in breakdown order
PVTOL_BREAKDOWN = (
    ("Collisions with Obstacles", "Obstacles"),
    ("Violations concerning Safety Operator", "Safety Operator"),
    ("Violations concerning ymin", "ymin"),
    ("Violations concerning ymax", "ymax"))


def log_row(logger: EpochLogger, i_episode: int, m: dict, train_columns,
            updates: int) -> None:
    """One episode's progress.txt row (the JAX CLI's columns) from its
    host metrics ``m`` (``train.driver.episode_to_host``)."""
    logger.store(Episode=i_episode, episode_steps=m["steps"],
                 reward_train=m["reward"], cost_train=m["num_violations"],
                 safety_cost_train=m["safety_cost"], goal_met=m["goal_met"],
                 reached=m["reached"])
    for k in train_columns:
        logger.store(**{k: m["train"][k]})
    for k in ("Episode", "episode_steps", "reward_train", "cost_train",
              "safety_cost_train", "goal_met", "reached") + train_columns:
        logger.log_tabular(k)
    logger.log_tabular("updates", updates)
    logger.log_tabular("backup_steps", int(m["backup_steps"]))
    logger.dump_tabular()


def train(cfg: NLBACConfig, output_dir: str | None = None,
          quiet: bool = False, checkpoint_path: str | None = None,
          resume_path: str | None = None, device="cuda",
          profile_dir: str | None = None, dp: int = 1, tp: int = 1,
          grid=None, squash: str = DEFAULT_SQUASH):
    """The training loop: episodes of ``run_episode`` with the JAX CLI's
    logging, weight files, checkpoint cadence and best-window selection.
    With ``profile_dir``, the second episode this process runs (a steady
    one, also under ``resume_path``) is traced into it. Returns ``(ts,
    rl_replay, node_replay)``.

    ``dp``/``tp`` > 1 run the same loop as one rank of a ``(dp, tp)``
    grid (``grid``, by default ``make_mesh((dp, tp))`` over an initialized
    process group): every rank restores the same checkpoint, takes rank
    0's state, and runs the data-/tensor-parallel episode; the files are
    the caller's to give to rank 0 only (``output_dir`` None elsewhere).
    Under tp the ranks put the whole state together before each save,
    so the files are those of a run of one. ``squash`` is the policy's
    tanh (``make_agent``'s), recorded in the checkpoint and beside the
    weights. Returns this rank's state (its shards under tp)."""
    device = resolve_device(device)
    if grid is None and dp * tp > 1:
        grid = make_mesh((dp, tp))
    root = grid is None or grid.is_root
    _validate_save_best(cfg, output_dir, needs_dir=root)
    logger = EpochLogger(output_dir, quiet=quiet)
    logger.save_config(cfg)
    sink = MetricsSink(logger, use_wandb=cfg.run.log_wandb
                       and output_dir is not None,
                       wandb_project=cfg.run.wandb_project,
                       wandb_config=cfg.to_dict(),
                       tensorboard_dir=(os.path.join(output_dir, "tb")
                                        if cfg.run.log_tensorboard
                                        and output_dir is not None
                                        else None))
    ckpt_writer = AsyncCheckpointer()
    timer = StepTimer()
    is_nbc = uses_barrier(cfg.constraint.kind)
    train_columns = TRAIN_COLUMNS + (("barrier_td_loss",) if is_nbc else ())

    gen = torch.Generator(device).manual_seed(cfg.run.seed)
    start_episode = total_steps = 0
    with timer.time("init"):
        ts = create_train_state(cfg, gen, device)
        rl_replay, node_replay = create_replays(cfg, device)
        if resume_path is not None:
            total_steps, ep0 = restore_checkpoint(
                resume_path, ts, rl_replay, node_replay, gen, squash)
            start_episode = ep0 + 1
            print(colorize(f"resumed from {resume_path} at episode "
                           f"{start_episode} ({total_steps} steps)",
                           "yellow"))
        if grid is not None:
            place, run_episode = make_parallel_runner(cfg, grid, device,
                                                      squash)
            ts, rl_replay, node_replay, gen, total_steps = place(
                (ts, rl_replay, node_replay, gen, total_steps))
        else:
            run_episode = cached_episode_runner(
                cfg, (ts, rl_replay, node_replay, gen, start_episode,
                      total_steps), squash=squash)

    def whole():
        """The state as a run of one holds it (a collective under tp)."""
        return gather_state_tp(ts) if grid is not None and grid.tp > 1 \
            else ts

    save_every = max(1, cfg.run.max_episodes // cfg.run.save_every_fraction)
    best_metric = cfg.run.save_best_metric
    if best_metric is not None:
        # clamp to the episodes this process will track, so short runs
        # and late resume points still produce a best/ snapshot
        best_first = max(start_episode, cfg.run.save_best_after)
        best_window = deque(maxlen=max(1, min(
            cfg.run.save_best_window, cfg.run.max_episodes - best_first)))
        best_mean = None
        best_dir = (os.path.join(output_dir, "best")
                    if output_dir is not None else None)

    try:
        for i_episode in range(start_episode, cfg.run.max_episodes):
            phase = "episode_first" if i_episode == 0 else "episode"
            prof = (start_profile(device) if profile_dir is not None
                    and root and i_episode == start_episode + 1 else None)
            with timer.time(phase):
                ts, rl_replay, node_replay, m, total_steps = run_episode(
                    ts, rl_replay, node_replay, gen, i_episode, total_steps)
                m = episode_to_host(m)
            if prof is not None:
                stop_profile(prof, device, profile_dir, i_episode)
            warn_short(i_episode, m["short_integrations"])

            if best_metric is not None and \
                    i_episode >= cfg.run.save_best_after:
                best_window.append(m["reward"] if best_metric == "reward"
                                   else m["goal_met"])
                if len(best_window) == best_window.maxlen:
                    cur = sum(best_window) / len(best_window)
                    if best_mean is None or cur > best_mean:
                        best_mean = cur
                        snap = whole()
                        if best_dir is not None:
                            save_model_weights(best_dir, snap,
                                               include_barrier=is_nbc,
                                               squash=squash)
                            with open(os.path.join(best_dir, "best.json"),
                                      "w") as f:
                                json.dump({"episode": i_episode,
                                           "metric": best_metric,
                                           "window": len(best_window),
                                           "after": cfg.run.save_best_after,
                                           "value": cur}, f)

            if (i_episode % save_every == 0
                    or i_episode == cfg.run.max_episodes - 1):
                snap = whole()
                if output_dir is not None:
                    save_model_weights(output_dir, snap,
                                       include_barrier=is_nbc,
                                       squash=squash)
                    if checkpoint_path is None:
                        checkpoint_path = os.path.join(output_dir,
                                                       "checkpoint.npz")
                    with timer.time("checkpoint"):
                        ckpt_writer.save(checkpoint_path, checkpoint_arrays(
                            snap, rl_replay, node_replay, gen, total_steps,
                            i_episode, squash))

            wb = {"Episode Reward": m["reward"],
                  "Episode Length": m["steps"],
                  "Episode Safety Cost": m["safety_cost"],
                  "Episode Number of Safety Violations":
                      m["num_violations"],
                  "Cumulated Number of steps": total_steps}
            if cfg.env.name == "cars":
                wb["Episode Number of reaching destination"] = m["reached"]
            if cfg.env.name == "pvtol":
                vb, cb = m["viol_breakdown"], m["cost_breakdown"]
                for i, what in enumerate(PVTOL_BREAKDOWN):
                    wb[f"Episode Number of {what[0]}"] = vb[i]
                    wb[f"Episode Safety Cost Concerning {what[1]}"] = cb[i]
            sink.log(wb)

            log_row(logger, i_episode, m, train_columns, ts.updates)
    finally:
        sink.close()
        ckpt_writer.wait()
    if root:
        for phase, total in timer.summary().items():
            print(colorize(f"{phase}: {total}", "cyan"))
    return ts, rl_replay, node_replay


def train_host_loop(args, cfg: NLBACConfig, device) -> None:
    """``--host_loop``: the preset's env behind the host gym API and
    ``train_host_env``, with the fused mode's run layout (config.json,
    progress.txt, weight files, checkpoint.npz in host-loop form)."""
    env_module = get_env(cfg.env.name)
    adapter = as_host_env(
        env_module, seed=cfg.run.seed,
        barrier_B=cfg.env.barrier_B if cfg.env.barrier_signals else 0.0,
        barrier_b=cfg.env.barrier_b if cfg.env.barrier_signals else 0.0,
        max_episode_steps=cfg.env.max_episode_steps,
        step_kwargs=build_step_kwargs(cfg, env_module))
    out = get_output_folder(args.output, cfg.env.name)
    lk = setup_logger_kwargs(cfg.run.exp_name, cfg.run.seed, data_dir=out)
    logger = EpochLogger(lk["output_dir"], quiet=args.quiet)
    logger.save_config(cfg)
    sink = MetricsSink(
        use_wandb=args.wandb,
        wandb_project=args.wandb_project or cfg.run.exp_name,
        wandb_config=cfg.to_dict(),
        tensorboard_dir=(os.path.join(lk["output_dir"], "tb")
                         if args.tensorboard else None)
    ) if (args.wandb or args.tensorboard) else None
    checkpoint_path = args.checkpoint or os.path.join(lk["output_dir"],
                                                      "checkpoint.npz")
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(colorize(f"NLBAC-TORCH preset={args.preset} env={cfg.env.name} "
                   f"device={name} host-loop -> {out}", "green", bold=True))
    try:
        ts, _ = train_host_env(
            cfg, adapter, logger=logger, quiet=args.quiet, sink=sink,
            weights_dir=lk["output_dir"], checkpoint_path=checkpoint_path,
            resume_path=args.resume, device=device, squash=_squash(args))
    finally:
        if sink is not None:
            sink.close()
        logger.close()
    save_model_weights(lk["output_dir"], ts,
                       include_barrier=uses_barrier(cfg.constraint.kind),
                       squash=_squash(args))


def train_multi_seed(cfg: NLBACConfig, n_seeds: int,
                     output_root: str | None, quiet: bool = False,
                     dp: int = 1, tp: int = 1, device="cuda", grids=None,
                     squash: str = DEFAULT_SQUASH):
    """Seed-parallel training (``--n_seeds``): seeds ``cfg.run.seed + i``
    advance side by side through ``parallel.make_async_seed_runner`` (in
    worker processes, see ``parallel/seeds.py``), seed i
    exactly as a single-seed ``train()`` of that seed would, each into
    ``<output_root>/s<seed>/`` (``progress.txt``, ``config.json``, the
    weight files at the cadence, ``best/`` under ``--save_best``). A row
    per episode gives the mean, population std (ddof=0), min and max
    reward over the seeds. With ``dp``/``tp``, this rank's ``grids``
    (``parallel.make_grids``) lay the seeds over groups of ranks; each
    group's first rank writes its seeds' files and global rank 0 prints
    the aggregate row; ``squash`` is every seed's policy tanh. Returns
    ``(states, launches)``: the runner's states
    and each seed's K1 launches over the run, as the kernel's wrapper
    counted them where the seed ran (0 for other groups' seeds)."""
    device = resolve_device(device)
    _validate_save_best(cfg, output_root)
    grouped = dp * tp > 1
    if grouped:
        group = next(g for g, grid in enumerate(grids) if grid is not None)
        grid = grids[group]
        mine = [i % len(grids) == group for i in range(n_seeds)]
        writes = grid.is_root and output_root is not None
        devices = [device]
    else:
        grid, mine, writes = None, [True] * n_seeds, output_root is not None
        devices = ([device] if device.type == "cpu" else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    seeds = [cfg.run.seed + i for i in range(n_seeds)]
    loggers = []
    for s, own in zip(seeds, mine):
        d = (os.path.join(output_root, f"s{s}")
             if own and writes else None)
        loggers.append(EpochLogger(d, quiet=True))
        loggers[-1].save_config(dataclasses.replace(
            cfg, run=dataclasses.replace(cfg.run, seed=s)))

    timer = StepTimer()
    with timer.time("init"):
        init_fn, step_fn = make_async_seed_runner(
            cfg, devices=devices, n_seeds=n_seeds, dp=dp, tp=tp,
            grids=grids, squash=squash)
        try:
            states = init_fn(cfg.run.seed)
        except BaseException:
            step_fn.close()
            raise
    launches = [0] * n_seeds
    try:
        _multi_seed_loop(cfg, output_root if writes else None,
                         quiet or (grouped and not is_rank0()),
                         seeds, loggers, step_fn, states,
                         uses_barrier(cfg.constraint.kind), timer, grid,
                         device, launches)
    finally:
        step_fn.close()
        for lg in loggers:
            lg.close()
    if not grouped or is_rank0():
        for phase, total in timer.summary().items():
            print(colorize(f"{phase}: {total}", "cyan"))
    return states, launches


def _seed_rewards(results, grid, device):
    """Every seed's episode reward. Under dp/tp a group's seeds come from
    its first rank, summed over the world into a zero-filled vector (a
    collective of every rank)."""
    if grid is None:
        return [r["reward"] for r in results]
    vec = torch.zeros(len(results), dtype=torch.float64, device=device)
    if grid.is_root:
        for i, r in enumerate(results):
            if r is not None:
                vec[i] = r["reward"]
    torch.distributed.all_reduce(vec)
    return vec.tolist()


def _multi_seed_loop(cfg, output_root, quiet, seeds, loggers, step_fn,
                     states, is_nbc, timer, grid, device, launches):
    """Episodes of every seed, pipelined as the JAX CLI's loop: episode i
    is queued without waiting, then episode i-1's metrics are processed
    while it runs; an episode whose weights are saved (the cadence, or
    any under --save_best) waits first, so a save sees the state right
    after that episode."""
    grouped = grid is not None
    save_every = max(1, cfg.run.max_episodes // cfg.run.save_every_fraction)
    best_metric = cfg.run.save_best_metric
    if best_metric is not None:
        maxlen = max(1, min(cfg.run.save_best_window,
                            cfg.run.max_episodes - cfg.run.save_best_after))
        best_windows = [deque(maxlen=maxlen) for _ in seeds]
        best_means = [None] * len(seeds)
    train_cols = TRAIN_COLUMNS + (("barrier_td_loss",) if is_nbc else ())

    def save(j, *parts):
        """Seed j's weights into <output_root>/s<seed>/<parts> (a
        collective of its group under tp)."""
        path = (os.path.join(output_root, f"s{seeds[j]}", *parts)
                if output_root is not None else None)
        if path is not None or grouped:
            step_fn.save_weights(states, j, path, is_nbc)
        return path

    def process(i_episode, futures):
        results = [f.result() if f is not None else None for f in futures]
        for j, m in enumerate(results):
            if m is not None:
                launches[j] += m["kernel_launches"]
        for lg, m in zip(loggers, results):
            if m is not None and lg.output_dir is not None:
                log_row(lg, i_episode, m, train_cols, m["updates"])
        rewards = _seed_rewards(results, grid, device)
        if not quiet:
            r = np.asarray(rewards)
            mean, std = float(r.mean()), float(r.std())
            lo, hi = float(r.min()), float(r.max())
            print(colorize(
                f"ep {i_episode:4d}  reward over {len(seeds)} seeds: "
                f"{mean:9.2f} ± {std:7.2f}  [{lo:9.2f}, {hi:9.2f}]",
                "white"))
        if best_metric is not None and i_episode >= cfg.run.save_best_after:
            for j, m in enumerate(results):
                if m is None:
                    continue
                best_windows[j].append(m["reward"] if best_metric == "reward"
                                       else m["goal_met"])
                if len(best_windows[j]) != best_windows[j].maxlen:
                    continue
                cur = sum(best_windows[j]) / len(best_windows[j])
                if best_means[j] is None or cur > best_means[j]:
                    best_means[j] = cur
                    bdir = save(j, "best")
                    if bdir is not None and (grid is None or grid.is_root):
                        with open(os.path.join(bdir, "best.json"),
                                  "w") as f:
                            json.dump({"episode": i_episode,
                                       "metric": best_metric,
                                       "window": len(best_windows[j]),
                                       "after": cfg.run.save_best_after,
                                       "value": cur, "seed": seeds[j]}, f)
        if (i_episode % save_every == 0
                or i_episode == cfg.run.max_episodes - 1):
            for j, m in enumerate(results):
                if m is not None:
                    save(j)

    pipelined = best_metric is None
    pending = None  # (episode, its futures)
    for i_episode in range(cfg.run.max_episodes):
        phase = "episode_first" if i_episode == 0 else "episode"
        is_sync = (not pipelined or i_episode % save_every == 0
                   or i_episode == cfg.run.max_episodes - 1)
        with timer.time(phase):
            states, futures = step_fn(states, i_episode, block=is_sync)
            if pending is not None:
                process(*pending)
                pending = None
            if is_sync:
                process(i_episode, futures)
            else:
                pending = (i_episode, futures)
    if pending is not None:
        process(*pending)


def _squash(args) -> str:
    """The policy's tanh of a training run: ``--squash``, else the
    default."""
    return args.squash or DEFAULT_SQUASH


def _device_for(args, local_rank: int = 0):
    """Before any run dir: the device this process trains on (raises
    without a GPU unless --cpu)."""
    if args.cpu:
        return resolve_device("cpu")
    resolve_device("cuda")
    return device_for_rank(False, local_rank)


def _banner(args, cfg, out, device, rank=None):
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    extra = ""
    if args.n_seeds > 1:
        n_dev = 1 if args.cpu else torch.cuda.device_count()
        extra += (f" seeds={cfg.run.seed}..{cfg.run.seed + args.n_seeds - 1}"
                  f" over {n_dev} device(s)")
    if args.dp > 1:
        extra += f" dp={args.dp}"
    if args.tp > 1:
        extra += f" tp={args.tp}"
    if rank is not None:
        extra += f" rank={rank}/{args.num_processes}"
    if _squash(args) != DEFAULT_SQUASH:
        extra += f" squash={_squash(args)}"
    print(colorize(f"NLBAC-TORCH preset={args.preset} env={cfg.env.name} "
                   f"device={name}{extra} -> {out}", "green", bold=True))


def _run_rank(args, cfg, device, out, grids) -> None:
    """One rank's training under --dp/--tp (with --n_seeds: its group's
    seeds); ``out`` is the run directory (the rank 0 of the gang, or of
    each seed group, writes into it)."""
    if args.n_seeds > 1:
        train_multi_seed(cfg, args.n_seeds, out, quiet=args.quiet,
                         dp=args.dp, tp=args.tp, device=device, grids=grids,
                         squash=_squash(args))
        return
    rank0 = grids[0].is_root
    lk = (setup_logger_kwargs(cfg.run.exp_name, cfg.run.seed, data_dir=out)
          if rank0 else {"output_dir": None})
    train(cfg, output_dir=lk["output_dir"], quiet=args.quiet or not rank0,
          checkpoint_path=args.checkpoint if rank0 else None,
          resume_path=args.resume, device=device,
          profile_dir=args.profile_dir, dp=args.dp, tp=args.tp,
          grid=grids[0], squash=_squash(args))


def _gang_rank(rank: int, world: int, coordinator: str, argv, out,
               n_groups: int) -> None:
    """A rank that ``nlbac-train-torch --dp/--tp`` spawned on this host."""
    args = build_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = device_for_rank(args.cpu, rank)
    if device.type == "cpu":
        torch.set_num_threads(1)
    init_distributed(coordinator, world, rank, device=device)
    grids = make_grids(n_groups, args.dp, args.tp)
    _run_rank(args, cfg, device, out, grids)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_parser().parse_args(argv)
    check_gang_args(args)
    if args.host_loop:
        check_host_loop(args)
    if args.mode == "eval":
        check_eval(args)
    cfg = config_from_args(args)
    if args.host_loop:
        if cfg.env.spawn_curriculum_episodes > 0 or \
                cfg.env.spawn_curriculum_mode != "anneal":
            raise SystemExit(
                "--host_loop does not support the spawn curriculum (the "
                "host gym API has no per-episode reset_curriculum "
                "channel); drop the --spawn_curriculum_* flags or train "
                "without --host_loop")
        if not runtime_native.native_available():
            raise SystemExit(
                "--host_loop needs the native host data plane "
                "(runtime/host_buffer.cpp, built with g++ into "
                "nlbac_tpu_torch/_build/) and it could not be built; check "
                "for a g++ toolchain")
    if args.mode == "train" and not args.host_loop:
        check_gang_config(args, cfg)
    # before any run dir is made: raises without a GPU unless --cpu
    device = _device_for(args, args.process_id or 0)
    if args.mode == "eval":
        # the weights in --output, which names a run directory here
        from nlbac_tpu_torch.train.checkpoint import weights_squash
        from nlbac_tpu_torch.utils.evaluate import (
            load_trained_state,
            run_policy,
        )
        squash = weights_squash(args.output)
        if args.squash not in (None, squash):
            raise SystemExit(f"the weights in {args.output} were trained "
                             f"with --squash {squash}; drop --squash or "
                             f"pass --squash {squash}")
        ts = load_trained_state(cfg, args.output, device)
        run_policy(cfg, ts, episodes=5, seed=cfg.run.seed, squash=squash)
        return
    if args.host_loop:
        train_host_loop(args, cfg, device)
        return
    ranks = args.dp * args.tp
    if args.num_processes > 1:
        # this process is one rank of a multi-host gang
        init_distributed(args.coordinator, args.num_processes,
                         args.process_id, device=device)
        grid = make_mesh((args.dp, args.tp))
        out = (get_output_folder(args.output, cfg.env.name)
               if grid.is_root else None)
        _banner(args, cfg, out, device, rank=args.process_id)
        try:
            _run_rank(args, cfg, device, out, [grid])
        finally:
            torch.distributed.destroy_process_group()
        return
    out = get_output_folder(args.output, cfg.env.name)
    _banner(args, cfg, out, device)
    if ranks > 1:
        # spawn this host's ranks: one per card (or CPU process), and
        # with --n_seeds as many groups of dp x tp as the cards hold
        n_groups = 1
        if args.n_seeds > 1 and not args.cpu:
            n_groups = max(1, min(args.n_seeds,
                                  torch.cuda.device_count() // ranks))
        run_gang(_gang_rank, ranks * n_groups, (argv, out, n_groups))
        return
    if args.n_seeds > 1:
        train_multi_seed(cfg, args.n_seeds, out, quiet=args.quiet,
                         device=device, squash=_squash(args))
        return
    lk = setup_logger_kwargs(cfg.run.exp_name, cfg.run.seed, data_dir=out)
    train(cfg, output_dir=lk["output_dir"], quiet=args.quiet,
          checkpoint_path=args.checkpoint, resume_path=args.resume,
          device=device, profile_dir=args.profile_dir, squash=_squash(args))


if __name__ == "__main__":
    main()
