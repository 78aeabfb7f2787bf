"""Training CLI of the port (port of ``nlbac_tpu/train/cli.py``):
``nlbac-train-torch --preset
unicycle|cars|pvtol|nbc_unicycle|nbc_pvtol|quadrotor``.

The flags, their defaults, the run-directory layout
(``<output>/<env>-run<N>/<exp_name>/<exp_name>_s<seed>/``), the
``progress.txt`` columns, ``config.json``, the reference-layout weight
files and the save cadence are the JAX CLI's; the full-state checkpoint
is the port's own ``.npz`` (``train/checkpoint.py``). Training runs on
the GPU unless ``--cpu`` is given. ``--host_loop`` trains through the
host-loop mode (``train/host_loop.py``: the preset's env behind the host
gym API, the native RL ring, the updates on the device);
``--wandb``/``--tensorboard`` add those channels when installed;
``--profile_dir`` writes a ``torch.profiler`` trace of the second episode
the process runs. ``--mode eval`` rolls out the weights in ``--output``
(a run directory) for 5 episodes (``utils/evaluate.py``).

Flags whose feature is not ported yet are still parsed, and raise an
error naming the ROADMAP.md item that ports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from collections import deque

import torch

from nlbac_tpu_torch import resolve_device, runtime_native
from nlbac_tpu_torch.agent import create_train_state
from nlbac_tpu_torch.agent.update import METRIC_NAMES
from nlbac_tpu_torch.config import NLBACConfig, get_config
from nlbac_tpu_torch.constraints import uses_barrier
from nlbac_tpu_torch.envs import as_host_env, get_env
from nlbac_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    checkpoint_arrays,
    restore_checkpoint,
    save_model_weights,
)
from nlbac_tpu_torch.train.driver import (
    build_step_kwargs,
    create_replays,
    make_episode_runner,
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
    p.add_argument("--mode", default="train", choices=["train", "eval"],
                   help="eval: roll out the weights in --output (a run "
                        "directory) for 5 episodes")
    # parsed for the JAX CLI's command lines; not ported yet (ROADMAP.md)
    p.add_argument("--n_seeds", type=int, default=1)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--coordinator", default=None)
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


def check_ported(args, cfg: NLBACConfig) -> None:
    """Raise ``SystemExit`` for a flag whose feature the port does not
    have yet, naming the ROADMAP.md item that ports it."""
    unported = (
        (args.n_seeds != 1, "--n_seeds", 18),
        (args.dp != 1 or args.tp != 1, "--dp/--tp", 18),
        (args.num_processes != 1 or args.coordinator is not None
         or args.process_id is not None,
         "the multi-host flags (--coordinator, --num_processes, "
         "--process_id)", 18),
    )
    for hit, what, item in unported:
        if hit:
            raise SystemExit(f"{what} is not ported to nlbac_tpu_torch yet "
                             f"(ROADMAP.md, Queue 1 item {item})")


def _validate_save_best(cfg: NLBACConfig, output_dir) -> None:
    metric = cfg.run.save_best_metric
    if metric is None:
        return
    if metric not in ("reward", "goal_rate"):
        raise ValueError(f"save_best_metric={metric!r} must be 'reward' "
                         "or 'goal_rate'")
    if cfg.run.save_best_window < 1:
        raise ValueError("save_best_window must be >= 1")
    if output_dir is None:
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


def _episode_to_host(m) -> dict:
    """The episode's metrics as Python numbers, in one device read."""
    scalars = ("reward", "num_violations", "safety_cost", "reached",
               "goal_met", "backup_steps", "short_integrations")
    flat = torch.cat(
        [torch.stack([getattr(m, k).to(torch.float32) for k in scalars]),
         m.viol_breakdown, m.cost_breakdown,
         torch.stack([m.train[k].to(torch.float32) for k in METRIC_NAMES])]
    ).tolist()
    host = dict(zip(scalars, flat))
    host["viol_breakdown"] = flat[len(scalars):len(scalars) + 4]
    host["cost_breakdown"] = flat[len(scalars) + 4:len(scalars) + 8]
    host["train"] = dict(zip(METRIC_NAMES, flat[len(scalars) + 8:]))
    host["steps"] = m.steps
    return host


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


def train(cfg: NLBACConfig, output_dir: str | None = None,
          quiet: bool = False, checkpoint_path: str | None = None,
          resume_path: str | None = None, device="cuda",
          profile_dir: str | None = None):
    """The training loop: episodes of ``run_episode`` with the JAX CLI's
    logging, weight files, checkpoint cadence and best-window selection.
    With ``profile_dir``, the second episode this process runs (a steady
    one, also under ``resume_path``) is traced into it. Returns ``(ts,
    rl_replay, node_replay)``."""
    device = resolve_device(device)
    _validate_save_best(cfg, output_dir)
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
                resume_path, ts, rl_replay, node_replay, gen)
            start_episode = ep0 + 1
            print(colorize(f"resumed from {resume_path} at episode "
                           f"{start_episode} ({total_steps} steps)",
                           "yellow"))
        run_episode = make_episode_runner(cfg, device)

    save_every = max(1, cfg.run.max_episodes // cfg.run.save_every_fraction)
    best_metric = cfg.run.save_best_metric
    if best_metric is not None:
        # clamp to the episodes this process will track, so short runs
        # and late resume points still produce a best/ snapshot
        best_first = max(start_episode, cfg.run.save_best_after)
        best_window = deque(maxlen=max(1, min(
            cfg.run.save_best_window, cfg.run.max_episodes - best_first)))
        best_mean = None
        best_dir = os.path.join(output_dir, "best")

    try:
        for i_episode in range(start_episode, cfg.run.max_episodes):
            phase = "episode_first" if i_episode == 0 else "episode"
            prof = (start_profile(device) if profile_dir is not None
                    and i_episode == start_episode + 1 else None)
            with timer.time(phase):
                ts, rl_replay, node_replay, m, total_steps = run_episode(
                    ts, rl_replay, node_replay, gen, i_episode, total_steps)
                m = _episode_to_host(m)
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
                        save_model_weights(best_dir, ts,
                                           include_barrier=is_nbc)
                        with open(os.path.join(best_dir, "best.json"),
                                  "w") as f:
                            json.dump({"episode": i_episode,
                                       "metric": best_metric,
                                       "window": len(best_window),
                                       "after": cfg.run.save_best_after,
                                       "value": cur}, f)

            if (i_episode % save_every == 0
                    or i_episode == cfg.run.max_episodes - 1):
                if output_dir is not None:
                    save_model_weights(output_dir, ts,
                                       include_barrier=is_nbc)
                    if checkpoint_path is None:
                        checkpoint_path = os.path.join(output_dir,
                                                       "checkpoint.npz")
                    with timer.time("checkpoint"):
                        ckpt_writer.save(checkpoint_path, checkpoint_arrays(
                            ts, rl_replay, node_replay, gen, total_steps,
                            i_episode))

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

            logger.store(Episode=i_episode, episode_steps=m["steps"],
                         reward_train=m["reward"],
                         cost_train=m["num_violations"],
                         safety_cost_train=m["safety_cost"],
                         goal_met=m["goal_met"], reached=m["reached"])
            for k in train_columns:
                logger.store(**{k: m["train"][k]})
            for k in ("Episode", "episode_steps", "reward_train",
                      "cost_train", "safety_cost_train", "goal_met",
                      "reached") + train_columns:
                logger.log_tabular(k)
            logger.log_tabular("updates", ts.updates)
            logger.log_tabular("backup_steps", int(m["backup_steps"]))
            logger.dump_tabular()
    finally:
        sink.close()
        ckpt_writer.wait()
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
            resume_path=args.resume, device=device)
    finally:
        if sink is not None:
            sink.close()
        logger.close()
    save_model_weights(lk["output_dir"], ts,
                       include_barrier=uses_barrier(cfg.constraint.kind))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.host_loop:
        check_host_loop(args)
    if args.mode == "eval":
        check_eval(args)
    cfg = config_from_args(args)
    check_ported(args, cfg)
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
    # before any run dir is made: raises without a GPU unless --cpu
    device = resolve_device("cpu" if args.cpu else "cuda")
    if args.mode == "eval":
        # the weights in --output, which names a run directory here
        from nlbac_tpu_torch.utils.evaluate import (
            load_trained_state,
            run_policy,
        )
        ts = load_trained_state(cfg, args.output, device)
        run_policy(cfg, ts, episodes=5, seed=cfg.run.seed)
        return
    if args.host_loop:
        train_host_loop(args, cfg, device)
        return
    out = get_output_folder(args.output, cfg.env.name)
    lk = setup_logger_kwargs(cfg.run.exp_name, cfg.run.seed, data_dir=out)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(colorize(f"NLBAC-TORCH preset={args.preset} env={cfg.env.name} "
                   f"device={name} -> {out}", "green", bold=True))
    train(cfg, output_dir=lk["output_dir"], quiet=args.quiet,
          checkpoint_path=args.checkpoint, resume_path=args.resume,
          device=device, profile_dir=args.profile_dir)


if __name__ == "__main__":
    main()
