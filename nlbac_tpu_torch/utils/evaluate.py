"""Policy evaluator (port of ``nlbac_tpu/utils/evaluate.py``): load a
trained agent's weights and roll out its policy, by default the
deterministic head ``tanh(mean) * scale + bias``, reporting each
episode's return, length and violations; ``--render`` writes a video of
the first episode, ``--display`` shows the episodes live.

Usage:
    python -m nlbac_tpu_torch.utils.evaluate RUN_DIR --preset unicycle \
        --episodes 5 [--render out.mp4] [--json out.json] [--cpu]

``RUN_DIR`` holds the weight files ``actor.pkl``/``critic.pkl``/... that
both packages write, so a run of either evaluates here. The rollout runs
on the GPU unless ``--cpu`` is given. Each episode resets from a
``torch.Generator`` seeded ``seed + ep`` and ends at ``done``, reading
the device once a step. The policy squashes with the tanh its weights
were trained under (the record ``train.checkpoint.weights_squash``
reads).
"""

from __future__ import annotations

import argparse
import inspect
import time
from typing import Optional

import numpy as np
import torch

from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import (
    DEFAULT_SQUASH,
    ActionSpec,
    deterministic_policy_sample,
    gaussian_policy_sample,
    policy_mean_action,
)
from nlbac_tpu_torch.tree import tree_leaves


def aggregate(results):
    """Per-key means over per-episode result dicts (the printed summary
    and --json both use it)."""
    return {k: float(np.mean([r[k] for r in results]))
            for k in ("return", "length", "violations")}


def _step_kwargs(cfg, env) -> dict:
    """The preset's episode semantics: the quadrotor's kill penalty and
    attitude kill, passed only when set (a crash then reports the return
    that training reports)."""
    step_kwargs = {}
    for kw in ("kill_penalty", "kill_attitude"):
        val = getattr(cfg.env, kw, 0.0)
        if val:
            if kw not in inspect.signature(env.step).parameters:
                raise ValueError(f"{kw}={val} but env {cfg.env.name!r} "
                                 "does not accept it")
            step_kwargs[kw] = val
    return step_kwargs


def _check_spawn_alpha(cfg, spawn_alpha) -> None:
    if cfg.env.name != "quadrotor":
        raise ValueError("--spawn_alpha is quadrotor-only (the spawn arc "
                         f"of its mix curriculum); env is {cfg.env.name!r}")
    from nlbac_tpu_torch.envs.quadrotor import CURRICULUM_ALPHA_MIN
    if not (CURRICULUM_ALPHA_MIN <= spawn_alpha <= 1.0):
        # the floor reset_curriculum clips to: below it the arc point is
        # inside the goal ring, and outside [0, 1] it is off the arc
        raise ValueError(f"--spawn_alpha {spawn_alpha} must lie in "
                         f"[{CURRICULUM_ALPHA_MIN}, 1.0] (the training arc)")


def _tracked(st, width: int):
    """The state row kept for rendering: a built-in env's ``x``, else the
    state's first tensor field, flattened to at most ``width`` entries."""
    x = st.x if hasattr(st, "x") else next(
        v for v in st if isinstance(v, torch.Tensor))
    return x.reshape(-1)[:width].to(torch.float32)


def run_policy(cfg, ts, episodes: int = 5, seed: int = 0,
               render_path: Optional[str] = None, deterministic=True,
               display: bool = False, spawn_alpha: Optional[float] = None,
               squash: str = DEFAULT_SQUASH):
    """Roll out ``ts.policy`` for ``episodes`` episodes on the device its
    weights live on, squashed with ``squash``'s tanh. Returns one
    {"return", "length", "violations"} dict an episode."""
    env = get_env(cfg.env.name)
    if spawn_alpha is not None:
        _check_spawn_alpha(cfg, spawn_alpha)
    step_kwargs = _step_kwargs(cfg, env)
    device = tree_leaves(ts.policy)[0].device
    spec = ActionSpec.from_bounds(env.SPEC.action_low, env.SPEC.action_high,
                                  device)
    policy_type = cfg.sac.policy_type
    sample = (deterministic_policy_sample if policy_type == "deterministic"
              else gaussian_policy_sample)
    max_steps = cfg.env.max_episode_steps
    # the env's physical state width, at least 12 (the JAX evaluator's
    # buffer layout)
    track_width = max(12, env.SPEC.state_dim)

    def rollout(gen):
        st, obs = env.reset(device, gen=gen, max_episode_steps=max_steps)
        if spawn_alpha is not None:
            from nlbac_tpu_torch.envs import quadrotor
            st, obs = quadrotor.spawn_at_alpha(spawn_alpha, device)
        states = torch.zeros((max_steps, track_width), device=device)
        reward = torch.zeros((), device=device)
        viol = torch.zeros((), device=device)
        n, done = 0, False
        with torch.no_grad():
            while not done:
                if deterministic:
                    a = policy_mean_action(ts.policy, obs[None], spec,
                                           policy_type, squash)[0]
                else:
                    a = sample(ts.policy, obs[None], spec, gen=gen,
                               squash=squash)[0][0]
                st, out = env.step(st, a, max_episode_steps=max_steps,
                                   **step_kwargs)
                obs = out.obs
                if n < max_steps:
                    x = _tracked(st, track_width)
                    states[n, :x.shape[0]] = x
                reward = reward + out.reward
                viol = viol + out.num_violations
                n += 1
                done = bool(out.done)  # the step's one device read
        return reward, n, viol, states

    results, frames = [], []
    viewer = None
    if display:
        from nlbac_tpu_torch.envs.render import LiveViewer
        viewer = LiveViewer(cfg.env.name)
    for ep in range(episodes):
        gen = torch.Generator(device).manual_seed(seed + ep)
        t0 = time.perf_counter()
        r, n, v, states = rollout(gen)
        r, v = torch.stack([r, v]).tolist()
        ms = (time.perf_counter() - t0) * 1e3
        results.append({"return": r, "length": n, "violations": v})
        print(f"eval ep {ep}: return={r:.2f} len={n} violations={v:.0f} "
              f"ms={ms:.1f}")
        want_frames = render_path and ep == 0
        if viewer is not None or want_frames:
            from nlbac_tpu_torch.envs.render import render
            traj = states[:n].cpu().numpy()
            stride = max(1, n // 150)
            for i in range(0, n, stride):
                if viewer is not None:
                    viewer.show(traj[i], trajectory=traj[:i + 1])
                if want_frames:
                    frames.append(render(cfg.env.name, traj[i],
                                         trajectory=traj[:i + 1]))
    if viewer is not None:
        viewer.close()
    if render_path and frames:
        from nlbac_tpu_torch.envs.render import save_video
        print(f"wrote {save_video(frames, render_path)}")
    print(f"mean over {episodes} eps: {aggregate(results)}")
    return results


def load_trained_state(cfg, run_dir: str, device):
    """A train state of ``cfg`` on ``device`` holding the weights of
    ``run_dir`` (``barrier.pkl`` too for the learned-barrier family)."""
    from nlbac_tpu_torch.agent import create_train_state
    from nlbac_tpu_torch.constraints import uses_barrier
    from nlbac_tpu_torch.train.checkpoint import load_model_weights

    ts = create_train_state(cfg, torch.Generator(device).manual_seed(0),
                            device)
    return load_model_weights(run_dir, ts, include_barrier=uses_barrier(
        cfg.constraint.kind))


def main(argv=None):
    p = argparse.ArgumentParser(description="evaluate a trained policy")
    p.add_argument("run_dir", help="directory with actor.pkl etc.")
    p.add_argument("--preset", default="unicycle")
    p.add_argument("--episodes", type=int, default=5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--render", default=None)
    p.add_argument("--display", action="store_true",
                   help="live interactive window while evaluating (frame "
                        "collection on hosts without a display)")
    p.add_argument("--stochastic", action="store_true")
    p.add_argument("--spawn_alpha", type=float, default=None,
                   help="quadrotor-only: spawn on the mix-curriculum arc "
                        "instead of the ground (1.0 = exact ground start, "
                        "smaller = closer to the goal)")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the per-episode results and their "
                        "means as JSON")
    p.add_argument("--cpu", action="store_true",
                   help="evaluate on the CPU (default: the GPU)")
    args = p.parse_args(argv)

    from nlbac_tpu_torch.config import get_config
    from nlbac_tpu_torch.train.checkpoint import weights_squash

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = get_config(args.preset)
    ts = load_trained_state(cfg, args.run_dir, device)
    results = run_policy(cfg, ts, episodes=args.episodes, seed=args.seed,
                         render_path=args.render, display=args.display,
                         deterministic=not args.stochastic,
                         spawn_alpha=args.spawn_alpha,
                         squash=weights_squash(args.run_dir))
    if args.json:
        import json

        with open(args.json, "w") as f:
            json.dump({"preset": args.preset, "run_dir": args.run_dir,
                       "seed": args.seed,
                       "deterministic": not args.stochastic,
                       "episodes": results, "mean": aggregate(results)}, f,
                      indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
