"""Headless rendering (the port's copy of ``nlbac_tpu/envs/render.py``):
rgb_array frames of the four envs (hazards, goal, robot, heading line,
PVTOL's operator marker) drawn on matplotlib's Agg canvas as HxWx3 uint8
arrays, a video writer and a live viewer. States are numpy arrays (or
anything ``np.asarray`` takes: a CPU tensor); the constants come from the
port's env modules. matplotlib is imported when a frame is drawn, so a
missing matplotlib fails there with its ImportError.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np


def _canvas(figsize=(6, 4)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=figsize, dpi=100)
    return fig, ax


def _to_rgb(fig) -> np.ndarray:
    fig.canvas.draw()
    buf = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    import matplotlib.pyplot as plt
    plt.close(fig)
    return buf


def render_unicycle(state, trajectory: Optional[np.ndarray] = None
                    ) -> np.ndarray:
    """One rgb frame of the unicycle world. state: (3,) [x, y, theta]."""
    from matplotlib.patches import Circle

    from nlbac_tpu_torch.envs import unicycle as env
    fig, ax = _canvas()
    for loc in np.asarray(env.HAZARDS):
        ax.add_patch(Circle(loc, env.HAZARD_RADIUS, color="red",
                            alpha=0.6))
    goal = np.asarray(env.GOAL)
    ax.add_patch(Circle(goal, env.GOAL_SIZE, color="green", alpha=0.6))
    s = np.asarray(state)
    ax.plot(s[0], s[1], "o", color="steelblue", markersize=8)
    ax.plot([s[0], s[0] + 0.4 * np.cos(s[2])],
            [s[1], s[1] + 0.4 * np.sin(s[2])], "k-", lw=2)
    if trajectory is not None:
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], "-", color="steelblue", alpha=0.5)
    ax.set_xlim(-3.2, 3.2)
    ax.set_ylim(-3.2, 3.2)
    ax.set_aspect("equal")
    return _to_rgb(fig)


def render_pvtol(state, trajectory: Optional[np.ndarray] = None
                 ) -> np.ndarray:
    """One rgb frame of the PVTOL world. state: (7,) incl. operator x."""
    from nlbac_tpu_torch.envs import pvtol as env
    from matplotlib.patches import Circle
    fig, ax = _canvas()
    for loc in np.asarray(env.HAZARDS):
        ax.add_patch(Circle(loc, env.HAZARD_RADIUS, color="red",
                            alpha=0.6))
    ax.add_patch(Circle(np.asarray(env.GOAL), env.GOAL_SIZE, color="green",
                        alpha=0.2))
    s = np.asarray(state)
    ax.plot(s[0], s[1], "s", color="steelblue", markersize=9)
    ax.plot([s[0], s[0] - 0.5 * np.sin(s[2])],
            [s[1], s[1] + 0.5 * np.cos(s[2])], "k-", lw=2)
    ax.plot(s[6], -5.8, "^", color="orange", markersize=10)  # operator
    if trajectory is not None:
        t = np.asarray(trajectory)
        ax.plot(t[:, 0], t[:, 1], "-", color="steelblue", alpha=0.5)
    ax.set_xlim(-7, 7)
    ax.set_ylim(-6, 6)
    ax.set_aspect("equal")
    return _to_rgb(fig)


def render_cars(state) -> np.ndarray:
    """One rgb frame of the car chain. state: (10,) [x_i, v_i]."""
    fig, ax = _canvas(figsize=(8, 2.2))
    # accept padded state rows (evaluate.py tracks a fixed 12-wide
    # buffer); the car chain is exactly the first 10 entries
    s = np.asarray(state).ravel()[:10]
    pos = s[0::2]
    vel = s[1::2]
    colors = ["gray", "gray", "gray", "steelblue", "gray"]
    for i, (x, v) in enumerate(zip(pos, vel)):
        ax.plot(x, 0, "s", color=colors[i], markersize=14)
        ax.annotate(f"{v:.1f}", (x, 0.15), ha="center", fontsize=8)
    ax.set_ylim(-0.5, 0.6)
    ax.set_xlim(pos.min() - 5, pos.max() + 5)
    ax.get_yaxis().set_visible(False)
    return _to_rgb(fig)


def render_quadrotor(state, trajectory: Optional[np.ndarray] = None
                     ) -> np.ndarray:
    """One rgb frame of the quadrotor world. state: (6,)
    [x, vx, z, vz, theta, omega]."""
    from nlbac_tpu_torch.envs import quadrotor as env
    from matplotlib.patches import Circle, Rectangle
    fig, ax = _canvas()
    ax.add_patch(Rectangle((env.X_RANGE[0], env.Z_RANGE[0]),
                           env.X_RANGE[1] - env.X_RANGE[0],
                           env.Z_RANGE[1] - env.Z_RANGE[0],
                           fill=False, edgecolor="gray", linestyle="--"))
    ax.add_patch(Circle(np.asarray(env.OBSTACLE), env.OBSTACLE_RADIUS,
                        color="red", alpha=0.6))
    ax.add_patch(Circle(np.asarray(env.GOAL), env.GOAL_SIZE,
                        color="green", alpha=0.4))
    s = np.asarray(state)
    x, z, th = s[0], s[2], s[4]
    arm = 0.15
    dx, dz = arm * np.cos(th), arm * np.sin(th)
    ax.plot([x - dx, x + dx], [z - dz, z + dz], "k-", lw=3)
    ax.plot(x, z, "o", color="steelblue", markersize=6)
    if trajectory is not None:
        tr = np.asarray(trajectory)
        ax.plot(tr[:, 0], tr[:, 2], "-", color="steelblue", alpha=0.5)
    ax.set_xlim(-2.5, 2.5)
    ax.set_ylim(-0.2, 2.4)
    ax.set_aspect("equal")
    return _to_rgb(fig)


def render(env_name: str, state, trajectory=None) -> np.ndarray:
    if env_name == "unicycle":
        return render_unicycle(state, trajectory)
    if env_name == "pvtol":
        return render_pvtol(state, trajectory)
    if env_name == "cars":
        return render_cars(state)
    if env_name == "quadrotor":
        return render_quadrotor(state, trajectory)
    raise ValueError(f"no renderer for env {env_name!r}")


def save_video(frames: List[np.ndarray], path: str, fps: int = 30) -> str:
    """Write frames to a video file; returns the path actually written.

    ``.gif`` uses the pillow writer (always available with matplotlib);
    other extensions use ffmpeg. When the requested encoder is missing
    (this image has no ffmpeg), degrade in order: swap the extension to
    ``.gif``, then a directory of ``.png`` frames as the last resort —
    a single-file artifact beats a frame dump wherever possible."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    def _write(out_path, writer):
        fig = plt.figure(figsize=(frames[0].shape[1] / 100,
                                  frames[0].shape[0] / 100), dpi=100)
        ax = fig.add_axes([0, 0, 1, 1])
        ax.axis("off")
        im = ax.imshow(frames[0])

        def update(i):
            im.set_data(frames[i])
            return [im]

        ani = animation.FuncAnimation(fig, update, frames=len(frames))
        try:
            ani.save(out_path, fps=fps, writer=writer)
        finally:
            plt.close(fig)
        return out_path

    import os
    # os.path.splitext, NOT rsplit('.') — a dotted directory name with
    # an extensionless filename ('results/v1.2/clip') must not have its
    # "extension" stripped into the parent directory
    root, ext = os.path.splitext(path)
    attempts = ([(path, "pillow")] if ext == ".gif"
                else [(path, "ffmpeg"), (root + ".gif", "pillow")])
    for out_path, writer in attempts:
        try:
            return _write(out_path, writer)
        except Exception:  # noqa: BLE001 — missing encoder: try the next
            continue
    base = root
    os.makedirs(base, exist_ok=True)
    from matplotlib.image import imsave
    for i, fr in enumerate(frames):
        imsave(os.path.join(base, f"frame_{i:05d}.png"), fr)
    return base


class LiveViewer:
    """Interactive live viewer (``env.render(mode='human')``).

    Displays frames in an interactive matplotlib window when a GUI
    backend + display are available; on headless hosts it degrades to
    collecting frames in ``self.frames`` (one warning), so rollout code
    can call ``show`` unconditionally and still produce a video.
    """

    def __init__(self, env_name: str, max_kept_frames: int = 10000):
        self.env_name = env_name
        self.frames: List[np.ndarray] = []
        self._max_kept = max_kept_frames
        self._im = None
        self._fig = None
        self._interactive = None  # decided on first show()

    def _try_open_window(self, frame) -> bool:
        import os
        if not (os.environ.get("DISPLAY") or os.environ.get(
                "WAYLAND_DISPLAY")):
            return False
        try:
            import matplotlib
            import matplotlib.pyplot as plt
            if matplotlib.get_backend().lower() == "agg":
                return False
            plt.ion()
            self._fig = plt.figure(f"nlbac-tpu-torch: {self.env_name}")
            ax = self._fig.add_axes([0, 0, 1, 1])
            ax.axis("off")
            self._im = ax.imshow(frame)
            return True
        except Exception:
            return False

    def show(self, state, trajectory=None) -> np.ndarray:
        """Render one frame and display (or collect) it; returns it."""
        frame = render(self.env_name, state, trajectory)
        if self._interactive is None:
            self._interactive = self._try_open_window(frame)
            if not self._interactive:
                import warnings
                warnings.warn(
                    "no interactive display available; LiveViewer is "
                    "collecting frames (use .frames / save_video)",
                    stacklevel=2)
        if self._interactive:
            import matplotlib.pyplot as plt
            self._im.set_data(frame)
            self._fig.canvas.draw_idle()
            plt.pause(0.001)
        elif len(self.frames) < self._max_kept:
            # frame collection is the HEADLESS degradation (docstring):
            # an interactive session must not silently accumulate
            # ~720KB/frame across long rollouts
            self.frames.append(frame)
        return frame

    def close(self) -> None:
        if self._fig is not None:
            import matplotlib.pyplot as plt
            plt.close(self._fig)
            self._fig = self._im = None
