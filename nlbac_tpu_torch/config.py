"""Typed configuration tree for NLBAC experiments (the port's own copy).

The port keeps this copy of ``nlbac_tpu/config.py`` so that it imports
nothing of the JAX package; the dataclasses, presets and defaults are the
same, and ``tests/test_torch_port_update.py`` holds every preset equal to
the reference's.

The reference repo is five near-identical program copies whose behavioral
differences are hardwired constants (see SURVEY.md §2.2).  Here they are a
single config dataclass with five presets.  Every magic constant in the
reference is a named field with a citation to where it lives in the
reference tree.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple


@dataclass(frozen=True)
class NodeConfig:
    """Neural-ODE dynamics model configuration.

    Reference: UNI/sac_cbf_clf/model.py:177-217 (control-affine, width 100),
    CARS/sac_cbf_clf/model.py:178-205 (non-affine, width 64, time input).
    """

    form: str = "control_affine"  # "control_affine" | "mlp"
    state_dim: int = 3
    action_dim: int = 2
    hidden_dim: int = 100
    f_hidden_layers: int = 4  # f_net depth (control-affine form)
    g_hidden_layers: int = 3  # g_net depth (control-affine form)
    mlp_hidden_layers: int = 3  # net depth (non-affine form)
    time_input: bool = False  # Cars appends t to the field input
    # Quadrotor: normalize (state, action) entering the net and
    # denormalize outputs (README.md:194-195); scales are per-dimension
    normalize: bool = False
    state_scale: Optional[Tuple[float, ...]] = None
    action_scale: Optional[Tuple[float, ...]] = None
    # 'bfloat16' runs the field's matmuls in bf16 with f32 params/outputs;
    # default f32 for strict reference parity. The port's CUDA kernel
    # takes f32 only (bf16 is queued in ROADMAP.md).
    compute_dtype: Optional[str] = None
    lr: float = 1e-3  # UNI/sac_cbf_clf/sac_cbf_clf.py:133
    solver: str = "euler"  # UNI/sac_cbf_clf/sac_cbf_clf.py:132
    solver_steps: int = 1  # t_span=[0,dt] with a fixed-step method = 1 step
    # dopri5 only (not ported yet): 'while' = data-dependent loop +
    # adjoint VJP; 'scan' = fixed-trip-count masked-acceptance loop,
    # directly reverse-differentiable.
    adaptive_impl: str = "while"
    # static trial-step bound for the scan impl — every trip is PAID in
    # compute, so this is a realistic cap for dt=0.02 spans, not the
    # while-loop's 512 backstop. CAVEAT (shared with torchdiffeq's own
    # max_num_steps): a compiled loop cannot raise, so if the PI
    # controller rejects enough trials to exhaust the bound the
    # integration is silently PARTIAL (state at t < dt). Raise the
    # bound (--node_adaptive_scan_steps) for stiff fields; the dt=0.02
    # NODE spans in the archived fused-dopri5 run never came close.
    adaptive_scan_steps: int = 16
    update_interval: int = 10  # --NODE_model_update_interval default
    max_batch: int = 32768  # UNI/sac_cbf_clf/sac_cbf_clf.py:206
    fit_episode_limit: Optional[int] = None  # PVTOL: fit only while ep<=100
    # Deliberate parity deviation (PARITY.md "Deviations from the
    # reference"): the reference pushes NODE-buffer transition times one
    # dt LATE — t=step*dt / next_t=(step+1)*dt vs the RL buffer's
    # (step-1)*dt / step*dt (CARS main.py:90-97; UNI labels BOTH buffers
    # late, main.py:97-104, but has no time-input consumer)
    # — which only perturbs the Cars time-input feature. We default to
    # the physically-consistent label shared with the RL buffer; set
    # True (--reference_time_labels) to reproduce the reference's
    # off-by-one-dt NODE times bit-faithfully.
    reference_time_labels: bool = False

    @property
    def input_dim(self) -> int:
        extra = 1 if self.time_input else 0
        return self.state_dim + self.action_dim + extra


@dataclass(frozen=True)
class SacConfig:
    """SAC hyperparameters. Reference: UNI/main.py:191-239 and agent ctor."""

    policy_type: str = "gaussian"  # "gaussian" | "deterministic"
    gamma: float = 0.99
    tau: float = 0.005
    alpha_init: float = 0.2
    policy_lr: float = 3e-4  # --lr
    critic_lr: float = 4e-4  # critic_lyapunov_lr, UNI/sac_cbf_clf.py:44
    hidden_dim: int = 256
    batch_size: int = 128
    automatic_entropy_tuning: bool = True
    target_update_interval: int = 1
    updates_per_step: int = 2
    start_steps: int = 1000  # warmup random actions
    # SAC target entropy for BOTH temperature updates (primary + backup).
    # None = the reference's -dim(A) (UNI/sac_cbf_clf/sac_cbf_clf.py:
    # 78-82), in the env-SCALED action space.  -dim(A) is only calibrated
    # for ~unit action scales: the tanh-squash log-prob correction adds
    # sum(log scale_i) to the entropy, so wide-range envs sit above the
    # target (unicycle/pvtol: +3.7/+4.0 nats, alpha decays/oscillates)
    # while the quadrotor's narrow +/-30%-hover range (-0.6 nats) leaves
    # every achievable useful policy BELOW it and alpha ratchets 0.2 ->
    # 140 until entropy noise swamps the Q term (PARITY.md "Quadrotor").
    # Override to recalibrate (e.g. -dim(A) + sum(log scale) keeps the
    # reference's concentration target in the UNIT tanh space).
    target_entropy: float | None = None
    # Pre-tanh mean regularizer (lever 16): add this * mean(pre-tanh
    # mean^2) to the policy loss (the original SAC codebase's policy
    # regularization). 0 = off (every preset default). Targets the
    # measured quadrotor ground-start tanh-saturation trap (PARITY.md
    # r7): |pre-tanh mean| drifts to 2-6 at the ground state, tanh'
    # collapses to ~5e-5, and no later penalty signal can move the
    # policy there. Gaussian policy only.
    pretanh_reg: float = 0.0
    # Probe-targeted pre-tanh regularizer (lever 18): add this *
    # mean(pre-tanh mean^2 over the env's ground_probe_obs() batch) to
    # the policy loss. Unlike pretanh_reg (replay-batch-averaged, which
    # measurably fails to de-saturate the trap because ground obs are a
    # sliver of the batch — PARITY.md lever 16), the pull lands exactly
    # at the trap states regardless of replay composition. Requires the
    # env to expose ground_probe_obs() (quadrotor only). 0 = off
    # (every preset default).
    probe_pretanh_reg: float = 0.0


@dataclass(frozen=True)
class ConstraintConfig:
    """Augmented-Lagrangian CBF/CLF constraint configuration.

    Reference: UNI/sac_cbf_clf/sac_cbf_clf.py:408-530 and per-variant
    equivalents (SURVEY.md §2.2 feature matrix).
    """

    kind: str = "unicycle"  # unicycle | cars | pvtol | learned_barrier
    gamma_b: float = 50.0  # class-K coefficient for CBF
    gamma_l: float = 1.0  # class-K coefficient for CLF
    clf_time_scaled: bool = True  # divide (L'-L) by dt (UNI) or not (CARS)
    use_ratio: bool = True  # CLF term scaled by CBF/CLF balance ratio
    ratio_floor: float = 0.0  # 0.002 for CARS/PVTOL/NBC-PVTOL
    lambda_min: float = 0.01
    lambda_max: float = 400.0  # 300.0 for CARS
    lambda_update_interval: int = 8
    rho_init: float = 1.0  # augmented_term
    rho_growth: float = 1.0005  # augmented_ratio
    rho_max: float = 200.0
    cost_limit: float = 0.0
    horizon: int = 1  # NODE prediction chain length (1 UNI, 2 CARS, 3 PVTOL)
    lookahead: float = 0.03  # l_p (unicycle lookahead point)
    collision_buffer: float = 1.05  # 1.2 for PVTOL
    # PVTOL-only constants
    operator_margin: float = 0.9  # operator_dist scaled by this in constraints
    box_delta_y: float = 10.0
    # Backup-policy update cadence: 1 = every update (UNI/CARS); 20 = PVTOL.
    backup_update_interval: int = 1
    # Whether the variant trains a backup controller at all (NBC: no).
    use_backup: bool = True
    # UNI/CARS share one rho between primary and backup losses (bumped
    # twice per update); PVTOL keeps a separate backup_augmented_term
    # (PVTOL/sac_cbf_clf/sac_cbf_clf.py:62,1033-1034).
    separate_backup_rho: bool = False
    # Opt-in (lever 10, PARITY.md "Quadrotor"): freeze the augmented-
    # Lagrangian schedule — multiplier ascent AND rho growth — for the
    # first N episodes, so the SAC objective can learn goal-reaching
    # before constraint pressure ratchets (failing quadrotor seeds
    # saturate lambda_max by ~ep 25 and rho by ~ep 55, extinguishing
    # goal-seeking before take-off is ever learned). The constraint
    # loss itself still applies with the frozen lam/rho(=rho_init).
    # 0 = off (reference semantics; no reference analog).
    lagrangian_warmup_episodes: int = 0


@dataclass(frozen=True)
class EnvConfig:
    """Environment configuration. Reference: envs/*.py per variant."""

    name: str = "unicycle"  # unicycle | cars | pvtol
    dt: float = 0.02
    max_episode_steps: int = 1200
    # NBC variants: emit barrier signals from the env
    barrier_signals: bool = False
    # little_b: the signal value when NO barrier is violated (NBC envs
    # return little_b if safe, else n_violations * capital_b — first
    # violation REPLACES little_b, the rest add; NBC unicycle_env.py:
    # 116-145). Every reference variant sets 0.0.
    barrier_b: float = 0.0
    barrier_B: float = -20.0  # capital_b (-0.1 for PVTOL)
    # Opt-in reverse spawn curriculum (envs exposing reset_curriculum;
    # currently quadrotor only): anneal the spawn from near-goal back to
    # the standard start over this many episodes. 0 = off (standard
    # reset; every preset default). See envs/quadrotor.py.
    spawn_curriculum_episodes: int = 0
    # Curriculum mode (quadrotor, requires spawn_curriculum_episodes>0):
    # "anneal" pins spawns to the ground start once the anneal completes;
    # "mix" (lever 12) switches to a stationary mixed-height distribution
    # instead (every 3rd episode an exact ground start, the rest
    # alpha ~ Uniform(0.15, 1)) — permanent rehearsal of all heights.
    # See envs/quadrotor.py reset_curriculum.
    spawn_curriculum_mode: str = "anneal"
    # Mix-mode mixture lower bound (lever 13): raise toward 1 to
    # concentrate post-anneal rehearsal on the hard near-ground band.
    # Must lie in [0.15, 1); only read when spawn_curriculum_mode="mix".
    spawn_mix_alpha_min: float = 0.15
    # Opt-in terminal crash penalty (envs whose step() accepts it;
    # currently quadrotor only): subtract this from the reward on a
    # kill-box termination. 0 = off (every preset default). Removes the
    # dive-into-the-ground local optimum — see envs/quadrotor.py step().
    kill_penalty: float = 0.0
    # Opt-in attitude-kill termination in radians (quadrotor only):
    # terminate (and apply kill_penalty) when |theta| exceeds this. 0 =
    # off (every preset default). The real safe-control-gym terminates
    # on attitude; without it the learned behavior family is ballistic
    # tumble-throws (PARITY.md r7). See envs/quadrotor.py step().
    kill_attitude: float = 0.0


@dataclass(frozen=True)
class SupervisorConfig:
    """Backup-controller trigger state machine (the reference's failure
    detection / recovery subsystem). Reference: UNI/main.py:109-142,
    CARS/main.py:102-112, PVTOL/main.py:128-201."""

    kind: str = "trap"  # trap | cars_gap | pvtol (trap + operator-rush) | none
    enable_after_episodes: int = 4  # i_episode > 3 (UNI) / >= 3 (PVTOL)
    window: int = 40  # position window length
    min_steps: int = 50  # only check after this many steps
    trap_threshold: float = 0.01  # displacement^2 threshold (0.015 PVTOL)
    trap_count: int = 8  # consecutive trap detections before switch
    backup_max_steps: int = 30  # 15 for CARS / PVTOL operator-rush
    escape_distance_sq: float = 0.6  # 1.0 for PVTOL
    # Cars-specific
    cars_gap: float = 2.5
    cars_min_backup_steps: int = 5
    cars_backup_max_steps: int = 15
    # PVTOL operator-rush specific
    rush_backup_max_steps: int = 15
    operator_dist: float = 1.0


@dataclass(frozen=True)
class ReplayConfig:
    capacity: int = 300_000  # sized to actual episode budgets, not 1e7
    node_capacity: int = 300_000


@dataclass(frozen=True)
class RunConfig:
    seed: int = 12345
    max_episodes: int = 200
    save_every_fraction: int = 2  # save at max_episodes/N cadence (6 for CARS)
    output: str = "output"
    exp_name: str = "nlbac"
    log_wandb: bool = False
    wandb_project: str = ""
    # local offline alternative to wandb: write TensorBoard event files
    # under <output_dir>/tb (--tensorboard; torch.utils.tensorboard)
    log_tensorboard: bool = False
    # Best-checkpoint selection (r8). The reference saves weights only on
    # a fixed cadence (UNI/main.py:153-154), so a run that later drifts
    # (the documented late Lagrangian drift — PARITY.md cars 500-episode
    # addendum, quadrotor levers) ships its post-drift weights. With a
    # metric set, the trailing-``save_best_window``-episode mean of that
    # per-episode metric is tracked once the window fills, and every new
    # maximum snapshots the weights to <output>/best/ (reference file
    # layout, loadable by --mode eval / load_model_weights) plus a
    # best.json provenance record. None = off (every preset default —
    # reference cadence semantics unchanged).
    save_best_metric: str | None = None  # "reward" | "goal_rate"
    save_best_window: int = 30
    # Ignore episodes < N for best-selection. Needed under spawn
    # curricula: trailing goal_rate saturates at 1.0 on the trivial
    # early spawns (measured: the quadrotor mix recipe's best.json
    # picked episode 43, mid-anneal), and later genuinely-hard perfect
    # windows can never strictly beat it. Set to the curriculum end to
    # select the best post-anneal policy.
    save_best_after: int = 0


@dataclass(frozen=True)
class NLBACConfig:
    env: EnvConfig = field(default_factory=EnvConfig)
    sac: SacConfig = field(default_factory=SacConfig)
    node: NodeConfig = field(default_factory=NodeConfig)
    constraint: ConstraintConfig = field(default_factory=ConstraintConfig)
    supervisor: SupervisorConfig = field(default_factory=SupervisorConfig)
    replay: ReplayConfig = field(default_factory=ReplayConfig)
    run: RunConfig = field(default_factory=RunConfig)
    # Device-mesh scale-out (seed-parallel 'seed' axis, batch-parallel
    # 'dp' psum) lives in nlbac_tpu.parallel and is configured at the
    # call site (mesh shape is a runtime property, not a run config) —
    # the honest successor to the reference's dead MPI layer
    # (UNI/utils/mpi_*.py).

    # Dims of the de-facto env API (SURVEY.md §1 L1 contract)
    obs_dim: int = 7
    action_dim: int = 2
    lyap_dim: int = 2  # dim of the Lyapunov-network input pair

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _unicycle() -> NLBACConfig:
    """Unicycle with pre-defined CBFs. README.md:43."""
    return NLBACConfig(
        env=EnvConfig(name="unicycle", dt=0.02, max_episode_steps=1200),
        sac=SacConfig(batch_size=128, updates_per_step=2, start_steps=1000),
        node=NodeConfig(form="control_affine", state_dim=3, action_dim=2),
        constraint=ConstraintConfig(
            kind="unicycle", gamma_b=50.0, gamma_l=1.0, clf_time_scaled=True,
            use_ratio=True, ratio_floor=0.0, lambda_max=400.0, horizon=1,
        ),
        supervisor=SupervisorConfig(
            kind="trap", trap_threshold=0.01, backup_max_steps=30,
            escape_distance_sq=0.6,
        ),
        replay=ReplayConfig(capacity=250_000, node_capacity=250_000),
        run=RunConfig(max_episodes=200, save_every_fraction=2,
                      exp_name="Node_LBAC_Unicycle"),
        obs_dim=7, action_dim=2, lyap_dim=2,
    )


def _cars() -> NLBACConfig:
    """Simulated car following. README.md:53."""
    return NLBACConfig(
        env=EnvConfig(name="cars", dt=0.02, max_episode_steps=300),
        sac=SacConfig(batch_size=256, updates_per_step=2, start_steps=200),
        node=NodeConfig(form="mlp", state_dim=10, action_dim=1,
                        hidden_dim=64, time_input=True),
        constraint=ConstraintConfig(
            kind="cars", gamma_b=0.5, gamma_l=0.15, clf_time_scaled=False,
            use_ratio=True, ratio_floor=0.002, lambda_max=300.0, horizon=2,
        ),
        supervisor=SupervisorConfig(kind="cars_gap", cars_gap=2.5,
                                    cars_backup_max_steps=15,
                                    cars_min_backup_steps=5),
        replay=ReplayConfig(capacity=70_000, node_capacity=70_000),
        run=RunConfig(max_episodes=200, save_every_fraction=6,
                      exp_name="Node_LBAC_Cars"),
        obs_dim=10, action_dim=1, lyap_dim=4,
    )


def _pvtol() -> NLBACConfig:
    """PVTOL with pre-defined CBFs. README.md:59."""
    return NLBACConfig(
        env=EnvConfig(name="pvtol", dt=0.02, max_episode_steps=2000),
        sac=SacConfig(batch_size=256, updates_per_step=1, start_steps=1000),
        node=NodeConfig(form="control_affine", state_dim=6, action_dim=2,
                        fit_episode_limit=100),
        constraint=ConstraintConfig(
            kind="pvtol", gamma_b=0.8, gamma_l=0.1, clf_time_scaled=False,
            use_ratio=True, ratio_floor=0.002, lambda_max=400.0, horizon=3,
            collision_buffer=1.2, backup_update_interval=20,
            separate_backup_rho=True,
        ),
        supervisor=SupervisorConfig(
            kind="pvtol", enable_after_episodes=3, trap_threshold=0.015,
            backup_max_steps=30, escape_distance_sq=1.0,
            rush_backup_max_steps=15, operator_dist=1.0,
        ),
        replay=ReplayConfig(capacity=850_000, node_capacity=850_000),
        run=RunConfig(max_episodes=400, save_every_fraction=2,
                      exp_name="Node_LBAC_Pvtol"),
        obs_dim=11, action_dim=2, lyap_dim=11,
    )


def _nbc_unicycle() -> NLBACConfig:
    """Unicycle with a learned neural barrier certificate. README.md:48."""
    base = _unicycle()
    return dataclasses.replace(
        base,
        env=dataclasses.replace(base.env, barrier_signals=True,
                                barrier_B=-20.0),
        constraint=ConstraintConfig(
            kind="learned_barrier", gamma_b=5.0, gamma_l=1.0,
            clf_time_scaled=True, use_ratio=False, lambda_max=400.0,
            horizon=1, use_backup=False,
        ),
        supervisor=SupervisorConfig(kind="none"),
        run=dataclasses.replace(base.run, exp_name="NBC_LBAC_Unicycle"),
    )


def _nbc_pvtol() -> NLBACConfig:
    """PVTOL with a learned neural barrier certificate. README.md:64."""
    base = _pvtol()
    return dataclasses.replace(
        base,
        env=dataclasses.replace(base.env, barrier_signals=True,
                                barrier_B=-0.1),
        constraint=ConstraintConfig(
            kind="learned_barrier", gamma_b=1.0, gamma_l=0.1,
            clf_time_scaled=False, use_ratio=True, ratio_floor=0.002,
            lambda_max=400.0, horizon=1, use_backup=False,
        ),
        supervisor=SupervisorConfig(kind="none"),
        run=dataclasses.replace(base.run, max_episodes=210,
                                exp_name="NBC_LBAC_Pvtol"),
    )


# The quadrotor env's NODE normalization scales (nlbac_tpu/envs/quadrotor.py
# STATE_SCALE / ACTION_SCALE, with HOVER_T = MASS * GRAVITY / 2 = 0.5 * 9.8 / 2).
_QUAD_HOVER_T = 0.5 * 9.8 / 2.0
_QUAD_STATE_SCALE = (2.0, 2.0, 2.0, 2.0, 1.0, 5.0)
_QUAD_ACTION_SCALE = (2.0 * _QUAD_HOVER_T, 2.0 * _QUAD_HOVER_T)


def _quadrotor() -> NLBACConfig:
    """2-D Quadrotor (safe-control-gym workload) with a learned barrier
    certificate and a normalized non-affine NODE. README.md:66-72,185-195;
    the reference's submodule for this workload is empty, so behavior
    follows the README's documentation (SURVEY.md §0)."""
    return NLBACConfig(
        env=EnvConfig(name="quadrotor", dt=0.02, max_episode_steps=1000,
                      barrier_signals=True,
                      # Terminal crash penalty: removes the 34-step
                      # dive-into-the-ground local optimum (crash return
                      # ~ -65 beats hovering ~ -190 under reward=-dist;
                      # PARITY.md "Quadrotor", lever 5).
                      kill_penalty=250.0),
        sac=SacConfig(batch_size=256, updates_per_step=1,
                      start_steps=1000,
                      # -dim(A) = -2 is calibrated for ~unit action
                      # scales; this env's +/-30%-hover range leaves
                      # useful policies permanently below it and alpha
                      # ratchets 0.2 -> 140. -6.0 bounds alpha ~2.5-5
                      # and, PAIRED with rho_max=50 below, is the only
                      # post-r5 configuration with durable take-off
                      # (levers 7+8, PARITY.md r5: TE=-4 dies with
                      # alpha~5-10, -8.0 under-explores).
                      target_entropy=-6.0),
        node=NodeConfig(form="mlp", state_dim=6, action_dim=2,
                        hidden_dim=100, mlp_hidden_layers=3,
                        normalize=True, state_scale=_QUAD_STATE_SCALE,
                        action_scale=_QUAD_ACTION_SCALE,
                        # Freeze NODE fits after ep 100 (the PVTOL-family
                        # recipe, PVTOL/sac_cbf_clf/sac_cbf_clf.py:205).
                        # Without the gate this workload shows Lagrangian
                        # collapse (PARITY.md); with it, goal 60/60 and
                        # zero violations over the final 60 episodes.
                        fit_episode_limit=100),
        constraint=ConstraintConfig(
            kind="learned_barrier", gamma_b=1.0, gamma_l=0.1,
            clf_time_scaled=False, use_ratio=True, ratio_floor=0.002,
            lambda_max=400.0, horizon=1, use_backup=True,
            # Lever 8 (PARITY.md r5): with the reference cap (200) the
            # quadratic rho*c^2 term comes to dominate the policy loss
            # and extinguishes goal-seeking — the instrumented run shows
            # goals surviving only while rho is in the 2.5-51 band.
            # 50 retains take-off; 20 under-enforces (goals die).
            rho_max=50.0,
        ),
        supervisor=SupervisorConfig(kind="trap", trap_threshold=0.005,
                                    backup_max_steps=30,
                                    escape_distance_sq=0.25),
        replay=ReplayConfig(capacity=210_000, node_capacity=210_000),
        run=RunConfig(max_episodes=210, save_every_fraction=2,
                      exp_name="NBC_LBAC_Quadrotor"),
        obs_dim=6, action_dim=2, lyap_dim=2,
    )


PRESETS = {
    "unicycle": _unicycle,
    "cars": _cars,
    "pvtol": _pvtol,
    "nbc_unicycle": _nbc_unicycle,
    "nbc_pvtol": _nbc_pvtol,
    "quadrotor": _quadrotor,
}


def get_config(name: str, **overrides: Any) -> NLBACConfig:
    """Build a preset config, optionally replacing top-level fields."""
    if name not in PRESETS:
        raise ValueError(f"unknown preset {name!r}; options: {list(PRESETS)}")
    cfg = PRESETS[name]()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
