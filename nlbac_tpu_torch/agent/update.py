"""The NLBAC update step (port of ``nlbac_tpu/agent/update.py``).

Per call, in the reference's order:

1. the NODE fit on a sample of the NODE buffer, every
   ``update_interval``-th update (the sample is drawn only then);
2. twin-Q TD and Lyapunov TD (and, for the learned-barrier family, barrier
   TD), each with its own Adam;
3. the primary policy loss: SAC term with the just-stepped critic plus
   the augmented-Lagrangian constraint term, whose NODE rollout runs the
   fused Euler kernel on the GPU, plus the optional pre-tanh regularizers
   on the batch and on the env's ground-probe batch;
4. the backup policy branch (CBF-only constraints, shared or separate rho);
5. both entropy temperatures;
6. soft target updates.

The gates (``lax.cond`` in the reference) read the host-side update
counter ``ts.updates``, so no gate waits for the device. Parameters and
optimizer state are updated in place; ``update_core`` returns the same
``TrainState`` and a dict of 0-d device tensors.

``update`` samples both replays on the device; ``update_presampled``
takes an RL batch sampled elsewhere (the host loop's native ring);
``update_from_batch`` takes both batches whole (the data-parallel entry
point of ``parallel.make_dp_update``).

Data parallelism (``make_agent(dp_group=...)``): each rank of a dp group
runs the update on its own rows of the batch, ``rows(n)``. Every draw is
made whole from the rank's generator and cut to those rows (the replay
indices, each policy sample's standard normal, the chain's resamples),
so the generator's stream stays the same on every rank and in a run of
one. JAX's GSPMD makes every batch reduction global by itself; here each
is written out, named where it happens:

- the means (the TD and NODE-fit MSEs, the policy and backup SAC terms,
  the pre-tanh regularizer) are the local sum over the global count
  (``mean``), and the group sums each optimizer group's gradients in one
  flat bucket (``step``);
- the constraint means feed a loss that is nonlinear in them, so they
  are summed over the group inside the forward pass (``filtered_means``'s
  ``reduce``), with the gradient passed through unchanged;
- the entropy errors are summed over the group, so each temperature
  steps on the global mean and needs no gradient sum; so are the
  metrics that are batch means.

Parameters, Adam moments, the multipliers, rho and the counters stay the
same on every rank of the group.

Seeds in lockstep (a state stacked over seeds, ``agent.state.
stack_states``; the runner is ``parallel/lockstep.py``): the same code
runs with a leading (S,) axis on every tensor, each network layer one
batched product for every seed. A batch quantity is (B, k) for one seed
and (S, B, k) stacked, so a batch mean is per seed, and what is
differentiated is the sum of the seeds' losses, so that each seed's
gradient is its one-seed gradient. The vmap's selects take the place of
the host gates:

- the seeds that update at all (``seeds``) and each gate (the fit, the
  ascent, the backup branch, the target update) are per-seed host lists
  read off the per-seed counters ``ts.updates``;
- a gated section runs for every seed when any seed's gate is on, and
  commits only for those: each ``SeedAdam`` steps the seeds of its mask,
  the targets and the multipliers are selected per seed, and a seed
  whose gate is off keeps its parameters, moments, step counts and
  multipliers bit for bit;
- each draw is made seed by seed from the seed's own generator, with
  the shape the one-seed path draws and only for the seeds whose gate is
  on (``sample_seeds``, ``draw_normal``), then stacked, so that each
  seed's stream follows its one-seed run's;
- the metrics are (S,) tensors.

The probe regularizer's batch is one for every seed, each seed's policy
taking its own term. Under dopri5 each seed takes its own adaptive steps
(``nn.predict_next_state``), and ``short_integrations`` counts, per seed,
the integrations that ended short among the calls whose gate the seed
had on (the rollouts of the updating seeds, the fit of the fitting ones,
the backup branch's of the seeds that take it). A constraint builder that
does not declare ``SEED_AXIS`` is called once per seed on that seed's
slices (``seed_terms``), and its (B, K) terms are stacked. Data
parallelism and the decoupled variant take no stacked state: JAX's
lockstep runner (``nlbac_tpu/parallel/mesh.py``'s
``make_seed_parallel_runner``) builds neither.
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from nlbac_tpu_torch import replay as replay_lib
from nlbac_tpu_torch import resolve_device
from nlbac_tpu_torch.agent.state import TrainState
from nlbac_tpu_torch.config import NLBACConfig
from nlbac_tpu_torch.constraints import LagrangianState
from nlbac_tpu_torch.constraints import backup_loss as lag_backup_loss
from nlbac_tpu_torch.constraints import get_builder, uses_barrier
from nlbac_tpu_torch.constraints import primary_loss as lag_primary_loss
from nlbac_tpu_torch.envs import get_env
from nlbac_tpu_torch.nn import (
    DEFAULT_SQUASH,
    ActionSpec,
    apply_grads,
    barrier_apply,
    deterministic_policy_sample,
    gaussian_policy_forward,
    gaussian_policy_sample,
    lyapunov_apply,
    make_field,
    node_loss,
    seed_mean,
    soft_update,
    twin_q_apply,
)
from nlbac_tpu_torch.nn.adam import SeedAdam
from nlbac_tpu_torch.nn.xla_float import squash_tanh
from nlbac_tpu_torch.tree import (
    SeedMasks,
    detach,
    snapshot,
    tree_leaves,
    tree_map,
    where_seeds,
)

METRIC_NAMES = ("qf1_loss", "qf2_loss", "lf_loss", "policy_loss",
                "constraint_loss", "alpha_loss", "alpha", "node_loss",
                "barrier_td_loss", "rho", "lam_max")


# The injected draws that hold one (B, action_dim) draw per chain step
RESAMPLE_DRAWS = ("resample", "backup_resample")
# The metrics that are batch means: a data-parallel rank's are its share
METRIC_MEANS = ("qf1_loss", "qf2_loss", "lf_loss", "policy_loss",
                "node_loss", "barrier_td_loss")


class Agent(NamedTuple):
    """Config plus the update's functions (closures over it)."""

    cfg: NLBACConfig
    select_action: Callable
    update: Callable
    update_presampled: Callable
    update_core: Callable
    update_from_batch: Callable
    node_fit: Callable
    squash: str = DEFAULT_SQUASH


def make_agent(cfg: NLBACConfig, device="cuda", env_override=None,
               dp_group=None, _decoupled_updates: bool = False,
               squash: str = DEFAULT_SQUASH) -> Agent:
    """``env_override`` stands in for the registry's env (a host-env
    adapter, ``envs.host_adapter``): it exposes ``SPEC`` and, where its obs
    is not the NODE state, ``obs_to_state``. ``dp_group`` (a
    ``parallel.mesh.Comm``) runs each update on this rank's rows of the
    batch, as the module's note sets out. ``squash`` is the policy's tanh
    (``nn.xla_float.SQUASHES``): ``"xla"`` for XLA's CPU tanh (the
    default, ``nn.DEFAULT_SQUASH``), or ``"torch"`` for ``torch.tanh``; not
    a config field, so that the config stays the JAX package's.

    ``_decoupled_updates`` is an experimental variant reachable only
    through ``nlbac_tpu_torch.experimental.make_decoupled_agent``: the
    policy losses read the critic, Lyapunov net, barrier and NODE as they
    were before the update stepped them."""
    squash_tanh(squash)  # refuses an unknown squash
    env = env_override if env_override is not None else \
        get_env(cfg.env.name)
    builder = get_builder(cfg.constraint.kind)
    ccfg, ncfg, scfg = cfg.constraint, cfg.node, cfg.sac
    device = resolve_device(device)
    field = make_field(ncfg)
    spec = ActionSpec.from_bounds(env.SPEC.action_low, env.SPEC.action_high,
                                  device)
    dt = cfg.env.dt
    target_entropy = (-float(cfg.action_dim) if scfg.target_entropy is None
                      else float(scfg.target_entropy))
    is_nbc = uses_barrier(ccfg.kind)
    is_gaussian = scfg.policy_type != "deterministic"
    entropy_tuning = scfg.automatic_entropy_tuning and is_gaussian
    pretanh_reg, probe_pretanh_reg = scfg.pretanh_reg, scfg.probe_pretanh_reg
    if pretanh_reg and not is_gaussian:
        raise ValueError(
            f"pretanh_reg={pretanh_reg} requires the Gaussian policy "
            "(the deterministic head has no pre-tanh Gaussian mean to "
            "regularize)")
    probe_obs = None
    if probe_pretanh_reg:
        if not is_gaussian:
            raise ValueError(
                f"probe_pretanh_reg={probe_pretanh_reg} requires the "
                "Gaussian policy (no pre-tanh mean to regularize)")
        if not hasattr(env, "ground_probe_obs"):
            raise ValueError(
                f"probe_pretanh_reg={probe_pretanh_reg} requires an env "
                f"exposing ground_probe_obs(); {cfg.env.name!r} does not "
                "(quadrotor only)")
        probe_obs = env.ground_probe_obs(device)
    sample_policy = (gaussian_policy_sample if is_gaussian
                     else deterministic_policy_sample)
    n_dp = 1 if dp_group is None else dp_group.size
    for name, n in (("sac.batch_size", scfg.batch_size),
                    ("node.max_batch", ncfg.max_batch)):
        if n % n_dp:
            raise ValueError(f"--dp {n_dp} requires cfg.{name} ({n}) to be "
                             "divisible by the dp width")

    def rows(n: int):
        """This rank's rows of an ``n``-row batch (None: all of them)."""
        if dp_group is None:
            return None
        k = n // n_dp
        return slice(dp_group.index * k, (dp_group.index + 1) * k)

    def sample_fn(params, obs_b, gen, noise=None):
        return sample_policy(params, obs_b, spec, gen=gen, noise=noise,
                             squash=squash)

    def batch_sample_fn(params, obs_b, gen, noise=None, on=None):
        """``sample_fn`` over this rank's rows of the batch: under dp a
        standard normal not given is drawn for the whole batch and cut to
        the rows. Stacked over seeds, ``gen`` is the seeds' generators and
        a draw not given is made for the seeds in ``on``."""
        if isinstance(gen, list) and noise is None:
            noise = draw_normal(gen, (obs_b.shape[-2], cfg.action_dim), on)
        elif dp_group is not None and noise is None:
            n = obs_b.shape[0] * n_dp
            noise = torch.randn((n, cfg.action_dim), generator=gen,
                                device=obs_b.device,
                                dtype=obs_b.dtype)[rows(n)]
        return sample_fn(params, obs_b, gen, noise)

    def mean(x):
        """A batch mean of (B, k): under dp the rank's local sum over the
        global count, so that the group's sum is the global mean; of (S,
        B, k), stacked over seeds, each seed's (S,)."""
        if x.dim() == 3:
            return seed_mean(x)
        if dp_group is None:
            return torch.mean(x)
        return torch.sum(x) / (x.numel() * n_dp)

    def global_mean(x):
        """A batch mean that every rank needs whole, without a gradient
        (the entropy errors): summed over the dp group; per seed for (S,
        B, k)."""
        if x.dim() == 3:
            return seed_mean(x)
        if dp_group is None:
            return torch.mean(x)
        return dp_group.all_reduce(torch.sum(x)) / (x.numel() * n_dp)

    def mse(a, b):
        return mean(torch.square(a - b))

    def step(optimizer, params, loss, batch_loss: bool = True,
             gate=None) -> None:
        """One optimizer step of ``params`` on ``loss``. Under dp a
        ``batch_loss`` (a rank's share of a batch mean) has its gradients
        summed over the group, in one flat bucket per optimizer group.
        Stacked over seeds, the seeds' (S,) losses are summed and the
        ``SeedAdam`` steps the seeds of the host list ``gate``."""
        if isinstance(optimizer, SeedAdam):
            optimizer.step(torch.autograd.grad(loss.sum(),
                                               tree_leaves(params)),
                           mask_of(gate))
            return
        grads = torch.autograd.grad(loss, tree_leaves(params))
        if dp_group is not None and batch_loss:
            grads = dp_group.sum_flat(list(grads))
        apply_grads(optimizer, params, grads)

    reduce_means = None if dp_group is None else dp_group.sum_fwd

    action_low = torch.tensor(env.SPEC.action_low, dtype=torch.float32,
                              device=device)
    action_high = torch.tensor(env.SPEC.action_high, dtype=torch.float32,
                               device=device)
    # obs -> NODE-state adapter: PVTOL's NODE sees the 6-d dynamics
    # state, without the operator; a host env without one feeds its obs
    if env_override is None and cfg.env.name == "pvtol":
        obs_to_node_state = env.obs_to_dynamics_state
    elif hasattr(env, "obs_to_state"):
        obs_to_node_state = env.obs_to_state
    else:
        def obs_to_node_state(obs):
            return obs

    def zero(seeds=None):
        shape = () if seeds is None else (seeds,)
        return torch.zeros(shape, dtype=torch.float32, device=device)

    # --- seeds in lockstep: masks and draws -----------------------------
    seed_mask = SeedMasks(device)

    def mask_of(on):
        """None when every seed of ``on`` holds (nothing to select), else
        its mask."""
        return None if on is None or all(on) else seed_mask(on)

    def flag(gate):
        """A gate as the constraint functions take it: a host bool for one
        seed, or where the seeds differ a (S,) mask."""
        if not isinstance(gate, list):
            return gate
        if all(gate) or not any(gate):
            return all(gate)
        return seed_mask(gate)

    def select(gate, new, old):
        """``new`` for the seeds of ``gate`` (a host list), ``old`` for the
        others (one seed: ``new``)."""
        m = mask_of(gate) if isinstance(gate, list) else None
        return new if m is None else where_seeds(m, new, old)

    def draw_normal(gens, shape, on):
        """Each seed's standard-normal draw of ``shape`` from its own
        generator for the seeds in ``on`` (zeros for the others), as the
        one-seed path draws it, stacked: (S,) + shape."""
        return torch.stack([
            torch.randn(shape, generator=g, device=device) if o else
            torch.zeros(shape, device=device)
            for g, o in zip(gens, on)])

    def stale_alpha(log_alpha, n_upd):
        """Each seed's temperature for its update (alpha_init on its first
        update), shaped (S, 1, 1) to scale (S, B, 1)."""
        first = seed_mask([n == 0 for n in n_upd])
        return torch.where(first, scfg.alpha_init,
                           torch.exp(log_alpha.detach()[:, 0]))[:, None, None]

    # ------------------------------------------------------------------
    def select_action(ts: TrainState, obs, gen, warmup: bool, use_backup,
                      seeds=None):
        """obs: (obs_dim,). ``warmup`` is a host bool; ``use_backup`` a
        device bool. Stacked over seeds: obs (S, obs_dim), ``gen`` the
        seeds' generators, ``warmup`` a per-seed host list, ``use_backup``
        (S,), and ``seeds`` the seeds that act (the others draw nothing;
        default all)."""
        if ts.seeds is not None:
            return select_seed_actions(ts, obs, gen, warmup, use_backup,
                                       seeds)
        if warmup:
            u = torch.rand((cfg.action_dim,), generator=gen, device=device)
            return action_low + u * (action_high - action_low)
        with torch.no_grad():
            obs_b = obs[None, :]
            a, _, _ = sample_fn(ts.policy, obs_b, gen)
            if ccfg.use_backup:
                a_bak, _, _ = sample_fn(ts.backup_policy, obs_b, gen)
                a = torch.where(use_backup, a_bak, a)
        return a[0]

    def select_seed_actions(ts, obs, gens, warmup, use_backup, seeds):
        """``select_action`` for a state stacked over seeds: each acting
        seed draws from its own generator what the one-seed path draws
        (the uniform warm-up action, or the policy's and then the backup
        policy's standard normal), and one batched forward serves every
        seed."""
        n = ts.seeds
        seeds = [True] * n if seeds is None else seeds
        warm = [o and w for o, w in zip(seeds, warmup)]
        acting = [o and not w for o, w in zip(seeds, warmup)]
        action = torch.zeros((n, cfg.action_dim), device=device)
        if any(acting):
            shape = (1, cfg.action_dim)
            draws = [[], []]
            for g, o in zip(gens, acting):
                for k in range(2 if ccfg.use_backup else 1):
                    draws[k].append(torch.randn(shape, generator=g,
                                                device=device) if o else
                                    torch.zeros(shape, device=device))
            with torch.no_grad():
                obs_b = obs[:, None, :]
                a, _, _ = sample_fn(ts.policy, obs_b, None,
                                    torch.stack(draws[0]))
                if ccfg.use_backup:
                    a_bak, _, _ = sample_fn(ts.backup_policy, obs_b, None,
                                            torch.stack(draws[1]))
                    a = torch.where(use_backup[:, None, None], a_bak, a)
            action = a[:, 0]
        if any(warm):
            u = torch.stack([
                torch.rand((cfg.action_dim,), generator=g, device=device)
                if w else torch.zeros((cfg.action_dim,), device=device)
                for g, w in zip(gens, warm)])
            action = select(warm, action_low + u * (action_high - action_low),
                            action)
        return action

    # ------------------------------------------------------------------
    def node_fit_batch(node_params, node_opt, batch, shorts=None,
                       gate=None):
        x = obs_to_node_state(batch["obs"])
        x_next = obs_to_node_state(batch["next_obs"])
        t = batch["t"][..., None] if ncfg.time_input else None
        loss = node_loss(ncfg, node_params, x, batch["action"], x_next, dt,
                         t=t, field=field, shorts=shorts, mean=mean,
                         dp_group=dp_group)
        step(node_opt, node_params, loss, gate=gate)
        return loss.detach()

    def node_fit(node_params, node_opt, node_replay, gen):
        """Fit on ``max_batch`` rows drawn from the whole buffer."""
        batch = replay_lib.sample(node_replay, gen, ncfg.max_batch,
                                  rows(ncfg.max_batch))
        return node_fit_batch(node_params, node_opt, batch)

    # ------------------------------------------------------------------
    def update(ts: TrainState, rl_replay, node_replay, gen, i_episode: int,
               seeds=None) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """Sample the RL buffer, then ``update_presampled``. Stacked over
        seeds (``SeedReplay`` rings, ``gen`` the seeds' generators), the
        seeds in ``seeds`` (a host list; default all) sample and update,
        each from its own ring and generator."""
        if ts.seeds is not None:
            on = active(ts, seeds)
            batch = replay_lib.sample_seeds(rl_replay, gen, scfg.batch_size,
                                            on)
            return update_core(
                ts, batch,
                lambda fit: replay_lib.sample_seeds(node_replay, gen,
                                                    ncfg.max_batch, fit),
                gen, i_episode, seeds=on)
        batch = replay_lib.sample(rl_replay, gen, scfg.batch_size,
                                  rows(scfg.batch_size))
        return update_presampled(ts, batch, node_replay, gen, i_episode)

    def update_presampled(ts: TrainState, batch, node_replay, gen,
                          i_episode: int
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The update over an RL batch sampled elsewhere (by ``update``, or
        from the host loop's native ring); the NODE sample is drawn from
        ``node_replay`` only when the fit is gated on."""
        return update_core(
            ts, batch,
            lambda: replay_lib.sample(node_replay, gen, ncfg.max_batch,
                                      rows(ncfg.max_batch)),
            gen, i_episode)

    def update_from_batch(ts: TrainState, batch, node_batch, gen,
                          i_episode: int, noise: Optional[dict] = None
                          ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """The update over whole pre-sampled batches (the dp entry point):
        under dp this rank keeps its rows of both batches and of any
        injected draws (``noise``, as ``update_core`` takes them). Stacked
        over seeds, the batches and draws carry a leading seed axis."""
        if dp_group is not None:
            batch = {k: v[rows(v.shape[0])] for k, v in batch.items()}
            node_batch = {k: v[rows(v.shape[0])]
                          for k, v in node_batch.items()}
            if noise is not None:
                # a sample's draw is (B, n_u); the chain's resamples hold
                # one such draw per step
                noise = {k: ([d[rows(d.shape[0])] for d in v]
                             if k in RESAMPLE_DRAWS
                             else v[rows(v.shape[0])])
                         for k, v in noise.items()}
        return update_core(ts, batch, lambda *_: node_batch, gen, i_episode,
                           noise=noise)

    def active(ts: TrainState, seeds):
        """The seeds that update: the host list ``seeds``, by default all
        of a stacked state's."""
        return [True] * ts.seeds if seeds is None else [bool(o) for o in
                                                         seeds]

    def update_core(ts: TrainState, batch, node_batch_thunk, gen,
                    i_episode: int, noise: Optional[dict] = None,
                    seeds=None
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One update over ``batch``. ``noise`` may hold the
        standard-normal draws for the samples ("next" for the TD targets
        of the critic and the barrier, "pi" for the policy loss, "backup"
        for the backup loss, and "resample"/"backup_resample" for the
        constraint chain's resampled controls, one (B, action_dim) draw
        per resampling step, in the primary and backup loss); the rest are
        drawn from ``gen``. Its metrics hold, besides ``METRIC_NAMES``,
        ``short_integrations``: how many of its adaptive NODE
        integrations ended short of their span. Under dp, ``batch`` holds
        this rank's rows and ``noise`` their draws.

        Stacked over seeds (the module's note): ``gen`` is the seeds'
        generators, ``seeds`` the host list of the seeds that update (the
        others keep their state bit for bit; default all), and
        ``node_batch_thunk(fit)`` takes the list of the seeds that fit."""
        noise = noise or {}
        shorts = []  # predict_next_state's ended-short flags
        counted = []  # the flags counted so far, each masked to its gate
        n_seeds = ts.seeds
        if n_seeds is not None and (dp_group is not None or
                                    _decoupled_updates):
            raise ValueError(
                "a state stacked over seeds takes no data parallelism or "
                "decoupled updates (JAX's lockstep runner has neither; not "
                "queued)")
        obs, action = batch["obs"], batch["action"]
        if obs.shape[-2] * n_dp != scfg.batch_size:
            raise ValueError(
                f"batch has {obs.shape[-2]} rows but cfg.sac.batch_size="
                f"{scfg.batch_size}"
                + (f" over {n_dp} dp ranks" if n_dp > 1 else "")
                + "; constraint means are normalized by the configured "
                "size, so they must match")
        reward = batch["reward"][..., None]
        constraint = batch["constraint"][..., None]
        mask = batch["mask"][..., None]
        n_upd = ts.updates
        on = None if n_seeds is None else active(ts, seeds)

        def gate(pred):
            """``pred(updates)`` as a host bool, or stacked over seeds as a
            host list over the updating seeds."""
            if n_seeds is None:
                return pred(n_upd)
            return [o and pred(n) for o, n in zip(on, n_upd)]

        def any_on(g):
            return any(g) if isinstance(g, list) else g

        def tally(g):
            """Count the ended-short flags the calls since the last tally
            appended, for the seeds of the gate ``g`` (one seed: each)."""
            m = mask_of(g) if isinstance(g, list) else None
            counted.extend(f.to(torch.int64) if m is None
                           else f.to(torch.int64) * m for f in shorts)
            shorts.clear()

        if _decoupled_updates:
            # copies: the steps below update the parameters in place
            pre = {name: snapshot(getattr(ts, name))
                   for name in ("critic", "lyap", "barrier", "node")}

        # --- 1. NODE fit (gated) ----------------------------------------
        limit = ncfg.fit_episode_limit
        do_node = gate(lambda n: n % ncfg.update_interval == 0 and
                       (limit is None or i_episode <= limit))
        if any_on(do_node):
            node_batch = (node_batch_thunk() if n_seeds is None
                          else node_batch_thunk(do_node))
            node_fit_loss = select(do_node, node_fit_batch(
                ts.node, ts.opt["node"], node_batch, shorts, do_node),
                zero(n_seeds))
            tally(do_node)
        else:
            node_fit_loss = zero(n_seeds)

        # --- 2. critic / Lyapunov TD --------------------------------------
        # Stale-alpha rule: the first update uses alpha_init, later ones
        # the temperature left by the previous update.
        if not is_gaussian:
            alpha = 0.0
        elif n_seeds is not None:
            alpha = stale_alpha(ts.log_alpha, n_upd)
        elif n_upd == 0:
            alpha = scfg.alpha_init
        else:
            alpha = torch.exp(ts.log_alpha.detach()[0])
        with torch.no_grad():
            next_a, next_logp, _ = batch_sample_fn(
                ts.policy, batch["next_obs"], gen, noise.get("next"), on)
            q1_t, q2_t = twin_q_apply(ts.critic_target, batch["next_obs"],
                                      next_a)
            min_q_t = torch.minimum(q1_t, q2_t) - alpha * next_logp
            next_q = reward + mask * scfg.gamma * min_q_t
            lf_t = lyapunov_apply(ts.lyap_target, batch["lyap_t1"])
            next_l = constraint + mask * scfg.gamma * lf_t

        q1, q2 = twin_q_apply(ts.critic, obs, action)
        qf1_loss, qf2_loss = mse(q1, next_q), mse(q2, next_q)
        step(ts.opt["critic"], ts.critic, qf1_loss + qf2_loss, gate=on)

        lf_loss = mse(lyapunov_apply(ts.lyap, batch["lyap_t"]), next_l)
        step(ts.opt["lyap"], ts.lyap, lf_loss, gate=on)

        barrier_td_loss = zero(n_seeds)
        if is_nbc:
            # the barrier's TD target takes the critic's next action
            with torch.no_grad():
                b_next = barrier_apply(ts.barrier_target, batch["next_obs"],
                                       next_a)
                next_b = (batch["barrier_signal"][..., None]
                          + mask * scfg.gamma * b_next)
            b_loss = mse(barrier_apply(ts.barrier, obs, action), next_b)
            step(ts.opt["barrier"], ts.barrier, b_loss, gate=on)
            barrier_td_loss = b_loss.detach()

        # The policy losses see the stepped critic, Lyapunov net, barrier
        # and NODE without differentiating them (gradients go to the policy
        # only); the decoupled variant sees them as they were before.
        if _decoupled_updates:
            pg_critic, pg_lyap, pg_barrier, pg_node = (
                pre["critic"], pre["lyap"], pre["barrier"], pre["node"])
        else:
            pg_critic, pg_lyap, pg_barrier, pg_node = (
                detach(ts.critic), detach(ts.lyap), detach(ts.barrier),
                detach(ts.node))

        # --- 3. primary policy ------------------------------------------
        lag_live = True
        if ccfg.lagrangian_warmup_episodes > 0:
            lag_live = i_episode >= ccfg.lagrangian_warmup_episodes
        do_lam = gate(lambda n: n % ccfg.lambda_update_interval == 0 and
                      lag_live)
        term_kwargs = dict(ccfg=ccfg, ncfg=ncfg, node_params=pg_node,
                           field=field, lyap_params=pg_lyap,
                           lyap_t=batch["lyap_t"], dt=dt, gen=gen,
                           t=batch["t"][..., None],
                           next_t=batch["next_t"][..., None],
                           env_name=cfg.env.name,
                           barrier_params=pg_barrier,
                           shorts=shorts, dp_group=dp_group)

        def make_resampler(policy, draws, on_k):
            """The chain's k-th resampled control, from the policy being
            optimized; it carries no gradient."""
            def resample(obs_k, k):
                with torch.no_grad():
                    a, _, _ = batch_sample_fn(
                        policy, obs_k, gen,
                        None if draws is None else draws[k], on_k)
                return a
            return resample

        def seed_resampler(policy, draws, on_k, i):
            """Seed i's ``make_resampler`` for a one-seed call: its policy
            slice, draws and generator; zeros for a seed whose gate is off,
            as ``draw_normal`` gives it."""
            def resample(obs_k, k):
                d = None if draws is None else draws[k][i]
                if d is None and not on_k[i]:
                    d = torch.zeros(obs_k.shape[:-1] + (cfg.action_dim,),
                                    device=device)
                with torch.no_grad():
                    a, _, _ = sample_fn(policy, obs_k,
                                        None if gen is None else gen[i], d)
                return a
            return resample

        def constraint_terms(obs_, action_, include_clf, policy, draws, on_k):
            """``builder.terms``: one call, seed-batched for a builder that
            declares ``SEED_AXIS`` (or for one seed), else ``seed_terms``."""
            if n_seeds is None or getattr(builder, "SEED_AXIS", False):
                return builder.terms(
                    obs=obs_, action=action_, include_clf=include_clf,
                    resample=make_resampler(policy, draws, on_k),
                    **term_kwargs)
            return seed_terms(obs_, action_, include_clf, policy, draws,
                              on_k)

        def seed_terms(obs_, action_, include_clf, policy, draws, on_k):
            """A builder written for one seed's (B, .) rows, called once per
            seed on that seed's slices (obs, action, the networks, the
            times, its generator and resampler), its (B, K) terms stacked
            to (S, B, K), as ``jax.vmap`` computes them; each seed's
            ended-short flags are summed into one (S,) count."""
            out, flags = [], []
            for i in range(n_seeds):
                own = []
                kw = dict(term_kwargs, gen=None if gen is None else gen[i],
                          shorts=own)
                for k in ("node_params", "lyap_params", "barrier_params",
                          "lyap_t", "t", "next_t"):
                    if kw[k] is not None:
                        kw[k] = tree_map(lambda v: v[i], kw[k])
                out.append(builder.terms(
                    obs=obs_[i], action=action_[i], include_clf=include_clf,
                    resample=seed_resampler(
                        tree_map(lambda v: v[i], policy), draws, on_k, i),
                    **kw))
                flags.append(own)
            if any(flags):
                shorts.append(torch.stack([
                    torch.stack(f).sum() if f else
                    torch.zeros((), dtype=torch.int64, device=device)
                    for f in flags]))
            return torch.stack(out)

        pi, logp, _ = batch_sample_fn(ts.policy, obs, gen, noise.get("pi"),
                                      on)
        pq1, pq2 = twin_q_apply(pg_critic, obs, pi)
        policy_loss_1 = mean(alpha * logp - torch.minimum(pq1, pq2))
        terms = constraint_terms(obs, pi, True, ts.policy,
                                 noise.get("resample"), on)
        tally(on)
        policy_loss_2, lam_new, rho1 = lag_primary_loss(
            ccfg, terms, ts.lag.lam, ts.lag.rho, flag(do_lam),
            scfg.batch_size, do_rho_growth=lag_live, reduce=reduce_means)
        loss = policy_loss_1 + policy_loss_2
        if pretanh_reg:
            mu, _ = gaussian_policy_forward(ts.policy, obs)
            loss = loss + pretanh_reg * mean(torch.square(mu))
        if probe_pretanh_reg and n_seeds is not None:
            # one probe batch for every seed, each through its own policy
            mu_p, _ = gaussian_policy_forward(
                ts.policy, probe_obs.expand((n_seeds,) + probe_obs.shape))
            loss = loss + probe_pretanh_reg * seed_mean(torch.square(mu_p))
        elif probe_pretanh_reg:
            # the probe batch is the same on every rank: each takes
            # 1/n_dp of its term, so the group's gradient sum is whole
            mu_p, _ = gaussian_policy_forward(ts.policy, probe_obs)
            loss = loss + probe_pretanh_reg * torch.mean(
                torch.square(mu_p)) / n_dp
        step(ts.opt["policy"], ts.policy, loss, gate=on)
        logp = logp.detach()

        # --- 4. backup policy branch --------------------------------------
        backup_lam = ts.lag.backup_lam
        if ccfg.use_backup:
            backup_rho_out = (ts.lag.backup_rho if ccfg.separate_backup_rho
                              else rho1)
            do_backup = gate(lambda n: ccfg.backup_update_interval <= 1
                             or n % ccfg.backup_update_interval == 0)
            if any_on(do_backup):
                if not is_gaussian:
                    backup_alpha = 0.0
                elif n_seeds is not None:
                    backup_alpha = stale_alpha(ts.backup_log_alpha, n_upd)
                elif n_upd == 0:
                    backup_alpha = scfg.alpha_init
                else:
                    backup_alpha = torch.exp(ts.backup_log_alpha.detach()[0])
                bpi, blogp, _ = batch_sample_fn(ts.backup_policy, obs, gen,
                                                noise.get("backup"),
                                                do_backup)
                bq1, bq2 = twin_q_apply(pg_critic, obs, bpi)
                bloss1 = mean(backup_alpha * blogp
                              - torch.minimum(bq1, bq2))
                bterms = constraint_terms(obs, bpi, False,
                                          ts.backup_policy,
                                          noise.get("backup_resample"),
                                          do_backup)
                tally(do_backup)
                bloss2, new_lam, new_rho = lag_backup_loss(
                    ccfg, bterms, backup_lam, backup_rho_out, flag(do_lam),
                    scfg.batch_size, do_rho_growth=lag_live,
                    reduce=reduce_means)
                backup_lam = select(do_backup, new_lam, backup_lam)
                backup_rho_out = select(do_backup, new_rho, backup_rho_out)
                step(ts.opt["backup_policy"], ts.backup_policy,
                     bloss1 + bloss2, gate=do_backup)
                if entropy_tuning:
                    ent_err = global_mean(blogp.detach()) + target_entropy
                    step(ts.opt["backup_alpha"], ts.backup_log_alpha,
                         -(ts.backup_log_alpha[..., 0] * ent_err),
                         batch_loss=False, gate=do_backup)
            if ccfg.separate_backup_rho:
                rho_final, backup_rho_final = rho1, backup_rho_out
            else:
                rho_final, backup_rho_final = backup_rho_out, \
                    ts.lag.backup_rho
        else:
            rho_final, backup_rho_final = rho1, ts.lag.backup_rho

        # --- 5. primary entropy temperature -------------------------------
        alpha_loss = zero(n_seeds)
        if entropy_tuning:
            ent_err = global_mean(logp) + target_entropy
            a_loss = -(ts.log_alpha[..., 0] * ent_err)
            alpha_loss = a_loss.detach()
            step(ts.opt["alpha"], ts.log_alpha, a_loss, batch_loss=False,
                 gate=on)

        # --- 6. soft target updates ---------------------------------------
        do_target = gate(lambda n: scfg.target_update_interval <= 1 or
                         n % scfg.target_update_interval == 0)
        if any_on(do_target):
            m_target = mask_of(do_target) if n_seeds is not None else None
            soft_update(ts.critic_target, ts.critic, scfg.tau, m_target)
            soft_update(ts.lyap_target, ts.lyap, scfg.tau, m_target)
            if is_nbc:
                soft_update(ts.barrier_target, ts.barrier, scfg.tau,
                            m_target)

        lag = LagrangianState(lam=lam_new.detach(),
                              backup_lam=backup_lam.detach(),
                              rho=rho_final, backup_rho=backup_rho_final)
        if n_seeds is None:
            ts.lag, ts.updates = lag, n_upd + 1
        else:
            # a seed that does not update keeps its multipliers and rho
            ts.lag = LagrangianState(*(select(on, new, old)
                                       for new, old in zip(lag, ts.lag)))
            ts.updates = [n + int(o) for n, o in zip(n_upd, on)]
        metrics = {
            "qf1_loss": qf1_loss.detach(), "qf2_loss": qf2_loss.detach(),
            "lf_loss": lf_loss.detach(),
            "policy_loss": policy_loss_1.detach(),
            "constraint_loss": policy_loss_2.detach(),
            "alpha_loss": alpha_loss,
            "alpha": (torch.exp(ts.log_alpha.detach()[..., 0])
                      if is_gaussian else zero(n_seeds)),
            "node_loss": node_fit_loss, "barrier_td_loss": barrier_td_loss,
            "rho": rho_final,
            "lam_max": (torch.max(lam_new.detach()) if n_seeds is None else
                        torch.amax(lam_new.detach(), dim=-1)),
            "short_integrations": (
                torch.stack(counted).sum(0) if counted else
                torch.zeros(() if n_seeds is None else (n_seeds,),
                            dtype=torch.int64, device=device)),
        }
        if dp_group is not None:
            # the batch-mean metrics are each rank's share: one sum
            summed = dp_group.all_reduce(
                torch.stack([metrics[k] for k in METRIC_MEANS]))
            metrics.update(zip(METRIC_MEANS, summed.unbind()))
        return ts, metrics

    return Agent(cfg=cfg, select_action=select_action, update=update,
                 update_presampled=update_presampled,
                 update_core=update_core,
                 update_from_batch=update_from_batch, node_fit=node_fit,
                 squash=squash)
