"""Policies: tanh-squashed Gaussian (reparameterized) and deterministic
(port of ``nlbac_tpu/nn/policy.py``).

Sampling takes an explicit ``torch.Generator``, or the standard-normal
draws themselves (``noise``) so that a test can feed the reference's.
``squash`` picks the tanh of every squash here: ``"xla"`` (XLA's CPU tanh,
``nn/xla_float.py``; ``DEFAULT_SQUASH``) or ``"torch"`` (``torch.tanh``)."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from nlbac_tpu_torch.nn.mlp import mlp_apply, mlp_init, xavier_uniform
from nlbac_tpu_torch.nn.xla_float import squash_tanh

# The policy's squash wherever none is asked for: XLA's CPU tanh, as the
# JAX package computes it (``--squash torch`` gives ``torch.tanh``)
DEFAULT_SQUASH = "xla"

LOG_SIG_MAX = 2.0
LOG_SIG_MIN = -20.0
EPS = 1e-6


class ActionSpec(NamedTuple):
    """Affine map from tanh-space to env action space."""

    scale: torch.Tensor  # (action_dim,) = (high - low) / 2
    bias: torch.Tensor  # (action_dim,) = (high + low) / 2

    @staticmethod
    def from_bounds(low, high, device=None) -> "ActionSpec":
        low = torch.as_tensor(low, dtype=torch.float32, device=device)
        high = torch.as_tensor(high, dtype=torch.float32, device=device)
        return ActionSpec(scale=(high - low) / 2.0, bias=(high + low) / 2.0)


def _squash(mean, spec: ActionSpec, squash: str = DEFAULT_SQUASH):
    """The deterministic head: tanh(mean) * scale + bias."""
    return squash_tanh(squash)(mean) * spec.scale + spec.bias


def gaussian_policy_init(gen, obs_dim: int, action_dim: int, hidden: int,
                         device=None):
    return {
        "trunk": mlp_init(gen, [obs_dim, hidden, hidden], device=device),
        "mean": {"w": [xavier_uniform(gen, (hidden, action_dim),
                                      device=device)],
                 "b": [torch.zeros((action_dim,), device=device)]},
        "log_std": {"w": [xavier_uniform(gen, (hidden, action_dim),
                                         device=device)],
                    "b": [torch.zeros((action_dim,), device=device)]},
    }


def gaussian_policy_forward(params, obs):
    """Returns (mean, log_std) with log_std clamped."""
    h = mlp_apply(params["trunk"], obs, final_activation=torch.relu)
    mean = mlp_apply(params["mean"], h)
    log_std = mlp_apply(params["log_std"], h)
    log_std = torch.clamp(log_std, LOG_SIG_MIN, LOG_SIG_MAX)
    return mean, log_std


def gaussian_policy_sample(params, obs, spec: ActionSpec,
                           gen: Optional[torch.Generator] = None,
                           noise: Optional[torch.Tensor] = None,
                           squash: str = DEFAULT_SQUASH
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Reparameterized sample: (action, log_prob (B,1), deterministic
    action). ``noise`` is the standard-normal draw; when it is None one
    is drawn from ``gen``."""
    mean, log_std = gaussian_policy_forward(params, obs)
    std = torch.exp(log_std)
    if noise is None:
        noise = torch.randn(mean.shape, generator=gen, device=mean.device,
                            dtype=mean.dtype)
    x = mean + std * noise
    y = squash_tanh(squash)(x)
    action = y * spec.scale + spec.bias
    log_prob = (-0.5 * torch.square(noise) - log_std
                - 0.5 * math.log(2.0 * math.pi))
    log_prob = log_prob - torch.log(spec.scale * (1.0 - torch.square(y))
                                    + EPS)
    log_prob = torch.sum(log_prob, dim=-1, keepdim=True)
    return action, log_prob, _squash(mean, spec, squash)


def deterministic_policy_init(gen, obs_dim: int, action_dim: int,
                              hidden: int, device=None):
    return mlp_init(gen, [obs_dim, hidden, hidden, action_dim],
                    device=device)


def deterministic_policy_sample(params, obs, spec: ActionSpec,
                                gen: Optional[torch.Generator] = None,
                                noise: Optional[torch.Tensor] = None,
                                noise_std: float = 0.1,
                                noise_clip: float = 0.25,
                                squash: str = DEFAULT_SQUASH):
    """tanh(mean)*scale + bias plus clipped N(0, noise_std) noise; ``noise``
    is the standard-normal draw."""
    mean = _squash(mlp_apply(params, obs), spec, squash)
    if noise is None:
        noise = torch.randn(mean.shape, generator=gen, device=mean.device,
                            dtype=mean.dtype)
    noise = torch.clamp(noise_std * noise, -noise_clip, noise_clip)
    return mean + noise, mean.new_zeros(mean.shape[:-1] + (1,)), mean


def policy_mean_action(params, obs, spec: ActionSpec,
                       policy_type: str = "gaussian",
                       squash: str = DEFAULT_SQUASH):
    """The deterministic head ``tanh(mean) * scale + bias`` without a draw:
    the third output of ``gaussian_policy_sample`` (``policy_type``
    'gaussian') or of ``deterministic_policy_sample`` ('deterministic')."""
    if policy_type == "deterministic":
        mean = mlp_apply(params, obs)
    else:
        mean, _ = gaussian_policy_forward(params, obs)
    return _squash(mean, spec, squash)
