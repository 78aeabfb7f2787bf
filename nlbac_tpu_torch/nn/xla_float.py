"""float32 arithmetic as the JAX package's jitted CPU programs round it.

XLA's CPU backend contracts ``a * b + c`` into one fused multiply-add
(one rounding where PyTorch's eager ops round twice), and its ``tanh`` is
Eigen's rational approximation, which reaches exactly +-1 from |x| =
7.9988117 where ``torch.tanh`` does so from 9.0109. Two parts of the port
follow those forms:

- ``fma_f32``: the soft target update (``critics.soft_update``, always)
  and the XLA-form tanh's derivative;
- ``xla_tanh``: the policy's squash under ``squash="xla"``
  (``nn/policy.py``; ``make_agent(..., squash=...)``,
  ``nlbac-train-torch --squash``), the default (``nn.DEFAULT_SQUASH``;
  ``squash="torch"`` gives ``torch.tanh``).
  Only the tanh and its derivative take XLA's form: the squash term
  log(scale (1 - y^2) + 1e-6) and the action y scale + bias keep the
  port's two roundings where XLA fuses each product and sum into one
  (near saturation that moves the term by up to 8.6e-5 nats, where one
  ulp of the pre-tanh value moves XLA's by up to 0.27).

Both are plain float64/float32 tensor ops, so they compute the same bits
on the CPU and on a card.
"""

from __future__ import annotations

import torch

# The policy's squash: XLA's CPU tanh (the default) or ``torch.tanh``.
SQUASHES = ("torch", "xla")

# Eigen's generic_fast_tanh_float, as XLA's CPU backend emits it with FMA:
# |x| clamped to XLA_TANH_CLAMP, an odd degree-13 numerator over an even
# degree-6 denominator in x^2 (float32 coefficients, from the highest
# power down), and x itself below XLA_TANH_TINY.
XLA_TANH_CLAMP = 7.99881172180175781
XLA_TANH_TINY = 0.0004
_NUMERATOR = (-2.76076847742355e-16, 2.00018790482477e-13,
              -8.60467152213735e-11, 5.12229709037114e-08,
              1.48572235717979e-05, 6.37261928875436e-04,
              4.89352455891786e-03)
_DENOMINATOR = (1.19825839466702e-06, 1.18534705686654e-04,
                2.26843463243900e-03, 4.89352518554385e-03)


def _f32(values):
    return tuple(float(torch.tensor(v, dtype=torch.float32))
                 for v in values)


_NUMERATOR, _DENOMINATOR = _f32(_NUMERATOR), _f32(_DENOMINATOR)


def fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
            ) -> torch.Tensor:
    """``a * b + c`` of float32 tensors rounded once to float32, as a fused
    multiply-add rounds it.

    The product of two float32 values is exact in float64; the float64
    sum may round, and rounding that again to float32 can fall on the
    wrong side of a float32 tie. So the sum is first rounded to odd: where
    it is inexact (TwoSum's error is not zero) and its last bit is even,
    it moves one float64 ulp towards the exact sum. A sum rounded to odd
    with 29 bits to spare rounds to float32 as the exact sum does."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    bits = s.view(torch.int64)
    toward = torch.where((err > 0) == (s > 0), 1, -1)
    bits = torch.where((err != 0) & ((bits & 1) == 0), bits + toward, bits)
    return bits.view(torch.float64).to(torch.float32)


def _horner(x2d: torch.Tensor, coefficients) -> torch.Tensor:
    """The polynomial in x^2 by Horner's rule, each step ``x2 * p + c``
    rounded once to float32 (from the exact float64 product). Over every
    float32 input that the tanh evaluates this for, the float64 sum never
    rounds onto a float32 tie, so each step equals ``fma_f32`` at a third
    of its ops (``tests/test_torch_port_squash_xla.py``)."""
    p = (x2d * coefficients[0] + coefficients[1]).float()
    for c in coefficients[2:]:
        p = (x2d * p.double() + c).float()
    return p


def xla_tanh_values(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU ``tanh`` of a float32 tensor, bit for bit (no gradient)."""
    xc = torch.clamp(x, -XLA_TANH_CLAMP, XLA_TANH_CLAMP)
    x2d = (xc * xc).double()
    p = _horner(x2d, _NUMERATOR) * xc
    q = _horner(x2d, _DENOMINATOR)
    return torch.where(x.abs() < XLA_TANH_TINY, x, p / q)


class XlaTanh(torch.autograd.Function):
    """``xla_tanh_values`` with the derivative of JAX's jitted vjp of
    ``jnp.tanh``: m = g (1 - y), then m + m y as one fused multiply-add."""

    @staticmethod
    def forward(ctx, x):
        y = xla_tanh_values(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        m = g * (1.0 - y)
        return fma_f32(m, y, m)


def xla_tanh(x: torch.Tensor) -> torch.Tensor:
    """XLA's CPU tanh; through ``XlaTanh`` only where a gradient is asked
    for (the plain ops trace and export without an autograd function)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return XlaTanh.apply(x)
    return xla_tanh_values(x)


def squash_tanh(squash: str):
    """The tanh of the policy's squash ``squash`` (one of ``SQUASHES``)."""
    if squash == "torch":
        return torch.tanh
    if squash == "xla":
        return xla_tanh
    raise ValueError(f"squash={squash!r} is not one of {SQUASHES}")
