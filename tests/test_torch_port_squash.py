"""The tanh-squash term of the Gaussian policy's log-prob near saturation
under ``squash="torch"`` (``--squash torch``): a pinned, deliberate
deviation of that option from the JAX package. The port's default squash
is XLA's form (``nn/xla_float.py``; ``test_torch_port_squash_xla.py``
holds it to JAX), and ``torch.tanh`` stays an option.

Both packages compute ``log(scale * (1 - tanh(x)^2) + 1e-6)``
(``nn/policy.py`` in each) on float32. XLA's CPU ``tanh`` returns exactly
+-1 from |x| = 7.99885, ``torch.tanh`` from |x| = 9.01085. Below that,
XLA's value lies up to 4 float32 ulps from torch's over the whole grid
(|x| from 3 on), and the squash term turns those ulps into a gap that
grows with |x| as 1 - tanh^2 shrinks. On a float32 grid over |x| in
[3, 9.1] (step 5e-5), the JAX-vs-port gap of the term at action scales
3.5 / 12 / 15 reaches:

- 3-6: 0.0189 / 0.0191 / 0.0191 nats (3.3e-4 at 3-4, 2.5e-3 at 4-5; it
  first passes 1e-3 at |x| = 4.66, 1e-2 at 5.76, 0.1 at 6.88);
- 6-7.9: 0.647 / 0.909 / 0.941;
- 7.9-7.99: 0.633 / 1.017 / 1.073;
- the band [7.99, 9.02], where only XLA has saturated: 0.982 / 1.905 /
  2.098;
- above 9.02 both have saturated and agree exactly.

The option keeps ``torch.tanh``: it is the closer of the two to a float64
evaluation in every range (its largest error below the band 0.104 nats
where JAX's is 1.137, inside the band 0.639 where JAX's is 2.050), XLA's
threshold is one backend's artifact (XLA on other devices saturates
elsewhere), and torch's value is what the original torch NLBAC computes.

Bounds, each stated with what the grid measures on this CPU:
- the saturation points: JAX in [7.998, 7.999], torch in [9.010, 9.011];
- below 7.99: the tanh values agree within 5 ulps (measured 4);
- in each range, the gap at most the bound in ``RANGES`` (measured at
  scale 15: 0.0191, 0.941, 1.073, 2.098), the port's largest error to
  float64 no larger than JAX's, and the port at each point no further
  from float64 than JAX plus a slack: 1e-2 nats below 7.9 (measured
  6.3e-3: there the two errors are both small and either side may be
  the closer at a point), 1e-6 from 7.9 on (measured 0);
- below 7.99 the port within 0.11 nats of float64 (measured 0.104),
  inside the band within 0.7 (measured 0.639);
- above 9.02: the two terms are equal (both tanh are +-1).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nlbac_tpu_torch.nn.policy import DEFAULT_SQUASH, EPS
from nlbac_tpu_torch.nn.xla_float import squash_tanh, xla_tanh

SCALES = (3.5, 12.0, 15.0)
BAND = (7.99, 9.02)
_HALF = np.linspace(3.0, 9.1, 122001, dtype=np.float32)
GRID = np.concatenate([-_HALF[::-1], _HALF])
# name: (|x| from, |x| below, the largest JAX-vs-port gap in nats, the
# pointwise slack of the port's error to float64 over JAX's)
RANGES = {
    "3-6": (3.0, 6.0, 0.025, 1e-2),
    "6-7.9": (6.0, 7.9, 1.0, 1e-2),
    "7.9-7.99": (7.9, BAND[0], 1.1, 1e-6),
    "band": (BAND[0], BAND[1], 2.2, 1e-6),
}


def squash_jax(x, scale):
    y = jnp.tanh(jnp.asarray(x))
    return np.asarray(jnp.log(np.float32(scale) * (1.0 - jnp.square(y))
                              + EPS))


def squash_port(x, scale):
    y = torch.tanh(torch.from_numpy(x))
    return torch.log(np.float32(scale) * (1.0 - torch.square(y))
                     + EPS).numpy()


def squash_f64(x, scale):
    y = np.tanh(x.astype(np.float64))
    return np.log(scale * (1.0 - np.square(y)) + EPS)


@functools.lru_cache(maxsize=None)
def terms(scale):
    """(JAX's term, the port's, float64's) on GRID."""
    return (squash_jax(GRID, scale), squash_port(GRID, scale),
            squash_f64(GRID, scale))


def test_saturation_points():
    y_j = np.asarray(jnp.tanh(GRID))
    y_t = torch.tanh(torch.from_numpy(GRID)).numpy()
    first_j = np.abs(GRID[np.abs(y_j) == 1.0]).min()
    first_t = np.abs(GRID[np.abs(y_t) == 1.0]).min()
    assert 7.998 <= first_j <= 7.999, first_j
    assert 9.010 <= first_t <= 9.011, first_t
    below = np.abs(GRID) < BAND[0]
    ulp = np.spacing(np.abs(y_t[below]))
    assert (np.abs(y_j[below] - y_t[below]) / ulp).max() <= 5


@pytest.mark.parametrize("scale", SCALES)
def test_squash_band_is_pinned(scale):
    j, t, r = terms(scale)
    ax = np.abs(GRID)
    above, below = ax > BAND[1], ax < BAND[0]
    band = ~(above | below)
    np.testing.assert_array_equal(j[above], t[above])
    port_err, jax_err = np.abs(t - r), np.abs(j - r)
    assert port_err[below].max() <= 0.11
    assert port_err[band].max() <= 0.7
    assert np.all(port_err[band] <= jax_err[band] + 1e-6)
    assert np.abs(j - t).max() <= 2.2


@pytest.mark.parametrize("name", list(RANGES))
@pytest.mark.parametrize("scale", SCALES)
def test_squash_gap_by_range(scale, name):
    lo, hi, gap_max, slack = RANGES[name]
    j, t, r = terms(scale)
    ax = np.abs(GRID)
    m = (ax >= lo) & ((ax <= hi) if name == "band" else (ax < hi))
    assert np.abs(j - t)[m].max() <= gap_max
    port_err, jax_err = np.abs(t - r)[m], np.abs(j - r)[m]
    assert port_err.max() <= jax_err.max()
    assert np.all(port_err <= jax_err + slack)


def test_torch_tanh_is_an_option_and_not_the_default():
    assert squash_tanh("torch") is torch.tanh
    assert squash_tanh(DEFAULT_SQUASH) is xla_tanh
