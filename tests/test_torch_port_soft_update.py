"""The soft target update, port against the JAX package's jitted one, on
the CPU, bit for bit.

The JAX package averages each target leaf as ``(1 - tau) * t + tau * o``
(``nlbac_tpu/nn/critics.py::soft_update``) inside its jitted update, where
XLA's CPU backend rounds ``tau * o`` to float32 and contracts the rest into
one fused multiply-add. The port's ``soft_update`` computes that form
(``nn/xla_float.py::fma_f32``), so every target leaf equals JAX's bit for
bit: on the unicycle preset's full-width critic, Lyapunov and barrier nets
and on the stacked twin-Q layout, and, stacked over seeds, for the seeds a
mask picks (the others keep their targets bit for bit). The eager
two-rounding form the port used before (an in-place multiply by 1 - tau,
then an add of tau * o) differs from JAX's in about a quarter of the
entries, which the first case also checks, so that it would catch it.

``fma_f32`` itself is held against exact rational arithmetic, on random
triples and on triples whose float64 sum rounds onto a float32 tie.
"""

import fractions

import jax
import numpy as np
import pytest
import torch

from nlbac_tpu.nn.critics import soft_update as j_soft_update
from nlbac_tpu_torch import config as tconfig
from nlbac_tpu_torch.nn import (
    barrier_init,
    lyapunov_init,
    soft_update,
    twin_q_init,
    twin_q_stack,
)
from nlbac_tpu_torch.nn.xla_float import fma_f32
from nlbac_tpu_torch.tree import tree_leaves, tree_map

SEEDS = 3
MASK = (True, False, True)


@pytest.fixture(scope="module")
def nets():
    """The unicycle preset's full-width critic, Lyapunov net and a barrier
    net of the same widths, as targets; online nets a small step away
    (the average's inputs after some training)."""
    cfg = tconfig.get_config("unicycle")
    gen = torch.Generator().manual_seed(0)
    hidden = cfg.sac.hidden_dim
    critic = twin_q_init(gen, cfg.obs_dim, cfg.action_dim, hidden)
    target = {"critic": critic, "stacked": twin_q_stack(critic),
              "lyap": lyapunov_init(gen, cfg.lyap_dim, hidden),
              "barrier": barrier_init(gen, cfg.obs_dim, cfg.action_dim,
                                      hidden)}
    target = tree_map(lambda p: p.detach().clone(), target)
    online = tree_map(lambda p: p + 0.05 * torch.randn(
        p.shape, generator=gen) * p.abs().mean(), target)
    return cfg.sac.tau, target, online


def jitted(tau):
    return jax.jit(lambda t, o: j_soft_update(t, o, tau))


def bits(x):
    return np.asarray(x).view(np.int32)


def test_soft_update_matches_jitted_reference(nets):
    tau, target, online = nets
    want = jitted(tau)(tree_map(lambda p: p.numpy(), target),
                       tree_map(lambda p: p.numpy(), online))
    got = soft_update(tree_map(torch.clone, target), online, tau)
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(bits(g.numpy()), bits(w))
    # the eager form rounds twice and is caught
    old = [t.clone() for t in tree_leaves(target)]
    torch._foreach_mul_(old, 1.0 - tau)
    torch._foreach_add_(old, tree_leaves(online), alpha=tau)
    apart = sum(int((bits(o.numpy()) != bits(w)).sum())
                for o, w in zip(old, jax.tree.leaves(want)))
    assert apart > 0.1 * sum(o.numel() for o in old)


def test_masked_soft_update_matches_jitted_reference_per_seed(nets):
    """The critic stacked over SEEDS seeds (the lockstep's layout): the
    seeds in MASK equal the jitted (vmapped) update of their own nets, the
    others are left as they were, bit for bit."""
    tau, target, online = nets
    gen = torch.Generator().manual_seed(1)

    def seeds(tree, scale):
        return tree_map(lambda p: torch.stack(
            [p + scale * k * torch.randn(p.shape, generator=gen)
             * p.abs().mean() for k in range(SEEDS)]), tree)

    t_s = seeds(target["critic"], 0.01)
    o_s = seeds(online["critic"], 0.01)
    before = tree_map(torch.clone, t_s)
    got = soft_update(tree_map(torch.clone, t_s), o_s, tau,
                      torch.tensor(MASK))
    want = jax.jit(jax.vmap(lambda t, o: j_soft_update(t, o, tau)))(
        tree_map(lambda p: p.numpy(), t_s), tree_map(lambda p: p.numpy(),
                                                     o_s))
    for g, w, b in zip(tree_leaves(got), jax.tree.leaves(want),
                       tree_leaves(before)):
        for i, on in enumerate(MASK):
            np.testing.assert_array_equal(
                bits(g[i].numpy()), bits(w[i] if on else b[i].numpy()))


def exact_f32(q: fractions.Fraction) -> np.float32:
    """The float32 nearest the rational ``q`` (ties to even)."""
    f = np.float32(float(q))
    near = [np.nextafter(f, np.float32(-np.inf)), f,
            np.nextafter(f, np.float32(np.inf))]
    err = [abs(fractions.Fraction(float(c)) - q) for c in near]
    best = min(err)
    ties = [c for c, e in zip(near, err) if e == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """On random triples and on ties: 1 + 2^-12 squared is a float32 tie
    (1 + 2^-11 + 2^-24), which a float64 sum with +-2^-70 rounds onto, and
    which a second rounding to float32 would then resolve to even."""
    rng = np.random.default_rng(0)
    a = rng.normal(0, 1, 2000).astype(np.float32)
    b = rng.normal(0, 1, 2000).astype(np.float32)
    c = (rng.normal(0, 1, 2000) * 10.0 ** rng.integers(-12, 3, 2000)
         ).astype(np.float32)
    one = np.float32(1 + 2.0 ** -12)
    for sign in (1, -1):
        tie = np.float32(sign * 2.0 ** -70)
        a = np.append(a, [one, -one, one])
        b = np.append(b, [one, one, -one])
        c = np.append(c, [tie, -tie, tie])
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([exact_f32(fractions.Fraction(float(x))
                               * fractions.Fraction(float(y))
                               + fractions.Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(bits(got), bits(want))
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (bits(twice[-6:]) != bits(want[-6:])).any()
