"""Deployment export (port of ``nlbac_tpu/utils/export_policy.py``): the
trained policy as one self-contained ``torch.export`` artifact.

``export_policy`` exports the deterministic head ``tanh(mean) * scale +
bias`` (obs batch in, env-space action batch out, the weights inside) as a
``torch.export`` program with a symbolic batch dimension (or a static one
with ``batch=``), saved with ``torch.export.save`` beside a JSON
manifest. Serving needs only torch, no code of this package:

    import torch
    act = torch.export.load("policy.pt2").module()   # (B, obs_dim) ->
    action = act(obs)                                 # (B, action_dim)

The weights are buffers of the exported module, so ``act.to("cuda")``
moves a CPU export to the card. The stochastic head takes the
standard-normal draw ``(B, action_dim)`` as its second input, where the
JAX export takes a PRNG key (the two packages' random streams differ).
The head squashes with the tanh its weights were trained under (the
record ``train.checkpoint.weights_squash`` reads; the manifest names a
squash other than XLA's, the JAX package's).

CLI:
    python -m nlbac_tpu_torch.utils.export_policy RUN_DIR --preset unicycle \
        -o policy.pt2 [--stochastic] [--batch N] [--cpu]
"""

from __future__ import annotations

import argparse
import io
import json
import os
from typing import Optional

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
from nlbac_tpu_torch.train.checkpoint import _write_atomic
from nlbac_tpu_torch.tree import tree_leaves, tree_map, tree_unflatten

_MANIFEST_SUFFIX = ".json"


class PolicyHead(torch.nn.Module):
    """A policy's action head with the weights (and the action scale and
    bias) held as buffers. ``forward(obs)``: the deterministic head;
    with ``stochastic``, ``forward(obs, noise)``: the sampled action for
    the standard-normal draw ``noise``, as the training samplers compute
    it."""

    def __init__(self, policy, spec: ActionSpec, policy_type: str,
                 stochastic: bool = False, squash: str = DEFAULT_SQUASH):
        super().__init__()
        self.squash = squash
        self._tree = tree_map(lambda _: None, policy)  # the structure
        self.policy_type = policy_type
        self.stochastic = stochastic
        self._names = []
        for i, leaf in enumerate(tree_leaves(policy)):
            self.register_buffer(f"p{i}", leaf.detach().clone())
            self._names.append(f"p{i}")
        self.register_buffer("scale", spec.scale.detach().clone())
        self.register_buffer("bias", spec.bias.detach().clone())

    def _params(self):
        return tree_unflatten(self._tree,
                              [getattr(self, n) for n in self._names])

    def forward(self, obs, noise=None):
        params = self._params()
        spec = ActionSpec(scale=self.scale, bias=self.bias)
        if not self.stochastic:
            return policy_mean_action(params, obs, spec, self.policy_type,
                                      self.squash)
        sample = (deterministic_policy_sample
                  if self.policy_type == "deterministic"
                  else gaussian_policy_sample)
        return sample(params, obs, spec, noise=noise,
                      squash=self.squash)[0]


def make_policy_fn(cfg, ts, deterministic: bool = True,
                   squash: str = DEFAULT_SQUASH) -> PolicyHead:
    """The serving module of ``ts.policy`` on the device its weights live
    on: ``(obs) -> action``, or ``(obs, noise) -> action`` when not
    ``deterministic``; ``squash`` is the policy's tanh."""
    env = get_env(cfg.env.name)
    device = tree_leaves(ts.policy)[0].device
    spec = ActionSpec.from_bounds(env.SPEC.action_low, env.SPEC.action_high,
                                  device)
    return PolicyHead(ts.policy, spec, cfg.sac.policy_type,
                      stochastic=not deterministic, squash=squash).eval()


def export_policy(cfg, ts, path: str, deterministic: bool = True,
                  batch: Optional[int] = None, squash: str = DEFAULT_SQUASH
                  ) -> None:
    """Export the policy head to ``path`` (and a ``.json`` manifest beside
    it). ``batch=None`` gives a symbolic batch dimension; an int pins it.
    The program is traced on the device of ``ts``'s weights."""
    head = make_policy_fn(cfg, ts, deterministic=deterministic,
                          squash=squash)
    device = head.scale.device
    # trace with 2 rows or more: an example batch of 1 would specialize
    # the dimension to 1
    rows = batch if batch is not None else 2
    args = (torch.zeros((rows, cfg.obs_dim), device=device),)
    if not deterministic:
        args += (torch.zeros((rows, cfg.action_dim), device=device),)
    dynamic = None
    if batch is None:
        b = torch.export.Dim("batch", min=1)
        dynamic = tuple({0: b} for _ in args)
    program = torch.export.export(head, args, dynamic_shapes=dynamic)
    # the XLA-form tanh's float64 steps are dtype conversions, each of
    # which the export checks against the tracing device; dropping those
    # checks lets the program move with .to, as its weights do
    for node in list(program.graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default:
            program.graph.erase_node(node)

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    _write_atomic(path, buf.getvalue())
    manifest = {
        "format": "nlbac-policy-export-v1",
        "env": cfg.env.name,
        "policy_type": cfg.sac.policy_type,
        "deterministic": deterministic,
        "obs_dim": cfg.obs_dim,
        "action_dim": cfg.action_dim,
        "batch": batch,  # None = symbolic
        "torch_version": torch.__version__,
    }
    # the JAX export's fields, and a squash other than the JAX package's
    if squash != "xla":
        manifest["squash"] = squash
    # the manifest is written the same way, so a crash never pairs a new
    # program with a stale or truncated manifest
    _write_atomic(path + _MANIFEST_SUFFIX,
                  json.dumps(manifest, indent=1).encode())


def load_policy(path: str):
    """Load an exported policy: returns (module, manifest dict). Needs only
    torch; the module runs on the device it was exported on until moved
    with ``.to``."""
    module = torch.export.load(path).module()
    manifest = {}
    if os.path.exists(path + _MANIFEST_SUFFIX):
        with open(path + _MANIFEST_SUFFIX) as f:
            manifest = json.load(f)
    return module, manifest


def main(argv=None):
    p = argparse.ArgumentParser(
        description="export a trained policy as a self-contained "
                    "torch.export artifact")
    p.add_argument("run_dir", help="directory with actor.pkl etc.")
    p.add_argument("--preset", required=True,
                   help="preset the run was trained with")
    p.add_argument("-o", "--out", default=None,
                   help="output path (default <run_dir>/policy.pt2)")
    p.add_argument("--stochastic", action="store_true",
                   help="export the sampling head (takes a standard-normal "
                        "draw) instead of the deterministic head")
    p.add_argument("--batch", type=int, default=None,
                   help="pin a static batch size (default: symbolic)")
    p.add_argument("--cpu", action="store_true",
                   help="trace on the CPU (default: the GPU)")
    args = p.parse_args(argv)

    from nlbac_tpu_torch.config import get_config
    from nlbac_tpu_torch.train.checkpoint import weights_squash
    from nlbac_tpu_torch.utils.evaluate import load_trained_state

    device = resolve_device("cpu" if args.cpu else "cuda")
    cfg = get_config(args.preset)
    ts = load_trained_state(cfg, args.run_dir, device)
    out = args.out or os.path.join(args.run_dir, "policy.pt2")
    export_policy(cfg, ts, out, deterministic=not args.stochastic,
                  batch=args.batch, squash=weights_squash(args.run_dir))
    print(f"exported {args.preset} policy "
          f"({'stochastic' if args.stochastic else 'deterministic'}, "
          f"batch={'symbolic' if args.batch is None else args.batch}) "
          f"-> {out} (+{_MANIFEST_SUFFIX})")


if __name__ == "__main__":
    main()
