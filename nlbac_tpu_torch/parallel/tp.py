"""Tensor-parallel layouts (port of ``nlbac_tpu/parallel/mesh.py:440-518``).

Every MLP parameter dict (``{"w", "b"}``) is cut Megatron-style over a
grid's tp group by ``_tp_param_specs``: alternate layers split the output
dimension (column-parallel: the weight's columns and the bias) and the
input dimension (row-parallel: the weight's rows, the bias whole); a
layer whose dimension does not divide the tp width stays whole. The
specs are tuples in the form of the JAX package's ``PartitionSpec``
(``(None, "tp")``, ``("tp",)``, ``("tp", None)``, ``()``). Targets and
Adam moments take their parameters' layouts, so the elementwise steps
(Adam, the soft target update) stay local.

A rank's shard of a cut tensor carries a ``tp_shard`` mark
(``nn.mlp.TPShard``) that ``mlp_apply`` reads. ``gather_state_tp`` puts
the whole tensors back together on every rank of the group (for the
weight files and the checkpoint, which are then those of a run of one).
"""

from __future__ import annotations

import torch

from nlbac_tpu_torch.agent.state import OPT_GROUPS, TrainState
from nlbac_tpu_torch.nn.mlp import TPShard
from nlbac_tpu_torch.tree import tree_leaves

TP_AXIS = "tp"
_PARAM_FIELDS = ("policy", "backup_policy", "critic", "lyap", "barrier",
                 "node")
_TARGETS = {"critic_target": "critic", "lyap_target": "lyap",
            "barrier_target": "barrier"}


def _tp_param_specs(params, ntp: int, tp_axis: str = TP_AXIS):
    """Specs for one MLP param dict: alternate layers split the output dim
    (column-parallel) and the input dim (row-parallel); dims that do not
    divide ``ntp`` (e.g. the final scalar head) stay whole, so the layout
    is safe on every net."""
    w_specs, b_specs = [], []
    want_col = True
    for w in params["w"]:
        if w.dim() != 2:
            raise ValueError(
                f"tensor parallelism cuts 2-d (in, out) weights, not a "
                f"{w.dim()}-d one: a stacked twin-Q critic "
                "(experimental.stack_twin_q_state) has no tp layout, as "
                "in the JAX package; use the plain layout")
        din, dout = w.shape
        if want_col and dout % ntp == 0:
            w_specs.append((None, tp_axis))
            b_specs.append((tp_axis,))
            want_col = False
        elif not want_col and din % ntp == 0:
            w_specs.append((tp_axis, None))
            b_specs.append(())
            want_col = True
        else:  # non-divisible dim: this layer stays whole
            w_specs.append(())
            b_specs.append(())
    return {"w": w_specs, "b": b_specs}


def _split_dim(spec):
    return spec.index(TP_AXIS) if TP_AXIS in spec else None


def _cut(t: torch.Tensor, dim, comm) -> torch.Tensor:
    """Rank ``comm.index``'s shard of ``t`` along ``dim`` (a marked copy),
    or a copy of all of ``t`` when ``dim`` is None."""
    if dim is None:
        return t.detach().clone().requires_grad_(t.requires_grad)
    k = t.shape[dim] // comm.size
    shard = t.detach().narrow(dim, comm.index * k, k).clone()
    shard.requires_grad_(t.requires_grad)
    shard.tp_shard = TPShard(dim, comm)
    return shard


def _adams(ts: TrainState, fields) -> dict:
    """An Adam per optimizer group over ``fields``' leaves, with the
    hyperparameters of ``ts``'s."""
    opts = {}
    for group, field in OPT_GROUPS.items():
        hyper = {k: ts.opt[group].param_groups[0][k]
                 for k in ("lr", "betas", "eps")}
        opts[group] = torch.optim.Adam(tree_leaves(fields[field]), **hyper)
    return opts


def _is_mlp(node) -> bool:
    return isinstance(node, dict) and set(node) == {"w", "b"}


def _walk_specs(tree, ntp):
    """Specs for every leaf of a parameter tree: each MLP dict's, the
    whole-tensor spec ``()`` anywhere else."""
    if _is_mlp(tree):
        return _tp_param_specs(tree, ntp)
    if isinstance(tree, dict):
        return {k: _walk_specs(v, ntp) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk_specs(v, ntp) for v in tree)
    return ()


def shard_params_tp(params, grid, template=None):
    """This rank's shards of an MLP parameter tree, cut over ``grid``'s tp
    group; ``template`` (the tree whose layout to take, by default
    ``params`` itself) lets a target net take its online net's layout."""
    specs = _walk_specs(template if template is not None else params,
                        grid.tp)
    comm = grid.tp_comm

    def cut(tree, spec):
        if isinstance(tree, dict):
            return {k: cut(tree[k], spec[k]) for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(cut(t, s) for t, s in zip(tree, spec))
        return _cut(tree, _split_dim(spec), comm)

    return cut(params, specs)


def shard_state_tp(ts: TrainState, grid) -> TrainState:
    """This rank's shard of a whole ``TrainState``: every network, its
    target and its Adam moments cut by the same specs; the temperatures,
    the Lagrangian state and the counter whole."""
    fields = {name: shard_params_tp(getattr(ts, name), grid)
              for name in _PARAM_FIELDS}
    for target, online in _TARGETS.items():
        fields[target] = shard_params_tp(getattr(ts, target), grid,
                                         template=getattr(ts, online))
    for name in ("log_alpha", "backup_log_alpha"):
        fields[name] = _cut(getattr(ts, name), None, None)
    opts = _adams(ts, fields)
    for group, field in OPT_GROUPS.items():
        old = ts.opt[group]
        for p_old, p_new in zip(tree_leaves(getattr(ts, field)),
                                tree_leaves(fields[field])):
            if p_old not in old.state:
                continue
            mark = getattr(p_new, "tp_shard", None)
            dim = None if mark is None else mark.dim
            state = old.state[p_old]
            opts[group].state[p_new] = {
                "step": state["step"].clone(),
                "exp_avg": _cut(state["exp_avg"], dim, grid.tp_comm),
                "exp_avg_sq": _cut(state["exp_avg_sq"], dim, grid.tp_comm)}
    return TrainState(**fields, opt=opts, lag=ts.lag, updates=ts.updates)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of which ``t`` is this rank's shard (every rank of
    the tp group calls this for the same tensors in the same order)."""
    shard = getattr(t, "tp_shard", None)
    if shard is None:
        return t.detach().clone()
    comm, dim = shard.comm, shard.dim
    k = t.shape[dim]
    size = list(t.shape)
    size[dim] = k * comm.size
    full = t.new_zeros(size)
    full.narrow(dim, comm.index * k, k).copy_(t.detach())
    return comm.all_reduce(full)


def _whole_tree(tree, requires_grad=False):
    if isinstance(tree, dict):
        return {k: _whole_tree(v, requires_grad) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_whole_tree(v, requires_grad) for v in tree)
    return _whole(tree).requires_grad_(requires_grad)


def gather_state_tp(ts: TrainState) -> TrainState:
    """The whole ``TrainState`` of which ``ts`` holds this rank's shards:
    the same tensors, Adam moments and counters as a run of one would
    hold (a collective: every rank of the tp group calls it)."""
    fields = {name: _whole_tree(getattr(ts, name), requires_grad=True)
              for name in _PARAM_FIELDS}
    fields.update({name: _whole_tree(getattr(ts, name))
                   for name in _TARGETS})
    fields["log_alpha"] = ts.log_alpha.detach().clone().requires_grad_(True)
    fields["backup_log_alpha"] = \
        ts.backup_log_alpha.detach().clone().requires_grad_(True)
    opts = _adams(ts, fields)
    for group, field in OPT_GROUPS.items():
        old = ts.opt[group]
        for p_old, p_new in zip(tree_leaves(getattr(ts, field)),
                                tree_leaves(fields[field])):
            if p_old not in old.state:
                continue
            state = old.state[p_old]
            mark = getattr(p_old, "tp_shard", None)

            def whole(m):
                if mark is not None:
                    m = m.detach()
                    m.tp_shard = mark
                return _whole(m)

            opts[group].state[p_new] = {
                "step": state["step"].clone(),
                "exp_avg": whole(state["exp_avg"]),
                "exp_avg_sq": whole(state["exp_avg_sq"])}
    return TrainState(**fields, opt=opts, lag=ts.lag, updates=ts.updates)


def shard_bytes(ts: TrainState) -> int:
    """The bytes of parameters, targets and Adam moments this rank holds."""
    total = 0
    for name in _PARAM_FIELDS + tuple(_TARGETS):
        total += sum(t.numel() * t.element_size()
                     for t in tree_leaves(getattr(ts, name)))
    for opt in ts.opt.values():
        for state in opt.state.values():
            total += sum(state[k].numel() * state[k].element_size()
                         for k in ("exp_avg", "exp_avg_sq"))
    return total
