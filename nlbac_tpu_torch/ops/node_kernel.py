"""The control-affine NODE Euler step, x' = x + dt * (f(x) + g(x) u), as a
hand-written CUDA kernel (``csrc/node_euler.cu``) with its plain PyTorch
version beside it.

It replaces K1, the JAX package's Pallas kernel ``fused_euler_step``
(``nlbac_tpu/ops/node_kernel.py``, deleted in 2150bab). As K1 did, the
gradient recomputes the plain field under autograd: the kernel runs the
forward only. The note at the top of the CUDA source gives the kernel's
bound on the card and its design.

The library is built at first use with ``nvcc`` for ``sm_90a`` into
``nlbac_tpu_torch/_build/`` (named by the source's hash, so an edited
source is rebuilt) and loaded with ctypes. ``node_euler_step`` launches it
for CUDA tensors and raises on anything it does not take; the plain
version runs only for tensors on the CPU. A parameter set is checked and
packed for the C call once (``launch_args``); x and u are checked on
every call.

The library is loaded, and a launch counted, under a lock, so host
threads may share the wrapper; a launch goes to the calling thread's
current stream. A process that holds several seeds (an ``--n_seeds``
worker, a rank of a seed group) keeps each seed's parameter set in the
cache, up to ``_LAUNCH_ARGS_KEPT`` of them.

Seed-batched form (the lockstep seed runner, ``parallel/lockstep.py``):
S parameter sets stacked on a leading seed axis, each weight (S, K, N)
and bias (S, N), with x (S, B, n_s) and u (S, B, n_u). One launch covers
every seed and counts once, with S * B rows in ``launches_by_rows``; its
plain version runs each layer as ``nn.mlp.mlp_apply`` runs a stacked
layer (one batched product for every seed). A stacked
parameter set is one cache entry. Chained calls (PVTOL's constraint
chain, each call's x the last one's output) take the same path: each
call's backward recomputes its own plain step, so the gradient reaches
u_t, x and the parameters through every call of the chain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path
from typing import Optional

import torch

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "node_euler.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
MAX_LAYERS = 8  # kMaxLayers in the CUDA source
MAX_WIDTH = 128  # kMaxWidth in the CUDA source
# (rows, warps) of the kernel's two tile configurations, in the order of
# the `config` index nlbac_node_euler_run takes.
TILE_CONFIGS = ((16, 4), (64, 4))
# Calls of at most this many rows (all seeds' rows) take 16-row tiles,
# larger ones 64-row tiles (from the sweep of chip_smoke.py phase 4).
SMALL_TILE_MAX_ROWS = 2048

# Kernel launches made through ``node_euler_step`` since the last reset,
# and the same launches by row count.
launch_counts = {"node_euler": 0}
launches_by_rows: Counter = Counter()
_count_lock = threading.Lock()

_lib = None
_load_lock = threading.Lock()


def reset_launch_counts() -> None:
    with _count_lock:
        for name in launch_counts:
            launch_counts[name] = 0
        launches_by_rows.clear()


def count_launch(rows: int, name: str = "node_euler") -> None:
    """Add one launch of kernel ``name`` over ``rows`` rows (safe from any
    thread)."""
    with _count_lock:
        launch_counts[name] += 1
        launches_by_rows[rows] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc was not found on PATH or under CUDA_HOME; it "
                       "is needed to build csrc/node_euler.cu")


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/node_euler.cu`` into a shared library (once per
    source version) and return its path. ``verbose`` asks ptxas for each
    kernel's registers, shared memory and spills."""
    src = _SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:16]
    out = _BUILD_DIR / f"libnode_euler-{tag}.so"
    if out.exists() and not verbose:
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-o", tmp, str(_SOURCE)]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{res.stdout}\n{res.stderr}")
        if verbose:
            print(res.stderr.strip())
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _bind(lib):
    """Declare the C entry points' argument types on a loaded library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.nlbac_node_euler_plan_bytes.argtypes = []
    lib.nlbac_node_euler_plan.argtypes = [p, i, i, i, i, p, p, p, i, p, p,
                                          p]
    lib.nlbac_node_euler_run.argtypes = [p, p, p, p, i, ctypes.c_float, i, p]
    for fn in (lib.nlbac_node_euler_plan_bytes, lib.nlbac_node_euler_plan,
               lib.nlbac_node_euler_run):
        fn.restype = i
    return lib


def load():
    """The kernel's library, built at first use (``build``) and loaded
    once per process; raises when it cannot be built or loaded."""
    global _lib
    if _lib is None:
        with _load_lock:
            if _lib is None:
                _lib = _bind(ctypes.CDLL(str(build())))
    return _lib


def _layers(net):
    return list(net["w"]), list(net["b"])


def _check_compute_dtype(compute_dtype: Optional[str]) -> None:
    if compute_dtype is not None:
        raise ValueError(
            f"the node_euler kernel computes in float32 only "
            f"(compute_dtype={compute_dtype!r})")


def _check_rows(x: torch.Tensor, u: torch.Tensor) -> None:
    """x (B, n_s) and u (B, n_u), or stacked over seeds (S, B, n_s) and
    (S, B, n_u)."""
    if x.dim() not in (2, 3) or u.dim() != x.dim() or \
            x.shape[:-1] != u.shape[:-1]:
        raise ValueError(f"x must be (B, n_s) and u (B, n_u), or (S, B, "
                         f"n_s) and (S, B, n_u), got {tuple(x.shape)} and "
                         f"{tuple(u.shape)}")


def _check_tensors(tensors, device) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"node_euler takes float32 tensors, got {t.dtype}")
        if t.device != device:
            raise ValueError("node_euler inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("node_euler inputs must be contiguous")


def _validate_params(params, n_s: int, n_u: int, device,
                     seeds: Optional[int] = None) -> None:
    """The nets' layers chain from n_s to n_s (f) and n_s * n_u (g) within
    the compiled limits; with ``seeds`` = S each weight is (S, K, N) and
    each bias (S, N)."""
    lead = () if seeds is None else (seeds,)
    tensors = []
    for name, out_dim in (("f", n_s), ("g", n_s * n_u)):
        ws, bs = _layers(params[name])
        if not 1 <= len(ws) <= MAX_LAYERS or len(bs) != len(ws):
            raise ValueError(f"{name}_net must have 1..{MAX_LAYERS} layers, "
                             f"got {len(ws)}")
        prev = n_s
        for w, b in zip(ws, bs):
            if w.dim() != len(lead) + 2 or w.shape[:-2] != lead or \
                    w.shape[-2] != prev or \
                    tuple(b.shape) != lead + (w.shape[-1],):
                raise ValueError(f"{name}_net layer shapes do not chain: "
                                 f"{tuple(w.shape)}, {tuple(b.shape)}")
            if w.shape[-1] > MAX_WIDTH:
                raise ValueError(f"{name}_net width {w.shape[-1]} exceeds "
                                 f"the kernel's {MAX_WIDTH}")
            prev = w.shape[-1]
        if prev != out_dim:
            raise ValueError(f"{name}_net ends at {prev}, expected {out_dim}")
        tensors += ws + bs
    if n_s + n_u > MAX_WIDTH:
        raise ValueError(f"n_s + n_u = {n_s + n_u} exceeds {MAX_WIDTH}")
    _check_tensors(tensors, device)


def validate(params, x: torch.Tensor, u: torch.Tensor,
             compute_dtype: Optional[str] = None) -> None:
    """Raise unless the kernel takes these inputs: float32, contiguous, on
    one device, f32 compute, (B, n_s) and (B, n_u) rows (or (S, B, n_s)
    and (S, B, n_u) with S stacked parameter sets) and the layer widths
    within the compiled limits."""
    _check_compute_dtype(compute_dtype)
    launch_args(params, x, u)


class LaunchArgs:
    """Validated parameters, ready for the kernel: the seeds (1 for an
    unstacked set), the dimensions, the device, the ctypes arguments of
    ``nlbac_node_euler_plan`` (layer counts, weight and bias pointer
    arrays, layer widths) and, from the first launch on, the plan it
    fills."""

    def __init__(self, n_s: int, n_u: int, device: torch.device,
                 c_args: tuple, seeds: int = 1):
        self.n_s, self.n_u, self.device, self.c_args = n_s, n_u, device, c_args
        self.seeds = seeds
        self._plan = None

    def plan(self):
        if self._plan is None:
            lib = load()
            plan = ctypes.create_string_buffer(
                lib.nlbac_node_euler_plan_bytes())
            err = lib.nlbac_node_euler_plan(plan, self.seeds, self.n_s,
                                            self.n_u, *self.c_args)
            if err != 0:
                raise ValueError(f"nlbac_node_euler_plan refused the "
                                 f"parameters: cudaError_t {err}")
            self._plan = plan
        return self._plan


# LaunchArgs by the parameters' (data_ptr, shape, stride, dtype, device):
# Adam updates the parameters in place and leaves every part of the key as
# it was, so the training loop builds and validates them once.
_launch_args: dict = {}
_LAUNCH_ARGS_KEPT = 16


def launch_args(params, x: torch.Tensor, u: torch.Tensor) -> LaunchArgs:
    """Check x and u, and return the parameters' LaunchArgs: from the
    cache when the parameters are the tensors last validated, else
    validated and built anew."""
    _check_rows(x, u)
    n_s, n_u = x.shape[-1], u.shape[-1]
    seeds = x.shape[0] if x.dim() == 3 else None
    fw, fb = _layers(params["f"])
    gw, gb = _layers(params["g"])
    key = (seeds, n_s, n_u, len(fw), len(gw)) + tuple(
        (t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
        for t in fw + fb + gw + gb)
    args = _launch_args.get(key)
    if args is None:
        _validate_params(params, n_s, n_u, x.device, seeds)

        def ptrs(ts):
            return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

        def dims(ws):
            d = [ws[0].shape[-2]] + [w.shape[-1] for w in ws]
            return (ctypes.c_int * len(d))(*d)

        args = LaunchArgs(n_s, n_u, x.device, (
            len(fw), ptrs(fw), ptrs(fb), dims(fw),
            len(gw), ptrs(gw), ptrs(gb), dims(gw)), seeds or 1)
        if len(_launch_args) >= _LAUNCH_ARGS_KEPT:
            _launch_args.clear()
        _launch_args[key] = args
    _check_tensors((x, u), args.device)
    return args


def tile_config(rows: int) -> int:
    """Index into TILE_CONFIGS of the tiles a call of ``rows`` rows (all
    seeds' rows) takes."""
    return 0 if rows <= SMALL_TILE_MAX_ROWS else 1


def _launch(args: LaunchArgs, x: torch.Tensor, u: torch.Tensor, dt: float,
            config: Optional[int] = None) -> torch.Tensor:
    """Run the CUDA kernel on inputs that ``launch_args`` checked, with the
    tiles of ``config`` (an index into TILE_CONFIGS; by default
    ``tile_config``)."""
    lib, plan = load(), args.plan()
    out = torch.empty_like(x)
    per_seed = x.shape[-2]
    rows = per_seed * args.seeds
    if config is None:
        config = tile_config(rows)
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = lib.nlbac_node_euler_run(plan, x.data_ptr(), u.data_ptr(),
                                   out.data_ptr(), per_seed, float(dt),
                                   config, stream)
    if err != 0:
        raise RuntimeError(f"node_euler kernel launch failed: cudaError_t "
                           f"{err}")
    count_launch(rows)
    return out


def node_euler_step_plain(params, x: torch.Tensor, u: torch.Tensor,
                          dt: float, compute_dtype=None) -> torch.Tensor:
    """The same function in plain PyTorch ops: the reference for the
    kernel, the CPU path and the recomputation behind the gradient."""
    # here, not at the top: nn/ imports this module
    from nlbac_tpu_torch.nn.mlp import mlp_apply

    n_s, n_u = x.shape[-1], u.shape[-1]
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
    f_x = mlp_apply(params["f"], x, compute_dtype=cdt)
    g_x = mlp_apply(params["g"], x, compute_dtype=cdt)
    g_x = g_x.reshape(g_x.shape[:-1] + (n_s, n_u))
    dx = f_x + torch.einsum("...ij,...j->...i", g_x, u)
    return x + dt * dx


class _NodeEulerFn(torch.autograd.Function):
    """Forward: the kernel (the plain version for CPU tensors). Backward:
    the plain field recomputed under autograd, as K1's custom VJP did."""

    @staticmethod
    def forward(ctx, x, u, dt, treedef, *leaves):
        params = _unflatten(treedef, leaves)
        ctx.save_for_backward(x, u, *leaves)
        ctx.dt, ctx.treedef = dt, treedef
        if x.is_cuda:
            return _launch(launch_args(params, x, u), x, u, dt)
        with torch.no_grad():
            return node_euler_step_plain(params, x, u, dt)

    @staticmethod
    def backward(ctx, grad_out):
        x, u, *leaves = ctx.saved_tensors
        needs = ctx.needs_input_grad
        inputs = [x, u] + list(leaves)
        wanted = [needs[0], needs[1]] + list(needs[4:])
        with torch.enable_grad():
            xs = [t.detach().requires_grad_(w) for t, w in zip(inputs, wanted)]
            y = node_euler_step_plain(_unflatten(ctx.treedef, xs[2:]),
                                      xs[0], xs[1], ctx.dt)
            req = [t for t, w in zip(xs, wanted) if w]
            grads = iter(torch.autograd.grad(y, req, grad_out)
                         if req else ())
        g = [next(grads) if w else None for w in wanted]
        return (g[0], g[1], None, None, *g[2:])


def _flatten(params):
    fw, fb = _layers(params["f"])
    gw, gb = _layers(params["g"])
    return (len(fw), len(gw)), fw + fb + gw + gb


def _unflatten(treedef, leaves):
    n_f, n_g = treedef
    leaves = list(leaves)
    fw, fb = leaves[:n_f], leaves[n_f:2 * n_f]
    gw, gb = leaves[2 * n_f:2 * n_f + n_g], leaves[2 * n_f + n_g:]
    return {"f": {"w": fw, "b": fb}, "g": {"w": gw, "b": gb}}


def node_euler_step(params, x: torch.Tensor, u: torch.Tensor, dt: float,
                    compute_dtype: Optional[str] = None) -> torch.Tensor:
    """x + dt * (f(x) + g(x) u) for control-affine NODE params
    ``{"f": mlp, "g": mlp}``; differentiable in params, x and u. Stacked
    params (a leading seed axis on every leaf) take x (S, B, n_s) and u
    (S, B, n_u): one launch for every seed.

    CUDA tensors go through the kernel or raise; CPU tensors take the
    plain version (in ``compute_dtype`` where one is given)."""
    if x.device.type == "cpu":
        if compute_dtype is not None:
            return node_euler_step_plain(params, x, u, dt, compute_dtype)
        treedef, leaves = _flatten(params)
        return _NodeEulerFn.apply(x, u, dt, treedef, *leaves)
    if x.device.type != "cuda":
        raise ValueError(f"node_euler_step runs on CUDA or the CPU, not "
                         f"{x.device}")
    _check_compute_dtype(compute_dtype)
    treedef, leaves = _flatten(params)
    return _NodeEulerFn.apply(x, u, dt, treedef, *leaves)
