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
version runs only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

_SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "node_euler.cu"
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
MAX_LAYERS = 8  # kMaxLayers in the CUDA source
MAX_WIDTH = 128  # kMaxWidth in the CUDA source

# Kernel launches made through ``node_euler_step`` since the last reset.
launch_counts = {"node_euler": 0}

_lib = None


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0


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


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.nlbac_node_euler
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_float, ctypes.c_int, p, p, p, ctypes.c_int,
                       p, p, p, p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _layers(net):
    return list(net["w"]), list(net["b"])


def validate(params, x: torch.Tensor, u: torch.Tensor,
             compute_dtype: Optional[str] = None) -> None:
    """Raise unless the kernel takes these inputs: float32, contiguous, on
    one device, f32 compute, (B, n_s) and (B, n_u) rows and the layer
    widths within the compiled limits."""
    if compute_dtype is not None:
        raise ValueError(
            f"the node_euler kernel computes in float32 only "
            f"(compute_dtype={compute_dtype!r})")
    if x.dim() != 2 or u.dim() != 2 or x.shape[0] != u.shape[0]:
        raise ValueError(f"x must be (B, n_s) and u (B, n_u), got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    n_s, n_u = x.shape[1], u.shape[1]
    tensors = [x, u]
    for name, out_dim in (("f", n_s), ("g", n_s * n_u)):
        ws, bs = _layers(params[name])
        if not 1 <= len(ws) <= MAX_LAYERS or len(bs) != len(ws):
            raise ValueError(f"{name}_net must have 1..{MAX_LAYERS} layers, "
                             f"got {len(ws)}")
        prev = n_s
        for w, b in zip(ws, bs):
            if w.dim() != 2 or w.shape[0] != prev or \
                    tuple(b.shape) != (w.shape[1],):
                raise ValueError(f"{name}_net layer shapes do not chain: "
                                 f"{tuple(w.shape)}, {tuple(b.shape)}")
            if w.shape[1] > MAX_WIDTH:
                raise ValueError(f"{name}_net width {w.shape[1]} exceeds "
                                 f"the kernel's {MAX_WIDTH}")
            prev = w.shape[1]
        if prev != out_dim:
            raise ValueError(f"{name}_net ends at {prev}, expected {out_dim}")
        tensors += ws + bs
    if n_s + n_u > MAX_WIDTH:
        raise ValueError(f"n_s + n_u = {n_s + n_u} exceeds {MAX_WIDTH}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise ValueError(f"node_euler takes float32 tensors, got {t.dtype}")
        if t.device != x.device:
            raise ValueError("node_euler inputs must share one device")
        if not t.is_contiguous():
            raise ValueError("node_euler inputs must be contiguous")


def _launch(params, x: torch.Tensor, u: torch.Tensor, dt: float
            ) -> torch.Tensor:
    """Run the CUDA kernel; inputs already validated."""
    fn = _load().nlbac_node_euler
    out = torch.empty_like(x)
    fw, fb = _layers(params["f"])
    gw, gb = _layers(params["g"])

    def ptrs(ts):
        return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])

    def dims(ws):
        d = [ws[0].shape[0]] + [w.shape[1] for w in ws]
        return (ctypes.c_int * len(d))(*d)

    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), u.data_ptr(), out.data_ptr(), x.shape[0],
             x.shape[1], u.shape[1], float(dt), len(fw), ptrs(fw), ptrs(fb),
             dims(fw), len(gw), ptrs(gw), ptrs(gb), dims(gw), stream)
    if err != 0:
        raise RuntimeError(f"node_euler kernel launch failed: cudaError_t "
                           f"{err}")
    launch_counts["node_euler"] += 1
    return out


def _mlp(net, x, cdt):
    """ReLU MLP over (in, out) weights, as ``nn.mlp.mlp_apply``."""
    out_dtype = x.dtype
    if cdt is not None:
        x = x.to(cdt)
    n = len(net["w"])
    for i, (w, b) in enumerate(zip(net["w"], net["b"])):
        if cdt is not None:
            w, b = w.to(cdt), b.to(cdt)
        x = x @ w + b
        if i < n - 1:
            x = torch.relu(x)
    return x.to(out_dtype)


def node_euler_step_plain(params, x: torch.Tensor, u: torch.Tensor,
                          dt: float, compute_dtype=None) -> torch.Tensor:
    """The same function in plain PyTorch ops: the reference for the
    kernel, the CPU path and the recomputation behind the gradient."""
    n_s, n_u = x.shape[-1], u.shape[-1]
    cdt = torch.bfloat16 if compute_dtype == "bfloat16" else None
    f_x = _mlp(params["f"], x, cdt)
    g_x = _mlp(params["g"], x, cdt)
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
            return _launch(params, x, u, dt)
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
    ``{"f": mlp, "g": mlp}``; differentiable in params, x and u.

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
    validate(params, x, u, compute_dtype)
    treedef, leaves = _flatten(params)
    return _NodeEulerFn.apply(x, u, dt, treedef, *leaves)
