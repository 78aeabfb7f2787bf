#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``nlbac_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits nonzero):

1. the card's name and power limit; TF32 off for matmuls and cuDNN;
2. build the NODE Euler kernel (csrc/node_euler.cu) with nvcc, printing
   ptxas's registers, shared memory and spills per kernel, and count the
   tensor-core (HMMA) instructions in its SASS;
3. hold the kernel against its plain PyTorch version on the card, forward
   and gradients, at the rows the main path gives it (128 and 32768), at
   the tile edges (1, 16, 17, 127, 129), at a ragged 1000 and at the
   switch between the small and large tiles and one either side, for the
   unicycle (3, 2) and pvtol (6, 2) dimensions;
4. time the kernel and the plain version (CUDA events, median of 30 runs,
   both replayed from a CUDA graph and issued from Python) beside the
   card's least time for the work (its bound, on the tensor cores and on
   the CUDA cores); the host's time per call; a sweep of every tile
   configuration over 128 to 32768 rows, each checked against the plain
   version;
5. the main path: train the unicycle preset at its full widths through the
   port's ``run_episode`` (launch counts reset just before, read just
   after); profile 10 more steps (device busy share, top device ops); then
   hold one full-width update on the card against the same update on the
   CPU;
6. a JSON line of the kernel's numbers, then the result line.

Needs a CUDA device; it exits nonzero without printing a result when there
is none, or when the ``nlbac_tpu_torch`` package is not beside it.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

from nlbac_tpu_torch.agent import create_train_state, make_agent
from nlbac_tpu_torch.agent.state import make_optimizers
from nlbac_tpu_torch.config import get_config
from nlbac_tpu_torch.nn import node_init
from nlbac_tpu_torch.ops import node_kernel
from nlbac_tpu_torch.replay import sample
from nlbac_tpu_torch.train import create_replays, make_episode_runner
from nlbac_tpu_torch.tree import tree_leaves, tree_map

# H100 SXM data-sheet peaks (dense): TF32 on the tensor cores, float32
# outside them, HBM3. The kernel takes three TF32 passes for float32
# accuracy, so its bound is the work at a third of the TF32 rate.
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version on the card, both float32 (torch.allclose form):
# the two sum each layer's 100 products in different orders.
KERNEL_RTOL, KERNEL_ATOL = 1e-5, 1e-5
# One full-width update on the card vs on the CPU: float32 on both, but
# cuBLAS and the CPU's BLAS sum in different orders and the difference
# passes through Adam's normalisation and the constraint's /dt.
UPDATE_RTOL, UPDATE_ATOL = 1e-3, 1e-4
EPISODES, EPISODE_STEPS = 5, 300
SEED = 0
SWEEP_ROWS = (128, 512, 2048, 4096, 8448, 32768)
HOST_CALLS = 1000


def phase(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def node_params(n_s, n_u, gen, dev):
    cfg = dataclasses.replace(get_config("unicycle").node, state_dim=n_s,
                              action_dim=n_u)
    params = node_init(gen, cfg, device=dev)
    # non-zero biases, so the kernel's bias path is exercised
    for net in params.values():
        for b in net["b"]:
            b.uniform_(-0.1, 0.1, generator=gen)
    return tree_map(lambda p: p.requires_grad_(True), params)


def work(params, rows, n_s, n_u):
    """(FLOP, bytes) the Euler step needs: every layer's multiply-adds, the
    g.u contraction and the update; x, u and the weights read once and x'
    written once."""
    macs = sum(w.shape[0] * w.shape[1]
               for net in params.values() for w in net["w"])
    flops = 2 * rows * (macs + n_s * n_u + n_s)
    nbytes = 4 * (rows * (2 * n_s + n_u)
                  + sum(p.numel() for p in tree_leaves(params)))
    return flops, nbytes


def bound(flops, nbytes, peak_flops=PEAK_TF32_FLOPS / TF32_PASSES):
    """(ms, what bounds it): the larger of the work's time at
    ``peak_flops`` and its bytes' time at the memory rate."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def time_ms(fn, runs=30, inner=10):
    """(device ms, call ms): medians over ``runs`` of the per-call time of
    ``inner`` calls, from CUDA events. Device: the calls captured in a CUDA
    graph and replayed, so the host does not pace them. Call: the calls
    issued from Python, as the training loop issues them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()

    def median(step):
        step()
        times = []
        for _ in range(runs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            step()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / inner)
        return statistics.median(times)

    def issue():
        for _ in range(inner):
            fn()

    return median(graph.replay), median(issue)


def check_rows():
    """The row counts phase 3 checks: the main path's, the 16-row tile's
    edges, a ragged count, and both sides of the small/large tile
    switch."""
    switch = node_kernel.SMALL_TILE_MAX_ROWS
    return sorted({1, 16, 17, 127, 128, 129, 1000, switch - 1, switch,
                   switch + 1, 32768})


def check_kernel(dev, gen):
    """Kernel vs plain version: forward and gradients. Returns the largest
    forward error."""
    worst = 0.0
    for (n_s, n_u), rows in itertools.product(((3, 2), (6, 2)),
                                              check_rows()):
        params = node_params(n_s, n_u, gen, dev)
        x = torch.randn(rows, n_s, device=dev, generator=gen)
        u = (torch.rand(rows, n_u, device=dev, generator=gen) * 2 - 1) * 3.5
        u.requires_grad_(True)
        cot = torch.randn(rows, n_s, device=dev, generator=gen)
        y_k = node_kernel.node_euler_step(params, x, u, 0.02)
        y_p = node_kernel.node_euler_step_plain(params, x, u, 0.02)
        torch.cuda.synchronize()
        err = (y_k - y_p).abs().max().item()
        rel = ((y_k - y_p).abs() / y_p.abs().clamp_min(1e-6)).max().item()
        torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL,
                                   atol=KERNEL_ATOL)
        inputs = [u] + tree_leaves(params)
        g_k = torch.autograd.grad((y_k * cot).sum(), inputs)
        g_p = torch.autograd.grad((y_p * cot).sum(), inputs)
        g_err = max((a - b).abs().max().item() for a, b in zip(g_k, g_p))
        for a, b in zip(g_k, g_p):
            torch.testing.assert_close(a, b, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL)
        worst = max(worst, err)
        tiles = node_kernel.TILE_CONFIGS[node_kernel.tile_config(rows)]
        phase(f"check (n_s,n_u)=({n_s},{n_u}) rows={rows} tiles {tiles}: "
              f"forward max abs err {err:.3e} max rel err {rel:.3e}, "
              f"gradient max abs err {g_err:.3e} (tolerance rtol "
              f"{KERNEL_RTOL} atol {KERNEL_ATOL}) ok")
    return worst


def tensor_core_check(lib):
    """Counts the tensor-core instructions (HMMA) in the built library's
    SASS; fails if there are none."""
    cuobjdump = Path(node_kernel._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    per_kernel, name = collections.Counter(), None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif "HMMA" in line:
            per_kernel[name] += 1
    if not per_kernel:
        raise RuntimeError(f"no HMMA instruction in the SASS of {lib.name}")
    phase(f"tensor cores: {sum(per_kernel.values())} HMMA instructions in "
          f"{len(per_kernel)} kernels of {lib.name} ("
          + ", ".join(f"{n}" for n in per_kernel.values()) + " each)")


def host_us(fn, calls=HOST_CALLS):
    """Host microseconds per call: a host clock around ``calls`` calls,
    with no synchronize inside."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_kernel(dev, gen, card):
    out = {}
    for rows in (128, 32768):
        params = node_params(3, 2, gen, dev)
        x = torch.randn(rows, 3, device=dev, generator=gen)
        u = torch.randn(rows, 2, device=dev, generator=gen)
        with torch.no_grad():
            ms, call_ms = time_ms(lambda: node_kernel.node_euler_step(
                params, x, u, 0.02))
            plain_ms, plain_call_ms = time_ms(
                lambda: node_kernel.node_euler_step_plain(params, x, u, 0.02))
        flops, nbytes = work(params, rows, 3, 2)
        bound_ms, bound_by = bound(flops, nbytes)
        bound_f32_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
        out[rows] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "bound_tc_ms": bound_ms,
                     "bound_f32_ms": bound_f32_ms, "call_ms": call_ms,
                     "plain_call_ms": plain_call_ms}
        phase(f"time rows={rows}: device kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms; issued from Python kernel {call_ms:.4f} "
              f"ms, plain {plain_call_ms:.4f} ms; bound {bound_ms:.5f} ms "
              f"on the tensor cores ({bound_by}; 3 TF32 passes at "
              f"{PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s), {bound_f32_ms:.5f} "
              f"ms on the CUDA cores; {flops / 1e9:.3f} GFLOP, "
              f"{nbytes / 1e6:.3f} MB; {flops / ms / 1e9:.2f} TFLOP/s "
              f"achieved, {bound_ms / ms:.1%} of the bound, on {card}")
        if rows == 128:
            u_grad = u.clone().requires_grad_(True)
            with torch.no_grad():
                us_nograd = host_us(lambda: node_kernel.node_euler_step(
                    params, x, u, 0.02))
            us_grad = host_us(lambda: node_kernel.node_euler_step(
                params, x, u_grad, 0.02))
            out[rows]["host_us_per_call"] = us_grad
            out[rows]["host_us_per_call_no_grad"] = us_nograd
            phase(f"host time per call at rows=128 ({HOST_CALLS} calls, no "
                  f"synchronize inside): {us_grad:.2f} us with u requiring "
                  f"a gradient (as the policy-loss rollout calls it), "
                  f"{us_nograd:.2f} us under no_grad, on {card}")
    return out


def sweep(dev, gen, card):
    """Device ms of every tile configuration at SWEEP_ROWS (unicycle
    dimensions), each checked against the plain version first."""
    for rows in SWEEP_ROWS:
        params = node_params(3, 2, gen, dev)
        x = torch.randn(rows, 3, device=dev, generator=gen)
        u = torch.randn(rows, 2, device=dev, generator=gen)
        cells = []
        with torch.no_grad():
            args = node_kernel.launch_args(params, x, u)
            y_p = node_kernel.node_euler_step_plain(params, x, u, 0.02)
            for cfg, tiles in enumerate(node_kernel.TILE_CONFIGS):
                y_k = node_kernel._launch(args, x, u, 0.02, cfg)
                torch.testing.assert_close(y_k, y_p, rtol=KERNEL_RTOL,
                                           atol=KERNEL_ATOL)
                ms, _ = time_ms(lambda: node_kernel._launch(
                    args, x, u, 0.02, cfg))
                cells.append(f"{tiles} {ms:.4f}")
        flops, nbytes = work(params, rows, 3, 2)
        tc_ms, _ = bound(flops, nbytes)
        f32_ms, _ = bound(flops, nbytes, PEAK_F32_FLOPS)
        picked = node_kernel.TILE_CONFIGS[node_kernel.tile_config(rows)]
        phase(f"sweep rows={rows}: device ms by (tile rows, warps): "
              + "; ".join(cells) + f"; the wrapper picks {picked}; bound "
              f"{tc_ms:.5f} ms (tensor cores), {f32_ms:.5f} ms (CUDA "
              f"cores); on {card}")


def to_device(ts, cfg, dev):
    """A copy of a TrainState on ``dev`` with fresh optimizers (the source
    state's optimizers must be fresh too)."""
    def move(p):
        return p.detach().to(dev, copy=True).requires_grad_(p.requires_grad)
    fields = {name: tree_map(move, getattr(ts, name)) for name in (
        "policy", "backup_policy", "critic", "critic_target", "lyap",
        "lyap_target", "barrier", "barrier_target", "node", "log_alpha",
        "backup_log_alpha")}
    return type(ts)(**fields, opt=make_optimizers(cfg, fields),
                    lag=type(ts.lag)(*(t.to(dev, copy=True) for t in ts.lag)),
                    updates=ts.updates)


def main_path(dev, card):
    """Unicycle at the preset's full widths through run_episode."""
    cfg = get_config("unicycle")
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, max_episode_steps=EPISODE_STEPS))
    gen = torch.Generator(dev).manual_seed(SEED)
    ts = create_train_state(cfg, gen, dev)
    rl, node = create_replays(cfg, dev)
    base = make_agent(cfg, dev)
    node_losses = []

    def update(*args, **kw):
        ts_, m = base.update(*args, **kw)
        node_losses.append(m["node_loss"])
        return ts_, m

    run = make_episode_runner(cfg, dev, agent=base._replace(update=update))
    total = updates = 0
    node_kernel.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for ep in range(EPISODES):
        ts, rl, node, m, total = run(ts, rl, node, gen, ep, total)
        train = {k: v.item() for k, v in m.train.items()}
        bad = [k for k, v in train.items() if not math.isfinite(v)]
        if bad or not math.isfinite(m.reward.item()):
            raise RuntimeError(f"episode {ep}: non-finite metrics {bad}")
        updates += m.updates_done
        phase(f"episode {ep}: steps {m.steps} reward {m.reward.item():.3f} "
              f"violations {m.num_violations.item():.0f} updates "
              f"{m.updates_done} qf1 {train['qf1_loss']:.4g} policy "
              f"{train['policy_loss']:.4g} constraint "
              f"{train['constraint_loss']:.4g} alpha {train['alpha']:.4g}")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = node_kernel.launch_counts["node_euler"]
    fits = torch.stack(node_losses)
    n_fits = int((fits > 0).sum())
    if updates <= 0 or not bool(torch.isfinite(fits).all()):
        raise RuntimeError(f"updates {updates}, NODE losses finite "
                           f"{bool(torch.isfinite(fits).all())}")
    if n_fits < 10 or launches <= 0:
        raise RuntimeError(f"{n_fits} NODE fits, {launches} kernel launches")
    phase(f"main path: {total} env steps, {updates} updates, {n_fits} NODE "
          f"fits of {cfg.node.max_batch} rows (last loss "
          f"{fits[fits > 0][-1].item():.4g}), {launches} kernel launches "
          f"({launches / total:.2f} per env step), {seconds:.2f} s, "
          f"{total / seconds:.2f} env-steps/s on {card}")
    return cfg, ts, rl, node, launches


def profile_steps(cfg, ts, rl, node, dev, card, steps=10):
    """A torch.profiler window of ``steps`` env steps of the trained agent
    (updates on, the policy acting): the device's busy share of the window
    and the ops that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    short = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, max_episode_steps=steps))
    run = make_episode_runner(short, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 3)
    run(ts, rl, node, gen, EPISODES, 10 ** 6)  # warm-up, not profiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, _, m, _ = run(ts, rl, node, gen, EPISODES, 10 ** 6)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side kernel and copy records; user annotations (e.g. the
    # optimizer's step range) also carry device spans and would count twice
    spans = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA and not e.is_user_annotation:
            spans[e.name] += e.time_range.elapsed_us() / 1e6
    busy = sum(spans.values())
    if busy <= 0:
        phase("profile: the profiler recorded no device time (not measured)")
        return
    kern = sum(v for k, v in spans.items() if "node_euler" in k)
    tops = "; ".join(f"{k[:40]} {v * 1e3:.2f} ms"
                     for k, v in spans.most_common(5))
    phase(f"profile: {m.steps} env steps, {m.updates_done} updates in "
          f"{wall:.3f} s under the profiler; device busy {busy:.4f} s "
          f"({busy / wall:.1%} of the window, idle {1 - busy / wall:.1%}); "
          f"node_euler kernel {kern * 1e3:.3f} ms; top device ops: {tops} "
          f"on {card}")


def update_on_card_vs_cpu(cfg, rl, node, dev):
    """One full-width update from a fresh state on the card (kernel) and
    on the CPU (plain version), with the same batches and draws."""
    gen_cpu = torch.Generator().manual_seed(SEED + 1)
    ts_cpu = create_train_state(cfg, gen_cpu, "cpu")
    ts_dev = to_device(ts_cpu, cfg, dev)
    gen = torch.Generator(dev).manual_seed(SEED + 2)
    batch = sample(rl, gen, cfg.sac.batch_size)
    node_batch = sample(node, gen, cfg.node.max_batch)
    noise = {k: torch.randn(cfg.sac.batch_size, cfg.action_dim,
                            generator=gen_cpu)
             for k in ("next", "pi", "backup")}

    def run(ts, device):
        agent = make_agent(cfg, device)
        to = {k: v.to(device) for k, v in noise.items()}
        nb = {k: v.to(device) for k, v in node_batch.items()}
        b = {k: v.to(device) for k, v in batch.items()}
        _, m = agent.update_core(ts, b, lambda: nb, None, 0, noise=to)
        return {k: v.item() for k, v in m.items()}

    m_dev, m_cpu = run(ts_dev, dev), run(ts_cpu, "cpu")
    worst = 0.0
    for k in m_cpu:
        err = abs(m_dev[k] - m_cpu[k])
        worst = max(worst, err / (UPDATE_ATOL + UPDATE_RTOL * abs(m_cpu[k])))
        if err > UPDATE_ATOL + UPDATE_RTOL * abs(m_cpu[k]):
            raise RuntimeError(f"update metric {k}: card {m_dev[k]} vs CPU "
                               f"{m_cpu[k]}")
    phase(f"full-width update, card vs CPU: 11 metrics within rtol "
          f"{UPDATE_RTOL} atol {UPDATE_ATOL} (worst at {worst:.3f} of the "
          f"tolerance; node_loss {m_dev['node_loss']:.6g} vs "
          f"{m_cpu['node_loss']:.6g}) ok")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase(card)
    phase(f"tf32: matmul {torch.backends.cuda.matmul.allow_tf32}, cudnn "
          f"{torch.backends.cudnn.allow_tf32}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    lib = node_kernel.build(verbose=True)
    phase(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")
    tensor_core_check(lib)

    gen = torch.Generator(dev).manual_seed(SEED)
    max_err = check_kernel(dev, gen)
    times = time_kernel(dev, gen, card)
    sweep(dev, gen, card)
    cfg, ts, rl, node, launches = main_path(dev, card)
    profile_steps(cfg, ts, rl, node, dev, card)
    update_on_card_vs_cpu(cfg, rl, node, dev)

    big = times[32768]
    print(json.dumps({"kernels": [{
        "name": "node_euler", "route": "cuda",
        "source": "nlbac_tpu_torch/csrc/node_euler.cu",
        "replaces": "nlbac_tpu/ops/node_kernel.py:104",
        "launches": launches, "max_abs_err": max_err,
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None, "rows": 32768,
        "call_ms": big["call_ms"], "plain_call_ms": big["plain_call_ms"],
        "bound_tc_ms": big["bound_tc_ms"],
        "bound_f32_ms": big["bound_f32_ms"],
        "host_us_per_call": times[128]["host_us_per_call"],
        "at_128_rows": times[128]}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
