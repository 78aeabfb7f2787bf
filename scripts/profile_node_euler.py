#!/usr/bin/env python3
"""Where the NODE Euler kernel's time goes, on one NVIDIA GPU.

    python3 scripts/profile_node_euler.py

Three reports, each line naming the card and its power limit:

1. mma.sync m16n8k8 TF32 on this card: the cycles from one product to the
   next that depends on it (latency), and the cycles per product on one SM
   sub-partition with enough independent products in flight (throughput).
2. The kernel's phases (nlbac_tpu_torch/csrc/node_euler.cu): a copy of the
   source with clock64() stamps at each phase, built into
   nlbac_tpu_torch/_build/, run at 128 and 32768 rows with the tiles the
   wrapper picks. For the f block (cluster rank 0) and g block (rank 1) of
   the first row tile: the prologue (barrier set-up, x, u and the first
   weights requested), then per layer the wait for its weights and its
   run (the next layer's copies started, the products, the epilogue), then
   the tail (g.u handed over, x' written), in SM cycles; the first layer's
   wait includes the first loads of x, u and the weights.
3. The wrapper's host time per call at 128 rows, piece by piece (host clock
   around 1000 calls, no synchronize inside).

Needs a CUDA device and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from chip_smoke import card_line, host_us  # noqa: E402
from nlbac_tpu_torch.config import get_config  # noqa: E402
from nlbac_tpu_torch.nn import node_init  # noqa: E402
from nlbac_tpu_torch.ops import node_kernel as nk  # noqa: E402

OUT = nk._BUILD_DIR / "profile"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3"]

MMA_BENCH = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
template <int CHAINS>
__global__ void chains(float* out, long long* cycles, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = __float_as_uint(1e-3f * (i + 1));
  for (int i = 0; i < 2; ++i) b[i] = __float_as_uint(1e-3f * (i + 2));
  float acc[CHAINS][4] = {};
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(acc[c][0]), "+f"(acc[c][1]), "+f"(acc[c][2]),
            "+f"(acc[c][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  __syncthreads();
  const long long t1 = clock64();
  float s = 0.f;
  for (int c = 0; c < CHAINS; ++c)
    s += acc[c][0] + acc[c][1] + acc[c][2] + acc[c][3];
  out[threadIdx.x] = s;
  if (threadIdx.x == 0) *cycles = t1 - t0;
}
template <int CHAINS>
void run(int warps, float* out, long long* cycles, const char* what) {
  const int iters = 2000;
  long long c = 0;
  for (int rep = 0; rep < 2; ++rep) {
    chains<CHAINS><<<1, 32 * warps>>>(out, cycles, iters);
    cudaMemcpy(&c, cycles, sizeof c, cudaMemcpyDeviceToHost);
  }
  const double per_warp = (double)c / iters / CHAINS;
  printf("mma.sync m16n8k8 tf32, %s (%d warp(s), %d chain(s) each): %.2f "
         "cycles a product per warp, %.2f per SM sub-partition\n",
         what, warps, CHAINS, per_warp,
         per_warp * 4 / (warps < 4 ? 4 : warps));
}
int main() {
  float* out;
  long long* cycles;
  cudaMalloc(&out, 4096 * sizeof(float));
  cudaMalloc(&cycles, sizeof(long long));
  run<1>(1, out, cycles, "latency");
  run<8>(1, out, cycles, "throughput");
  run<8>(8, out, cycles, "throughput");
  const cudaError_t e = cudaDeviceSynchronize();
  printf("%s\n", cudaGetErrorString(e));
  return e != cudaSuccess;
}
"""

# (anchor in node_euler.cu, stamp inserted after it); slot 0: the block's
# start, 1: the prologue's copies issued, 2+2l: layer l's weights in place,
# 3+2l: layer l done, 20: the block's end
STAMPS = [
    ("namespace {\n",
     "__device__ long long g_stamps[2][24];\n"
     "#define STAMP(slot) if (threadIdx.x == 0 && blockIdx.x < 2) "
     "g_stamps[blockIdx.x][slot] = clock64();\n"),
    ("  const int row0 = (blockIdx.x >> 1) * TM;\n", "  STAMP(0)\n"),
    ("  if (producer) stage(net, 0, wbuf0, &bars[0], tid & 31);\n",
     "  STAMP(1)\n"),
    ("    __syncthreads();  // layer l's weights and input are in place\n",
     "    STAMP(2 + 2 * l)\n"),
    ("                    net.np[l], l + 1 < net.n);\n",
     "      STAMP(3 + 2 * l)\n"),
    ("    mbar_arrive_cluster(map_rank(&bars[2], 0));\n", "    STAMP(20)\n"),
    ("      out[row0 * n_s + i] = io[i] + a.dt * (act[r * lda + j] + gu[i]);"
     "\n  }\n", "  STAMP(20)\n"),
]


def nvcc(src: Path, out: Path, *extra: str) -> None:
    res = subprocess.run([nk._nvcc(), *NVCC_FLAGS, *extra, "-o", str(out),
                          str(src)], capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")


def mma_report(card: str) -> None:
    src = OUT / "mma_bench.cu"
    src.write_text(MMA_BENCH)
    nvcc(src, OUT / "mma_bench")
    res = subprocess.run([str(OUT / "mma_bench")], capture_output=True,
                         text=True, check=True, timeout=120)
    for line in res.stdout.strip().splitlines()[:-1]:
        print(f"{line} on {card}")


def phase_report(card: str) -> None:
    src = nk._SOURCE.read_text()
    for anchor, stamp in STAMPS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"stamp anchor not found once: {anchor!r}")
        src = src.replace(anchor, anchor + stamp)
    src += ('extern "C" int nlbac_stamps(long long* out) {\n'
            '  return (int)cudaMemcpyFromSymbol(out, g_stamps, '
            'sizeof(g_stamps));\n}\n')
    cu = OUT / "node_euler_stamped.cu"
    cu.write_text(src)
    so = OUT / "libnode_euler_stamped.so"
    nvcc(cu, so, "-shared", "-Xcompiler", "-fPIC")
    lib = nk._bind(ctypes.CDLL(str(so)))
    nk._lib = lib  # launches below go through the stamped copy
    stamps = (ctypes.c_longlong * 48)()
    cfg = get_config("unicycle").node
    gen = torch.Generator("cuda").manual_seed(0)
    params = node_init(gen, cfg, device="cuda")
    for rows in (128, 32768):
        x = torch.randn(rows, cfg.state_dim, device="cuda", generator=gen)
        u = torch.randn(rows, cfg.action_dim, device="cuda", generator=gen)
        with torch.no_grad():
            args = nk.launch_args(params, x, u)
            for _ in range(3):
                nk._launch(args, x, u, 0.02)
        torch.cuda.synchronize()
        if lib.nlbac_stamps(stamps) != 0:
            raise RuntimeError("could not read the stamps")
        tiles = nk.TILE_CONFIGS[nk.tile_config(rows)]
        for rank, (name, net) in enumerate((("f", params["f"]),
                                            ("g", params["g"]))):
            s = stamps[24 * rank:24 * rank + 24]
            n = len(net["w"])
            parts = [f"prologue {s[1] - s[0]}"]
            for layer in range(n):
                ready, done = s[2 + 2 * layer], s[3 + 2 * layer]
                parts.append(f"L{layer} wait {ready - s[1 + 2 * layer]} run "
                             f"{done - ready}")
            parts.append(f"tail {s[20] - s[1 + 2 * n]}; total "
                         f"{s[20] - s[0]}")
            print(f"phases rows={rows} tiles {tiles} {name} block, SM "
                  f"cycles: " + "; ".join(parts) + f" on {card}")
    nk._lib = None
    nk._launch_args.clear()


def host_report(card: str) -> None:
    cfg = get_config("unicycle").node
    gen = torch.Generator("cuda").manual_seed(0)
    params = node_init(gen, cfg, device="cuda")
    for net in params.values():
        for t in net["w"] + net["b"]:
            t.requires_grad_(True)
    x = torch.randn(128, cfg.state_dim, device="cuda", generator=gen)
    u = torch.randn(128, cfg.action_dim, device="cuda", generator=gen)
    u_grad = u.clone().requires_grad_(True)
    args = nk.launch_args(params, x, u)
    with torch.no_grad():
        pieces = {
            "launch_args (cache hit)": lambda: nk.launch_args(params, x, u),
            "_launch (plan, output, stream, C call)":
                lambda: nk._launch(args, x, u, 0.02),
            "node_euler_step under no_grad":
                lambda: nk.node_euler_step(params, x, u, 0.02),
        }
        times = {k: host_us(f) for k, f in pieces.items()}
    times["node_euler_step, u and params requiring grad"] = host_us(
        lambda: nk.node_euler_step(params, x, u_grad, 0.02))
    print("host us per call at rows=128: " + "; ".join(
        f"{k} {v:.2f}" for k, v in times.items()) + f" on {card}")


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_node_euler: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    OUT.mkdir(parents=True, exist_ok=True)
    card = card_line()
    print(card)
    mma_report(card)
    phase_report(card)
    host_report(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
