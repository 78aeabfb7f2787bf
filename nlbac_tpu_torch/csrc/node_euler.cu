// Control-affine NODE Euler step, x' = x + dt * (f(x) + g(x) u), as one
// CUDA kernel for Hopper (sm_90a).
//
// Replaces K1, the JAX package's Pallas kernel `_kernel` /
// `fused_field_euler_raw` / `fused_euler_step` in
// nlbac_tpu/ops/node_kernel.py (added in 32ce358, deleted in 2150bab; read
// it with `git show b6e9040:nlbac_tpu/ops/node_kernel.py`). It computes the
// same function as nlbac_tpu.nn.node.predict_next_state for the
// control_affine field under one Euler step: f_net (n_s -> H ... H -> n_s,
// ReLU between layers) and g_net (n_s -> H ... H -> n_s*n_u), g reshaped
// row-major to (n_s, n_u) so that dx_j = f_j + sum_k g[:, j*n_u + k] u_k.
// Weights arrive in the JAX layout: W (in, out) row-major, b (out,).
//
// Bound on an H100 SXM at the unicycle preset (n_s=3, n_u=2, H=100, f_net
// 5 layers, g_net 4): 51,500 multiply-adds a row, about 1.03e5 FLOP, so
// 3.4 GFLOP for a 32768-row call. Its bytes are about 1 MB (x, u, x' and
// 206 KB of weights). At the 67 TFLOP/s float32 peak outside the tensor
// cores that is about 50 us, against 0.3 us for the bytes: the call is
// bound by operations. A 128-row call is 13 MFLOP and is bound by launch
// latency and by the nine dependent layers, not by either rate.
//
// Design. One block of 256 threads takes a tile of 8*RPT rows. The tile's
// activations stay in shared memory, ping-ponging between two buffers, so
// device memory sees one read of x, u and the weights and one write of x'.
// Both nets' weights (51.5 k floats, 206 KB) do not fit beside the
// activations in 227 KB, so one layer's weights at a time are staged into
// shared memory, zero-padded to a multiple of 32 columns. Each warp owns
// RPT rows and each lane 4 columns (col = lane + 32*m): the lane reads its
// rows' activations as shared-memory broadcasts and its weights from
// consecutive addresses, and accumulates RPT*4 outputs in registers with
// float32 FMAs on the CUDA cores (no TF32, to keep float32 parity with the
// JAX package). The host picks RPT=8 (64-row tiles) when the batch fills
// the card's 132 SMs and RPT=2 (16-row tiles) below that, so a 128-row
// call still spreads over 8 SMs. The ragged last tile is masked on load
// and on store. TPU tiling (128x128 MXU padding) has no purpose here and
// is not carried over.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;  // widest layer (hidden, n_s*n_u, n_s+n_u)
constexpr int kThreads = 256;   // 8 warps

struct Net {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int dims[kMaxLayers + 1];
  int n;
};

struct Args {
  const float* x;
  const float* u;
  float* out;
  int B, n_s, n_u;
  float dt;
  Net f, g;
  int ld;   // leading dimension of the activation buffers
  int wsz;  // floats of the weight stage
};

__host__ __device__ inline int pad32(int n) { return (n + 31) & ~31; }

// out[r, :N] = act(in[r, :K] @ W + b) for the tile's rows.
template <int RPT>
__device__ void layer(const float* in, int ld_in, int K,
                      const float* __restrict__ W,
                      const float* __restrict__ bias, int N, float* ws,
                      float* bs, float* out, int ld_out, bool relu) {
  const int NP = pad32(N);
  for (int i = threadIdx.x; i < K * NP; i += kThreads) {
    const int k = i / NP, n = i - k * NP;
    ws[i] = n < N ? W[k * N + n] : 0.f;
  }
  for (int i = threadIdx.x; i < NP; i += kThreads) bs[i] = i < N ? bias[i] : 0.f;
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nm = NP >> 5;
  const float* in_rows = in + warp * RPT * ld_in;
  float acc[RPT][4];
#pragma unroll
  for (int q = 0; q < RPT; ++q)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[q][m] = 0.f;

  for (int k = 0; k < K; ++k) {
    float a[RPT];
#pragma unroll
    for (int q = 0; q < RPT; ++q) a[q] = in_rows[q * ld_in + k];
    float w[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) w[m] = m < nm ? ws[k * NP + lane + 32 * m] : 0.f;
#pragma unroll
    for (int q = 0; q < RPT; ++q)
#pragma unroll
      for (int m = 0; m < 4; ++m) acc[q][m] = fmaf(a[q], w[m], acc[q][m]);
  }

#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int r = warp * RPT + q;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int c = lane + 32 * m;
      if (m < nm && c < N) {
        float v = acc[q][m] + bs[c];
        if (relu) v = fmaxf(v, 0.f);
        out[r * ld_out + c] = v;
      }
    }
  }
  __syncthreads();
}

// Runs every layer of `net` on the tile; returns the buffer holding the
// last layer's output (leading dimension `ld`, or `last`/`ld_last` when
// given).
template <int RPT>
__device__ const float* run_net(const Net& net, const float* in, int ld_in,
                                float* buf0, float* buf1, int ld, float* ws,
                                float* bs, float* last, int ld_last) {
  const float* cur = in;
  int ld_cur = ld_in;
  for (int l = 0; l < net.n; ++l) {
    const bool final_layer = l == net.n - 1;
    float* dst = (final_layer && last) ? last : ((l & 1) ? buf1 : buf0);
    const int ld_dst = (final_layer && last) ? ld_last : ld;
    layer<RPT>(cur, ld_cur, net.dims[l], net.w[l], net.b[l], net.dims[l + 1],
               ws, bs, dst, ld_dst, !final_layer);
    cur = dst;
    ld_cur = ld_dst;
  }
  return cur;
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
node_euler_kernel(const Args a) {
  constexpr int TB = 8 * RPT;
  extern __shared__ float smem[];
  const int nsu = a.n_s + a.n_u;
  float* buf0 = smem;
  float* buf1 = buf0 + TB * a.ld;
  float* ws = buf1 + TB * a.ld;
  float* bs = ws + a.wsz;
  float* xu = bs + kMaxWidth;
  float* fo = xu + TB * nsu;

  const int row0 = blockIdx.x * TB;
  for (int i = threadIdx.x; i < TB * nsu; i += kThreads) {
    const int r = i / nsu, c = i - r * nsu, gr = row0 + r;
    float v = 0.f;
    if (gr < a.B) v = c < a.n_s ? a.x[gr * a.n_s + c] : a.u[gr * a.n_u + (c - a.n_s)];
    xu[i] = v;
  }
  __syncthreads();

  // f_net -> fo (TB x n_s); g_net -> a ping-pong buffer (TB x n_s*n_u)
  run_net<RPT>(a.f, xu, nsu, buf0, buf1, a.ld, ws, bs, fo, a.n_s);
  const float* go = run_net<RPT>(a.g, xu, nsu, buf0, buf1, a.ld, ws, bs, nullptr, 0);

  for (int i = threadIdx.x; i < TB * a.n_s; i += kThreads) {
    const int r = i / a.n_s, j = i - r * a.n_s, gr = row0 + r;
    if (gr >= a.B) continue;
    const float* grow = go + r * a.ld + j * a.n_u;
    const float* urow = xu + r * nsu + a.n_s;
    float s = 0.f;
    for (int k = 0; k < a.n_u; ++k) s = fmaf(grow[k], urow[k], s);
    const float dx = fo[r * a.n_s + j] + s;
    a.out[gr * a.n_s + j] = xu[r * nsu + j] + a.dt * dx;
  }
}

bool fill_net(Net& net, int n, const void* const* w, const void* const* b,
              const int* dims) {
  if (n < 1 || n > kMaxLayers) return false;
  net.n = n;
  for (int l = 0; l < n; ++l) {
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(b[l]);
  }
  for (int l = 0; l <= n; ++l) {
    if (dims[l] < 1 || dims[l] > kMaxWidth) return false;
    net.dims[l] = dims[l];
  }
  return true;
}

template <int RPT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int TB = 8 * RPT;
  const int nsu = a.n_s + a.n_u;
  const size_t floats = 2 * (size_t)TB * a.ld + a.wsz + kMaxWidth +
                        (size_t)TB * nsu + (size_t)TB * a.n_s;
  const size_t bytes = floats * sizeof(float);
  static size_t attr_bytes = 48 * 1024;
  if (bytes > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        node_euler_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
    attr_bytes = bytes;
  }
  const int blocks = (a.B + TB - 1) / TB;
  node_euler_kernel<RPT><<<blocks, kThreads, bytes, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 on success). Pointers are device pointers; the
// weight/bias pointer arrays and the dims arrays live on the host. dims
// hold n+1 layer widths per net. Nothing is allocated and nothing waits.
extern "C" int nlbac_node_euler(const float* x, const float* u, float* out,
                                int B, int n_s, int n_u, float dt, int n_f,
                                const void* const* f_w, const void* const* f_b,
                                const int* f_dims, int n_g,
                                const void* const* g_w, const void* const* g_b,
                                const int* g_dims, void* stream) {
  Args a;
  a.x = x;
  a.u = u;
  a.out = out;
  a.B = B;
  a.n_s = n_s;
  a.n_u = n_u;
  a.dt = dt;
  if (B < 0 || n_s < 1 || n_u < 1 || n_s + n_u > kMaxWidth) return (int)cudaErrorInvalidValue;
  if (!fill_net(a.f, n_f, f_w, f_b, f_dims) || !fill_net(a.g, n_g, g_w, g_b, g_dims))
    return (int)cudaErrorInvalidValue;
  if (a.f.dims[0] != n_s || a.f.dims[n_f] != n_s || a.g.dims[0] != n_s ||
      a.g.dims[n_g] != n_s * n_u)
    return (int)cudaErrorInvalidValue;
  int widest = 1, wsz = 1;
  const Net* nets[2] = {&a.f, &a.g};
  for (const Net* net : nets) {
    for (int l = 0; l < net->n; ++l) {
      const int K = net->dims[l], N = net->dims[l + 1];
      if (N > widest) widest = N;
      if (K * pad32(N) > wsz) wsz = K * pad32(N);
    }
  }
  // Activation rows are read as warp-wide broadcasts and written by
  // consecutive lanes, so they need no padding; unpadded, two 64-row
  // blocks fit on an SM at width 100.
  a.ld = widest;
  a.wsz = wsz;
  if (B == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = (B >= 64 * 132) ? launch<8>(a, s) : launch<2>(a, s);
  return (int)e;
}
