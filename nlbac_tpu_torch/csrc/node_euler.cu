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
// 3.4 GFLOP for a 32768-row call against about 1 MB of bytes (x, u, x'
// and 206 KB of weights): the call is bound by operations. Float32
// accuracy on the tensor cores takes three TF32 passes (below), so the
// least time is 3.4 GFLOP at 495/3 = 165 TFLOP/s, about 21 us (50 us at
// the 67 TFLOP/s of the CUDA cores). mma.sync, which this kernel uses,
// completes one m16n8k8 TF32 product per about 6 cycles on an SM
// sub-partition (measured), about two thirds of that rate. A 128-row call
// (13 MFLOP) is bound by latency: the dependent layers and the weights'
// trip from L2.
//
// Design, and what each part does about that bound:
// - Tensor cores at float32 accuracy ("3xTF32"). Every product runs as
//   mma.sync m16n8k8 TF32 with each operand split in registers as it is
//   loaded (split_tf32): v = big + small, both TF32, and the f32
//   accumulator takes small*big + big*small + big*big. One TF32 pass
//   would cost three decimal digits; three keep the kernel within 1e-5 of
//   the float32 plain version. Shared memory keeps one float32 copy of
//   weights and activations. K and N are padded to multiples of 8.
// - Two blocks per row tile, one thread block cluster: rank 0 runs f_net,
//   rank 1 runs g_net, so the dependent chain is the 5 layers of f_net,
//   not 9. The g block contracts g with u, stores the n_s values a row
//   into the f block's shared memory (distributed shared memory) and
//   arrives, with release semantics, on an mbarrier there; the f block
//   waits on it with acquire semantics, adds f + g.u and writes x'. Only
//   the f block's shared memory is written remotely, and it neither reads
//   it nor exits before every g thread has arrived.
// - Weights streamed by the TMA unit, double-buffered by layer: while
//   layer l computes, one bulk copy (cp.async.bulk, completing on an
//   mbarrier) brings layer l+1's whole K x N matrix into the other
//   buffer, unpadded, so the copy costs one instruction; the bias and the
//   tile's x and u come by 4-byte cp.async. A producer warp beside the
//   compute warps starts each layer's copies, so that the compute warps
//   go from a layer's barrier straight to its products. The fragments' k
//   order (row 2t and 2t+1 of the k-step for lane t) keeps the B loads
//   free of bank conflicts at N = 100 and makes each A pair one 8-byte
//   load, with the activations' leading dimension = 8 mod 32. A layer's
//   output overwrites its input in place after a barrier, so one
//   activation buffer serves the tile.
// - Row tiles by regime, chosen by the caller from a measured sweep: a
//   16-row tile spreads a small batch over many SMs (4 warps split the
//   layer's column tiles, and each splits the next k-step's operands
//   while this one's products run); a 64-row tile (4 warps of 32 rows by
//   half the columns, two blocks an SM) makes each B fragment serve two
//   row tiles and each A fragment seven column tiles, which halves the
//   loads and splits per product.
// - A seed axis: S independent parameter sets (the seeds of a lockstep
//   run, parallel/lockstep.py), stacked as W (S, K, N) and b (S, N), each
//   with its own B rows of x (S, B, n_s) and u (S, B, n_u). One launch
//   covers every seed: gridDim.y = S, and a block offsets x, u, x' by its
//   seed's B rows and each layer's weight and bias pointers by its seed's
//   stride (K * N and N floats; a multiple of 16 bytes wherever the
//   weights take the bulk copy). The tiles are picked from the launch's
//   S * B rows, since what a tile size trades is blocks in flight against
//   loads per product (chip_smoke.py phase 4 sweeps both at S * B).
//   S = 1 is the one-seed launch, unchanged.
// The ragged last tile runs on zero rows and is masked on store. TPU
// tiling (128x128 MXU padding, one sequential grid) is not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 128;  // widest layer (hidden, n_s*n_u, n_s+n_u)

struct Net {
  const float* w[kMaxLayers];
  const float* b[kMaxLayers];
  int K[kMaxLayers];    // input width
  int N[kMaxLayers];    // output width
  int kp[kMaxLayers];   // K padded to 8
  int np[kMaxLayers];   // N padded to 8
  int bulk[kMaxLayers];  // 1: weights staged by one bulk copy
  int wstride[kMaxLayers];  // floats from one seed's weights to the next
  int bstride[kMaxLayers];  // floats from one seed's bias to the next
  int n;
};

struct Args {
  const float* x;  // (S, B, n_s)
  const float* u;  // (S, B, n_u)
  float* out;      // (S, B, n_s)
  int B, n_s, n_u;  // B: rows per seed
  int S;            // seeds (gridDim.y)
  float dt;
  Net net[2];  // cluster rank 0 runs net[0] (f_net), rank 1 net[1] (g_net)
  int lda;     // leading dimension of the activation buffer
  int wsz;     // floats of one weight buffer
};

// Tile configurations the host picks from (see nlbac_node_euler_run).
constexpr int kNumConfigs = 2;
// floats ahead of the weight buffers: three mbarriers, padded to 16 bytes
constexpr int kBarFloats = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival that also expects `bytes` from bulk copies on this phase.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// The same wait, acquiring what other blocks of the cluster released.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar,
                                                  unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Bulk copy (the TMA unit) of `bytes` (a multiple of 16, both addresses
// 16-byte aligned) into this block's shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The address of `p` in the shared memory of cluster block `rank`.
__device__ __forceinline__ uint32_t map_rank(const void* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(smem_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile(
      "mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
          addr)
      : "memory");
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// barrier.cluster arrive + wait: every block of the cluster has started
// and sees what the others released before it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// v = big + small with big = v rounded to TF32 (nearest, ties away from
// zero: add half a TF32 unit in the last place and clear the 13 bits below
// it) and small = v - big, exact in float32. The tensor cores read the top
// 19 bits of small, so it enters truncated to TF32: its error, below 2^-10
// of |small| <= 2^-11 |v|, is as small as the small*small product that the
// three passes leave out.
__device__ __forceinline__ void split_tf32(float v, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(v - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulate.
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Starts the copies of layer l's weights into ws, K x N row-major as in
// device memory (leading dimension N), with rows K..kp-1 and 8 floats
// beyond them zeroed (a column tile past column N of row kp-1 reads
// there), and of its bias into ws + kp * N + 8, zero-padded to np. The
// weights go by one bulk copy (the TMA unit) counted on `bar` where their
// size is a multiple of 16 bytes, else by 4-byte cp.async; the bias by
// 4-byte cp.async. The cp.async copies are committed as one group. Run
// by one warp, the block's producer; `lane` is the thread's index in it.
// The block's seed (blockIdx.y) picks its slice of stacked weights.
__device__ void stage(const Net& net, int l, float* ws, uint64_t* bar,
                      int lane) {
  const int K = net.K[l], N = net.N[l], kp = net.kp[l], np = net.np[l];
  const size_t seed = blockIdx.y;
  const float* W = net.w[l] + seed * net.wstride[l];
  const float* bias = net.b[l] + seed * net.bstride[l];
  if (net.bulk[l]) {
    if (lane == 0) {
      mbar_expect_tx(bar, K * N * 4);
      bulk_copy(ws, W, K * N * 4, bar);
    }
  } else {
    for (int i = lane; i < K * N; i += 32) cp_async4(ws + i, W + i);
  }
  float* bs = ws + kp * N + 8;
  for (int i = lane; i < N; i += 32) cp_async4(bs + i, bias + i);
  cp_async_commit();
  for (int i = K * N + lane; i < kp * N + 8; i += 32) ws[i] = 0.f;
  for (int i = N + lane; i < np; i += 32) bs[i] = 0.f;
  // a later bulk copy into this buffer must land after these stores
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// act[:, :np] = act_fn(act[:, :kp] @ ws + bias) for the tile's rows, in
// place, with ws staged by `stage` (K x N, leading dimension N) and the
// output's columns N..np-1 set to zero. Warp (wm, wn) of the WM x WN warp
// grid owns MT row tiles of 16 from row 16*MT*wm and PER column tiles of 8
// from column tile wn*PER (clamped to the last tile, whose repeats it
// computes but does not store). Each B fragment serves MT row tiles and
// each A fragment PER column tiles. PER is a compile-time count, so a
// k-step's loads, splits and products form one basic block that the
// compiler can schedule, and the next k-step's fragments load while this
// one's products run. A warp with few tiles (SPLIT_AHEAD) also splits the
// next k-step's fragments while this one's products run, since it is the
// only warp on its SM sub-partition at small batch; with many tiles the
// extra registers would cost the second block on the SM that interleaves
// the two instead.
template <int WN, int MT, int PER>
__device__ void layer_tiles(float* act, int lda, const float* ws, int N,
                            int kp, int np, bool relu) {
  // few tiles a warp: separate accumulators for the three passes keep each
  // dependent chain of products short
  constexpr int ACCS = MT * PER <= 4 ? 3 : 1;
  constexpr bool SPLIT_AHEAD = MT * PER <= 4;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / WN, wn = warp - wm * WN;
  const int g = lane >> 2, t = lane & 3;
  const int last = (np >> 3) - 1;

  int col[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) col[i] = 8 * min(wn * PER + i, last);

  float acc[ACCS][MT][PER][4];
#pragma unroll
  for (int s = 0; s < ACCS; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[s][m][i][q] = 0.f;

  const int row = 16 * MT * wm + g;
  // The fragments' k index t stands for column (A) and row (B) 2t of the
  // k-step, t + 4 for 2t + 1: the same order on both sides, so the product
  // is unchanged, and a thread's two A values are adjacent (one 8-byte
  // load) while B's four rows 2t sit 8 banks apart at N = 100.
  const float* a_base = act + row * lda + 2 * t;
  const float* b_base = ws + 2 * t * N + g;
  float a_raw[MT][4], b_raw[PER][2];
  uint32_t ab[MT][4], as[MT][4], bb[PER][2], bs[PER][2];
  auto split = [&]() {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) split_tf32(a_raw[m][q], ab[m][q], as[m][q]);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      split_tf32(b_raw[i][0], bb[i][0], bs[i][0]);
      split_tf32(b_raw[i][1], bb[i][1], bs[i][1]);
    }
  };
  auto load = [&](int k0) {
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const float* a = a_base + 16 * m * lda + k0;
      const float2 lo = *reinterpret_cast<const float2*>(a);
      const float2 hi = *reinterpret_cast<const float2*>(a + 8 * lda);
      a_raw[m][0] = lo.x;
      a_raw[m][1] = hi.x;
      a_raw[m][2] = lo.y;
      a_raw[m][3] = hi.y;
    }
    const float* bk = b_base + k0 * N;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      b_raw[i][0] = bk[col[i]];
      b_raw[i][1] = bk[N + col[i]];
    }
  };
  load(0);
  if constexpr (SPLIT_AHEAD) {
    split();
    load(8 < kp ? 8 : 0);
  }
#pragma unroll 2
  for (int k0 = 0; k0 < kp; k0 += 8) {
    // this k-step's split fragments; then the next k-step's split (ahead)
    // or loaded, and the one after's loaded (ahead)
    if constexpr (!SPLIT_AHEAD) split();
    uint32_t cab[MT][4], cas[MT][4], cbb[PER][2], cbs[PER][2];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) cab[m][q] = ab[m][q], cas[m][q] = as[m][q];
#pragma unroll
    for (int i = 0; i < PER; ++i)
#pragma unroll
      for (int q = 0; q < 2; ++q) cbb[i][q] = bb[i][q], cbs[i][q] = bs[i][q];
    if constexpr (SPLIT_AHEAD) {
      split();
      load(k0 + 16 < kp ? k0 + 16 : k0);
    } else {
      load(k0 + 8 < kp ? k0 + 8 : k0);
    }
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        mma_tf32(acc[ACCS - 1][m][i], cas[m], cbb[i]);
        mma_tf32(acc[ACCS > 2 ? 1 : 0][m][i], cab[m], cbs[i]);
        mma_tf32(acc[0][m][i], cab[m], cbb[i]);
      }
  }
#pragma unroll
  for (int s = 1; s < ACCS; ++s)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int i = 0; i < PER; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[0][m][i][q] += acc[s][m][i][q];
  __syncthreads();  // every warp has read its inputs; overwrite them

  const float* bias = ws + kp * N + 8;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (wn * PER + i > last) continue;
    const int c = col[i] + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = acc[0][m][i][q] + ((q & 1) ? b.y : b.x);
        if (relu) s = fmaxf(s, 0.f);
        // columns past N hold products with the next weight row
        v[q] = c + (q & 1) < N ? s : 0.f;
      }
      float* out = act + (row + 16 * m) * lda + c;
      *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(out + 8 * lda) = make_float2(v[2], v[3]);
    }
  }
}

// Dispatches on the column tiles each warp owns, ceil(np / 8 / WN).
template <int WN, int MT>
__device__ void layer(float* act, int lda, const float* ws, int N, int kp,
                      int np, bool relu) {
  constexpr int MAX_PER = kMaxWidth / 8 / WN;
  const int per = ((np >> 3) + WN - 1) / WN;
#define NODE_EULER_CASE(P)                                   \
  case P:                                                    \
    if constexpr (P <= MAX_PER)                              \
      layer_tiles<WN, MT, P>(act, lda, ws, N, kp, np, relu); \
    break;
  switch (per) {
    NODE_EULER_CASE(1)
    NODE_EULER_CASE(2)
    NODE_EULER_CASE(3)
    NODE_EULER_CASE(4)
    NODE_EULER_CASE(5)
    NODE_EULER_CASE(6)
    NODE_EULER_CASE(7)
    NODE_EULER_CASE(8)
    NODE_EULER_CASE(9)
    NODE_EULER_CASE(10)
    NODE_EULER_CASE(11)
    NODE_EULER_CASE(12)
    NODE_EULER_CASE(13)
    NODE_EULER_CASE(14)
    NODE_EULER_CASE(15)
    NODE_EULER_CASE(16)
  }
#undef NODE_EULER_CASE
}

// Floats of shared memory a block of TM rows takes: the barriers, two
// weight buffers, the activation tile, g.u (rank 0's, written by rank 1)
// and the tile's x (rank 0) or u (rank 1) rows.
size_t smem_floats(const Args& a, int TM) {
  const int io = a.n_s > a.n_u ? a.n_s : a.n_u;
  return kBarFloats + 2 * (size_t)a.wsz + (size_t)TM * a.lda +
         (size_t)TM * (a.n_s + io);
}

// One block: WM x WN compute warps and, last, a producer warp that starts
// the copies of each next layer, so that the compute warps go straight
// from a layer's barrier to its products.
template <int WM, int WN, int MT>
__global__ void __launch_bounds__(32 * (WM * WN + 1))
node_euler_kernel(const __grid_constant__ Args a) {
  constexpr int TM = 16 * MT * WM, THREADS = 32 * (WM * WN + 1);
  constexpr int PRODUCER = WM * WN;
  extern __shared__ __align__(16) float smem[];
  // bars[0], bars[1]: the weight buffers' copies; bars[2]: rank 1's g.u
  // stored into rank 0
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* const wbuf0 = smem + kBarFloats;
  float* const wbuf1 = wbuf0 + a.wsz;
  float* const act = wbuf1 + a.wsz;
  float* const gu = act + TM * a.lda;
  float* const io = gu + TM * a.n_s;
  const unsigned rank = cluster_rank();
  const Net& net = a.net[rank];
  const int lda = a.lda, n_s = a.n_s, n_u = a.n_u, tid = threadIdx.x;
  const int row0 = (blockIdx.x >> 1) * TM;
  // this block's seed: its rows of x, u and x'
  const size_t seed = blockIdx.y;
  const float* const x = a.x + seed * a.B * n_s;
  const float* const u = a.u + seed * a.B * n_u;
  float* const out = a.out + seed * a.B * n_s;

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_init(&bars[2], THREADS);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // the barriers are set up in both blocks

  // The tile's x into the activations (zero-padded to kp0) and its x
  // (rank 0, for the update) or u (rank 1, for g.u) rows into io, by
  // cp.async in the first layer's group; rows past B are zeros.
  const int kp0 = net.kp[0];
  for (int i = tid; i < TM * kp0; i += THREADS) {
    const int r = i / kp0, c = i - r * kp0, gr = row0 + r;
    if (c < n_s && gr < a.B)
      cp_async4(act + r * lda + c, x + gr * n_s + c);
    else
      act[r * lda + c] = 0.f;
  }
  const int n_io = rank ? n_u : n_s;
  const float* src = rank ? u : x;
  for (int i = tid; i < TM * n_io; i += THREADS) {
    if (row0 * n_io + i < a.B * n_io)
      cp_async4(io + i, src + row0 * n_io + i);
    else
      io[i] = 0.f;
  }
  const bool producer = (tid >> 5) == PRODUCER;
  if (producer) stage(net, 0, wbuf0, &bars[0], tid & 31);

  unsigned phases = 0;  // bit b: parity of bars[b]'s next phase
  for (int l = 0; l < net.n; ++l) {
    const int buf = l & 1;
    if (net.bulk[l]) {
      mbar_wait(&bars[buf], (phases >> buf) & 1);
      phases ^= 1u << buf;
    }
    cp_async_wait_all();
    __syncthreads();  // layer l's weights and input are in place
    if (producer) {
      if (l + 1 < net.n)  // the other buffer was last read by layer l - 1
        stage(net, l + 1, buf ? wbuf0 : wbuf1, &bars[buf ^ 1], tid & 31);
      __syncthreads();  // the compute warps' barrier inside the layer
    } else {
      layer<WN, MT>(act, lda, buf ? wbuf1 : wbuf0, net.N[l], net.kp[l],
                    net.np[l], l + 1 < net.n);
    }
  }
  __syncthreads();  // act holds the net's output

  if (rank == 1) {
    // g.u into rank 0's shared memory, then one arrival a thread on its
    // barrier: rank 0 waits for all of them before it reads or exits
    for (int i = tid; i < TM * n_s; i += THREADS) {
      const int r = i / n_s, j = i - r * n_s;
      const float* grow = act + r * lda + j * n_u;
      const float* urow = io + r * n_u;
      float s = 0.f;
      for (int k = 0; k < n_u; ++k) s = fmaf(grow[k], urow[k], s);
      st_cluster(map_rank(gu + i, 0), s);
    }
    mbar_arrive_cluster(map_rank(&bars[2], 0));
    return;
  }
  mbar_wait_cluster(&bars[2], 0);
  for (int i = tid; i < TM * n_s; i += THREADS) {
    const int r = i / n_s, j = i - r * n_s;
    if (row0 + r < a.B)
      out[row0 * n_s + i] = io[i] + a.dt * (act[r * lda + j] + gu[i]);
  }
}

int pad8(int n) { return (n + 7) & ~7; }

bool fill_net(Net& net, int n, const void* const* w, const void* const* b,
              const int* dims) {
  if (n < 1 || n > kMaxLayers) return false;
  net.n = n;
  for (int l = 0; l < n; ++l) {
    const int K = dims[l], N = dims[l + 1];
    if (K < 1 || K > kMaxWidth || N < 1 || N > kMaxWidth) return false;
    net.w[l] = static_cast<const float*>(w[l]);
    net.b[l] = static_cast<const float*>(b[l]);
    net.K[l] = K;
    net.N[l] = N;
    net.kp[l] = pad8(K);
    net.np[l] = pad8(N);
    // a seed's weights start K * N floats after the last seed's, so
    // the bulk copy's 16-byte alignment holds for every seed
    net.bulk[l] = (K * N) % 4 == 0 &&
                  reinterpret_cast<uintptr_t>(w[l]) % 16 == 0;
    net.wstride[l] = K * N;
    net.bstride[l] = N;
  }
  return true;
}

template <int WM, int WN, int MT>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  constexpr int TM = 16 * MT * WM, THREADS = 32 * (WM * WN + 1);
  const size_t bytes = smem_floats(a, TM) * sizeof(float);
  static size_t attr_bytes = 0;
  if (bytes > attr_bytes) {
    cudaError_t e = cudaFuncSetAttribute(
        node_euler_kernel<WM, WN, MT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    attr_bytes = bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(2 * ((a.B + TM - 1) / TM), a.S, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 2;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, node_euler_kernel<WM, WN, MT>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

// The launch takes two calls. nlbac_node_euler_plan checks the nets and
// fills a plan of nlbac_node_euler_plan_bytes() bytes that the caller
// keeps while the weights stay where they are; nlbac_node_euler_run
// launches the kernel on a plan for B rows of x and u per seed. Both
// return a cudaError_t (0 on success). Pointers to x, u, out and the
// weights are device pointers; the pointer and dims arrays live on the
// host, dims holding n+1 layer widths per net. With n_seeds = S > 1 the
// weights are stacked, each layer's W (S, K, N) and b (S, N) contiguous,
// and x, u and out hold S blocks of B rows. `config` picks the tiles: 0 for
// 16-row tiles (4 warps, each 16 rows by a quarter of the columns), 1 for
// 64-row tiles (4 warps, each 32 rows by half of the columns). Nothing is
// allocated and nothing waits.
extern "C" int nlbac_node_euler_plan_bytes() { return (int)sizeof(Args); }

extern "C" int nlbac_node_euler_plan(void* plan, int n_seeds, int n_s,
                                     int n_u, int n_f,
                                     const void* const* f_w,
                                     const void* const* f_b,
                                     const int* f_dims, int n_g,
                                     const void* const* g_w,
                                     const void* const* g_b,
                                     const int* g_dims) {
  Args a = {};
  a.n_s = n_s;
  a.n_u = n_u;
  a.S = n_seeds;
  if (n_seeds < 1 || n_seeds > 65535 || n_s < 1 || n_u < 1 ||
      n_s + n_u > kMaxWidth ||
      !fill_net(a.net[0], n_f, f_w, f_b, f_dims) ||
      !fill_net(a.net[1], n_g, g_w, g_b, g_dims) || f_dims[0] != n_s ||
      f_dims[n_f] != n_s || g_dims[0] != n_s || g_dims[n_g] != n_s * n_u)
    return (int)cudaErrorInvalidValue;
  int widest = 8, wsz = 8;
  for (const Net& net : a.net)
    for (int l = 0; l < net.n; ++l) {
      widest = net.kp[l] > widest ? net.kp[l] : widest;
      widest = net.np[l] > widest ? net.np[l] : widest;
      const int stage_floats = net.kp[l] * net.N[l] + 8 + net.np[l];
      wsz = stage_floats > wsz ? stage_floats : wsz;
    }
  // widest is a multiple of 8; lda = 8 mod 32 spreads each half-warp's
  // 8-byte A loads (rows lane/4, columns 2*(lane%4)) over all 32 banks
  a.lda = widest + (40 - widest % 32) % 32;
  a.wsz = (wsz + 3) & ~3;  // the next buffer starts 16-byte aligned
  *static_cast<Args*>(plan) = a;
  return 0;
}

extern "C" int nlbac_node_euler_run(const void* plan, const float* x,
                                    const float* u, float* out, int B,
                                    float dt, int config, void* stream) {
  if (B < 0 || config < 0 || config >= kNumConfigs)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  Args a = *static_cast<const Args*>(plan);
  a.x = x;
  a.u = u;
  a.out = out;
  a.B = B;
  a.dt = dt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      config == 0 ? launch<1, 4, 1>(a, s) : launch<2, 2, 2>(a, s);
  return (int)e;
}
