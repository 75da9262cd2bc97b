// Fused PPO minibatch gradients: forward pass, clipped-PPO loss gradients and
// a hand-derived backward pass of the feedforward ActorCritic
//
//     obs -> Dense(H1) -> LayerNorm -> relu -> Dense(H2) -> LayerNorm -> relu
//         -> {Dense(A) logits, Dense(1) value}
//
// for one minibatch, returning the 12 parameter gradients and the loss
// metrics.
//
// Replaces the Pallas kernel tpu_plume/ops/pallas_ppo.py (_kernel,
// fused_ppo_grads).  The formulas are the Pallas kernel's, term by term
// (pallas_ppo.py:91-199): LayerNorm variance as E[z^2] - E[z]^2 with eps
// 1e-6; subgradients s1 <= s2, strict clip-range bounds and e1^2 >= e2^2;
// with bf16 set, the four forward products round their operands to bf16
// (round to nearest even) and accumulate in f32, and every backward
// contraction takes f32 operands.  The wrapper and the plain PyTorch version
// of the same function are tpu_plume_torch/ops/ppo.py.
//
// Bound: per row 2(D H1 + H1 H2 + H2 (A+1)) forward and about twice that
// backward operations; at the main path's (6, 256, 128, 5) and 65536 rows,
// about 1.4e10 operations, or 0.21 ms at the f32 CUDA-core peak.  The
// three H1 x H2 products (z2 = h1 W2^T, dh1 = dz2 W2, dW2 = dz2^T h1) are
// 94% of them, so the design is about feeding those products.
//
// Design.  The TPU kernel keeps every activation in VMEM and accumulates all
// gradients in place across a sequential grid, because XLA's round trips
// through the TPU's device memory (about 800 GB/s) were its bottleneck.  On
// the H100 blocks run concurrently, and a block that kept the 32768
// entries of dW2 in shared memory (145 KB at (256, 128)) left one block of
// 8 warps per SM.  Here the work is split in three launches:
//   ppo_row_kernel     G blocks (what the card holds at once, at most the
//                      number of 32-row tiles); block b walks the tiles b,
//                      b + G, ... in order through the forward pass, both
//                      LayerNorms, the heads, the per-row loss gradients and
//                      the backward pass down to dz1.  It writes h1 [B, H1]
//                      and dz2 [B, H2] (f32) to a workspace in device memory
//                      and keeps only the small gradients (everything but
//                      dW2, about 4.5k floats at (6, 256, 128, 5)) and the
//                      5 metric sums in shared memory, written once to its
//                      own slab.  Both H1 x H2 products are register-tiled:
//                      each warp owns 4 rows, each lane 4 columns of each
//                      128-column pass; the activation tile stays in shared
//                      memory and W2 is streamed through shared memory in
//                      k-chunks, so each W2 element is read from L2 once per
//                      product per tile and each shared-memory load feeds 4
//                      multiply-adds.
//   ppo_dw2_kernel     dW2 = dz2^T h1 over the B rows as a split-K product:
//                      block (tile, s) owns a 128 x 128 output tile and a
//                      contiguous range of rows, stages 16-row chunks of dz2
//                      and h1 in shared memory with 16-byte loads, and each
//                      thread keeps an 8 x 8 micro-tile in registers (16
//                      operands loaded per 64 multiply-adds); it writes its
//                      partial tile to slab s.
//   ppo_reduce_kernel  sums each entry over the row slabs or the dW2 slabs in
//                      a fixed order (8 warps over the slabs, then the warp
//                      sums in warp order) and turns the metric sums into
//                      means.
// The workspace costs about 0.2 GB of device-memory traffic at 65536 rows
// (h1 and dz2 written once and read once): about 60 us at 3.35 TB/s, under a
// third of the bound, and it takes the H1 x H2 accumulator out of every
// block.  No float atomics: two calls on the same inputs give bit-equal
// gradients.
//
// Order of sums.  Every output of z1 = x W1^T and z2 = h1 W2^T sums over k
// in turn from 0 with __fmaf_rn (one rounding per step, whatever -fmad
// says), and each LayerNorm stat in the lane order of warp_sum; the plain
// version in ops/ppo.py repeats that order under bf16 (_ordered_mm,
// _lane_mean), where the next product's rounding to bf16 would turn
// another order's last-bit differences into bf16-ulp ones.  Change both
// together.  The heads (no bf16 rounding follows them) sum lane partials,
// and the backward products sum in their own order, all with __fmaf_rn;
// those stay within the f32 tolerance of the plain version.  The products run
// on the CUDA cores (no tensor cores, TMA or cuBLAS).
//
// Widths: H1 and H2 multiples of 16 and at most 256 (one or two 128-column
// passes), at most 7 actions, and a shared-memory footprint the card
// allows; ppo_fused_plan refuses other widths and the wrapper raises.
// Rows: a multiple of 32.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -o libppo.so ppo.cu
// (done by tpu_plume_torch/ops/build.py at first use).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;  // rows per tile (KERNEL_ROWS in ops/ppo.py)
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMetrics = 5;
constexpr float kLnEps = 1e-6f;
// One pass of a row-kernel product covers 128 output columns (32 lanes x 4).
constexpr int kCols = 128;
// Floats of the staged W2 chunk: kChunkFloats / (passes x 128) k-rows.
constexpr int kChunkFloats = 2048;
constexpr int kMaxWidth = 256;
// Logits plus the value: A + 1 at most.
constexpr int kMaxHeads = 8;
// dW2 kernel: output tile edge and rows staged per step.
constexpr int kTile = 128;
constexpr int kStepRows = 16;

// Offsets (floats) of each gradient of one row-kernel block, in the torch
// layout (Dense weights [out, in]) without dW2; the metric sums follow.
struct Layout {
  int w1, b1, g1, be1, b2, g2, be2, wp, bp, wv, bv, met, total;
};

__host__ __device__ inline Layout make_layout(int d, int h1, int h2, int a) {
  Layout l;
  int o = 0;
  l.w1 = o; o += h1 * d;
  l.b1 = o; o += h1;
  l.g1 = o; o += h1;
  l.be1 = o; o += h1;
  l.b2 = o; o += h2;
  l.g2 = o; o += h2;
  l.be2 = o; o += h2;
  l.wp = o; o += a * h2;
  l.bp = o; o += a;
  l.wv = o; o += h2;
  l.bv = o; o += 1;
  l.met = o; o += kMetrics;
  l.total = o;
  return l;
}

__host__ __device__ inline int round4(int x) { return (x + 3) / 4 * 4; }

// Shared memory of the row kernel, in floats: the activation buffers A
// [kRows][H1] (xh1), P [kRows][max(H1, H2)] (h1, h2, then dz2 and dz1) and
// Q [kRows][H2] (xh2), the W2 chunk, the obs tile, the per-row scalars and
// the block's gradient accumulator.
__host__ __device__ inline int row_smem_floats(int d, int h1, int h2, int a) {
  const int hmax = h1 > h2 ? h1 : h2;
  return kRows * (h1 + hmax + h2) + kChunkFloats + round4(kRows * d) +
         round4(kRows * (3 + kMetrics + a)) + make_layout(d, h1, h2, a).total;
}

// Round to the nearest bf16 (ties to even) and back, under bf16 compute.
__device__ __forceinline__ float rnd(float x, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(x)) : x;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// In place over rows of z[kRows][h]: z <- (z - mu) * rstd, out <- relu of
// z * g + be (rounded to bf16 under bf16, the next product's operand; the
// exact value also to the row of ``out_global`` when it is given),
// rstd[r] <- 1 / sqrt(var + eps).  Warp w takes rows 4w .. 4w + 3 together;
// lane l sums z[r][l], z[r][l + 32], ... in turn, and warp_sum combines the
// lanes.
__device__ void layer_norm_rows(float* z, float* out, float* rstd,
                                const float* __restrict__ g,
                                const float* __restrict__ be, int h,
                                int bf16, float* __restrict__ out_global) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* zr = z + kRowsPerWarp * warp * h;
  float s[kRowsPerWarp], s2[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s[i] = s2[i] = 0.0f;
  for (int k = lane; k < h; k += 32) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float v = zr[i * h + k];
      s[i] += v;
      s2[i] += v * v;
    }
  }
  float mu[kRowsPerWarp], rs[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    mu[i] = warp_sum(s[i]) / static_cast<float>(h);
    const float var = warp_sum(s2[i]) / static_cast<float>(h) - mu[i] * mu[i];
    rs[i] = rsqrtf(var + kLnEps);
  }
  for (int k = lane; k < h; k += 32) {
    const float gk = g[k], bk = be[k];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int e = (kRowsPerWarp * warp + i) * h + k;
      const float xh = (z[e] - mu[i]) * rs[i];
      z[e] = xh;
      const float y = fmaxf(xh * gk + bk, 0.0f);
      out[e] = rnd(y, bf16);
      if (out_global) out_global[e] = y;
    }
  }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) rstd[kRowsPerWarp * warp + i] = rs[i];
}

// In place over rows of dy[kRows][h]: the LayerNorm backward
// dz = rstd * (dxh - mean(dxh) - xh * mean(dxh * xh)), dxh = dy * g;
// warp w takes rows 4w .. 4w + 3 together.
__device__ void layer_norm_back_rows(float* dy, const float* xh,
                                     const float* rstd,
                                     const float* __restrict__ g, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int e0 = kRowsPerWarp * warp * h;
  float s[kRowsPerWarp], s2[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) s[i] = s2[i] = 0.0f;
  for (int k = lane; k < h; k += 32) {
    const float gk = g[k];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const float dxh = dy[e0 + i * h + k] * gk;
      s[i] += dxh;
      s2[i] += dxh * xh[e0 + i * h + k];
    }
  }
  float m1[kRowsPerWarp], m2[kRowsPerWarp], rs[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m1[i] = warp_sum(s[i]) / static_cast<float>(h);
    m2[i] = warp_sum(s2[i]) / static_cast<float>(h);
    rs[i] = rstd[kRowsPerWarp * warp + i];
  }
  for (int k = lane; k < h; k += 32) {
    const float gk = g[k];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int e = e0 + i * h + k;
      const float dxh = dy[e] * gk;
      dy[e] = rs[i] * (dxh - m1[i] - xh[e] * m2[i]);
    }
  }
}

// Register-tiled out = a W over the block's kRows rows:
//   acc[c][i][q] = sum over k in turn from 0 of a[r][k] * W(k, col),
// r = kRowsPerWarp * warp + i, col = 128 c + 4 lane + q, for the NC passes
// of 128 columns.  ``a`` is [kRows][K] in shared memory (K a multiple of
// 16).  W comes in chunks of kc k-rows: ``load(k0, v)`` reads a thread's two
// float4 of the chunk at k0 from global memory into v, ``store(v, ws)``
// puts them into ws[kk][NC * 128] as W(k0 + kk, col) (0 for col >= N).  The
// next chunk is read while the current one is multiplied.  Each a-value
// loaded feeds 4 NC multiply-adds, each W value 4.  Ends with every thread
// past its last read of ``a``.
template <int NC, class Load, class Store>
__device__ __forceinline__ void tiled_product(const float* a, int K,
                                              float* ws, Load load,
                                              Store store,
                                              float (&acc)[NC][4][4]) {
  constexpr int kc = kChunkFloats / (NC * kCols);
  static_assert(kChunkFloats == 8 * kThreads, "two float4 per thread");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float* arow = a + kRowsPerWarp * warp * K;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[c][i][q] = 0.0f;
  float4 v[2];
  load(0, v);
  for (int k0 = 0; k0 < K; k0 += kc) {
    __syncthreads();  // the previous chunk is consumed
    store(v, ws);
    __syncthreads();
    if (k0 + kc < K) load(k0 + kc, v);
#pragma unroll
    for (int kk = 0; kk < kc; kk += 4) {
      float av[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 x =
            *reinterpret_cast<const float4*>(arow + i * K + k0 + kk);
        av[i][0] = x.x; av[i][1] = x.y; av[i][2] = x.z; av[i][3] = x.w;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float4 w4 = *reinterpret_cast<const float4*>(
              ws + (kk + t) * (NC * kCols) + c * kCols + 4 * lane);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[c][i][0] = __fmaf_rn(av[i][t], w4.x, acc[c][i][0]);
            acc[c][i][1] = __fmaf_rn(av[i][t], w4.y, acc[c][i][1]);
            acc[c][i][2] = __fmaf_rn(av[i][t], w4.z, acc[c][i][2]);
            acc[c][i][3] = __fmaf_rn(av[i][t], w4.w, acc[c][i][3]);
          }
        }
      }
    }
  }
  __syncthreads();  // every thread is past its reads of a and ws
}

// z2 = h1 W2^T + b2 into q (stride h2), from the h1 tile p (stride h1).
template <int NC>
__device__ void forward_z2(const float* p, float* q, float* ws,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2, int h1, int h2,
                           int bf16) {
  constexpr int per_col = kChunkFloats / (NC * kCols) / 4;
  float acc[NC][4][4];
  // Item e: column e / per_col of the chunk, k-quad e % per_col: 16 bytes
  // of W2's row, neighbouring lanes on neighbouring quads of a row (one
  // column's per_col quads are contiguous); stored transposed (ws[kk][col]
  // = W2[col][k0 + kk]), rounded under bf16.
  auto load = [&](int k0, float4 (&v)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int col = e / per_col, m = e % per_col;
      v[u] = col < h2 ? __ldg(reinterpret_cast<const float4*>(
                            w2 + static_cast<size_t>(col) * h1 + k0 + 4 * m))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store = [&](const float4 (&v)[2], float* s) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int col = e / per_col, m = e % per_col;
      float* dst = s + 4 * m * (NC * kCols) + col;
      dst[0] = rnd(v[u].x, bf16);
      dst[NC * kCols] = rnd(v[u].y, bf16);
      dst[2 * NC * kCols] = rnd(v[u].z, bf16);
      dst[3 * NC * kCols] = rnd(v[u].w, bf16);
    }
  };
  tiled_product<NC>(p, h1, ws, load, store, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = c * kCols + 4 * lane + t;
        if (col < h2)
          q[(kRowsPerWarp * warp + i) * h2 + col] = acc[c][i][t] + b2[col];
      }
}

// dy1 = (dz2 W2) * (y1 > 0) into p (stride h1), from the dz2 tile in p
// (stride h2) and xh1 (stride h1).
template <int NC>
__device__ void backward_dh1(float* p, const float* xh1, float* ws,
                             const float* __restrict__ w2,
                             const float* __restrict__ g1,
                             const float* __restrict__ be1, int h1, int h2) {
  constexpr int quads = NC * kCols / 4;
  float acc[NC][4][4];
  // Item e: k-row e / quads of the chunk, columns 4 (e % quads) + 0..3:
  // ws[kk][col] = W2[k0 + kk][col].
  auto load = [&](int k0, float4 (&v)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = threadIdx.x + u * kThreads;
      const int kk = e / quads, col = 4 * (e % quads);
      v[u] = col < h1 ? __ldg(reinterpret_cast<const float4*>(
                            w2 + static_cast<size_t>(k0 + kk) * h1 + col))
                      : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  auto store = [&](const float4 (&v)[2], float* s) {
#pragma unroll
    for (int u = 0; u < 2; ++u)
      reinterpret_cast<float4*>(s)[threadIdx.x + u * kThreads] = v[u];
  };
  tiled_product<NC>(p, h2, ws, load, store, acc);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int c = 0; c < NC; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int col = c * kCols + 4 * lane + t;
        if (col < h1) {
          const int e = (kRowsPerWarp * warp + i) * h1 + col;
          const float y1 = xh1[e] * g1[col] + be1[col];
          p[e] = acc[c][i][t] * (y1 > 0.0f ? 1.0f : 0.0f);
        }
      }
}

// PHASE(i) is a barrier that ends phase i of a tile.  With
// PPO_PHASE_CLOCKS defined, block 0 of the row kernel also adds the clock
// cycles of the phase to ppo_phase_cycles[i] (read by ppo_phase_clocks).
#ifdef PPO_PHASE_CLOCKS
constexpr int kPhases = 16;
__device__ unsigned long long ppo_phase_cycles[kPhases];
#define PHASE(i)                                                       \
  do {                                                                 \
    __syncthreads();                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                         \
      const long long now = clock64();                                 \
      ppo_phase_cycles[i] += static_cast<unsigned long long>(now - mark); \
      mark = now;                                                      \
    }                                                                  \
  } while (0)
#else
#define PHASE(i) __syncthreads()
#endif

struct Batch {
  const float* obs;
  const int64_t* act;
  const float *oldlp, *adv, *ret, *oldv;
};

struct Params {
  const float *w1, *b1, *g1, *be1, *w2, *b2, *g2, *be2, *wp, *bp, *wv, *bv;
};

struct Scalars {
  float inv_n, lo, hi, clip_eps, v_scale, v_coef, ent_scale;
};

__global__ void __launch_bounds__(kThreads, 2)
    ppo_row_kernel(Batch in, Params w, float* __restrict__ slab,
                   float* __restrict__ h1_out, float* __restrict__ dz2_out,
                   int n, int d, int h1, int h2, int a, int bf16,
                   Scalars c) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = make_layout(d, h1, h2, a);
  const int hmax = h1 > h2 ? h1 : h2;
  float* xa = smem;                   // [kRows][h1]  z1, then xh1
  float* p = xa + kRows * h1;         // [kRows][hmax] h1; h2; dy2 -> dz2;
                                      //               dy1 -> dz1
  float* q = p + kRows * hmax;        // [kRows][h2]  z2, then xh2
  float* ws = q + kRows * h2;         // [kChunkFloats] W2 chunk
  float* xs = ws + kChunkFloats;      // [kRows][d]
  float* rstd1 = xs + round4(kRows * d);  // [kRows]
  float* rstd2 = rstd1 + kRows;           // [kRows]
  float* dvs = rstd2 + kRows;             // [kRows]  value, then dv
  float* mrow = dvs + kRows;              // [kRows][kMetrics]
  float* dlog = mrow + kRows * kMetrics;  // [kRows][a]  logits, then dlogits
  float* acc = rstd1 + round4(kRows * (3 + kMetrics + a));  // L.total

  const int tid = threadIdx.x;
  for (int i = tid; i < L.total; i += kThreads) acc[i] = 0.0f;

  const int tiles = n / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
#ifdef PPO_PHASE_CLOCKS
    long long mark = clock64();
#endif
    // PHASE(14) ended the previous tile: every buffer is free.
    for (int i = tid; i < kRows * d; i += kThreads)
      xs[i] = in.obs[static_cast<size_t>(row0) * d + i];
    __syncthreads();

    // ---- forward ----------------------------------------------------------
    // z1 = x W1^T + b1: thread j takes column j of every row.
    for (int j = tid; j < h1; j += kThreads) {
      float z[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) z[r] = 0.0f;
      for (int k = 0; k < d; ++k) {
        const float wk = rnd(__ldg(w.w1 + j * d + k), bf16);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          z[r] = __fmaf_rn(rnd(xs[r * d + k], bf16), wk, z[r]);
      }
      const float bj = w.b1[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) xa[r * h1 + j] = z[r] + bj;
    }
    PHASE(0);
    // h1 to p (rounded under bf16: the operand of z2) and, exact, to the
    // workspace for the dW2 kernel.
    layer_norm_rows(xa, p, rstd1, w.g1, w.be1, h1, bf16,
                    h1_out + static_cast<size_t>(row0) * h1);
    PHASE(1);

    if (h2 > kCols)
      forward_z2<2>(p, q, ws, w.w2, w.b2, h1, h2, bf16);
    else
      forward_z2<1>(p, q, ws, w.w2, w.b2, h1, h2, bf16);
    PHASE(2);
    layer_norm_rows(q, p, rstd2, w.g2, w.be2, h2, 0, nullptr);
    PHASE(3);

    // heads: logits = h2 Wp^T + bp, v = h2 Wv^T + bv.  Warp w takes rows
    // 4w .. 4w + 3 and every head at once; lane l sums k = l, l + 32, ...
    // and warp_sum combines the lanes (no bf16 rounding follows the heads,
    // so their order is free).
    {
      const int r0 = kRowsPerWarp * (tid / 32), lane = tid % 32;
      float s[kMaxHeads][kRowsPerWarp];
#pragma unroll
      for (int col = 0; col < kMaxHeads; ++col)
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[col][i] = 0.0f;
      for (int k = lane; k < h2; k += 32) {
        float hv[kRowsPerWarp];
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i)
          hv[i] = rnd(p[(r0 + i) * h2 + k], bf16);
#pragma unroll
        for (int col = 0; col < kMaxHeads; ++col) {
          // columns past the value head add 0 and are not written
          const float wk =
              col > a ? 0.0f
                      : rnd(__ldg(col < a ? w.wp + col * h2 + k : w.wv + k),
                            bf16);
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i)
            s[col][i] = __fmaf_rn(hv[i], wk, s[col][i]);
        }
      }
#pragma unroll
      for (int col = 0; col < kMaxHeads; ++col)
#pragma unroll
        for (int i = 0; i < kRowsPerWarp; ++i) s[col][i] = warp_sum(s[col][i]);
      if (lane == 0) {
#pragma unroll
        for (int col = 0; col < kMaxHeads; ++col) {
          if (col > a) break;
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) {
            if (col < a)
              dlog[(r0 + i) * a + col] = s[col][i] + w.bp[col];
            else
              dvs[r0 + i] = s[col][i] + w.bv[0];
          }
        }
      }
    }
    PHASE(4);

    // ---- loss gradients and metrics, one thread per row ---------------------
    if (tid < kRows) {
      const int r = tid, row = row0 + r;
      float* l = dlog + r * a;
      float lmax = l[0];
      for (int k = 1; k < a; ++k) lmax = fmaxf(lmax, l[k]);
      float se = 0.0f;
      for (int k = 0; k < a; ++k) se += expf(l[k] - lmax);
      const float lse = logf(se) + lmax;
      const int act = static_cast<int>(in.act[row]);
      float newlp = 0.0f, plp = 0.0f;
      for (int k = 0; k < a; ++k) {
        const float lp = l[k] - lse;
        newlp += lp * (k == act ? 1.0f : 0.0f);
        plp += expf(lp) * lp;
      }
      const float ent = -plp;
      const float oldlp = in.oldlp[row], adv = in.adv[row];
      const float ratio = expf(newlp - oldlp);
      const float s1 = ratio * adv;
      const float s2 = fminf(fmaxf(ratio, c.lo), c.hi) * adv;
      const bool use1 = s1 <= s2;
      const bool inclip = ratio > c.lo && ratio < c.hi;
      const float dmin = (use1 || inclip) ? ratio * adv : 0.0f;
      const float g_newlp = -dmin * c.inv_n;
      for (int k = 0; k < a; ++k) {
        const float lp = l[k] - lse;
        const float pk = expf(lp);
        const float aoh = k == act ? 1.0f : 0.0f;
        l[k] = g_newlp * (aoh - pk) + (c.ent_scale * pk) * (lp + ent);
      }

      const float v = dvs[r], oldv = in.oldv[row], ret = in.ret[row];
      const float dvo = v - oldv;
      const float vc = oldv + fminf(fmaxf(dvo, -c.clip_eps), c.clip_eps);
      const float e1 = v - ret, e2 = vc - ret;
      const bool usev1 = e1 * e1 >= e2 * e2;
      const bool inclip_v = dvo > -c.clip_eps && dvo < c.clip_eps;
      dvs[r] = c.v_scale * (usev1 ? 2.0f * e1 : (inclip_v ? 2.0f * e2 : 0.0f));

      float* m = mrow + r * kMetrics;
      m[0] = -fminf(s1, s2);
      m[1] = c.v_coef * fmaxf(e1 * e1, e2 * e2);
      m[2] = ent;
      m[3] = oldlp - newlp;
      m[4] = fabsf(ratio - 1.0f) > c.clip_eps ? 1.0f : 0.0f;
    }
    PHASE(5);

    // ---- backward -----------------------------------------------------------
    // metric sums; head grads from h2 (p)
    if (tid < kMetrics) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += mrow[r * kMetrics + tid];
      acc[L.met + tid] += s;
    }
    for (int i = tid; i < (a + 1) * h2; i += kThreads) {
      const int col = i / h2, j = i % h2;
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r)
        s += (col < a ? dlog[r * a + col] : dvs[r]) * p[r * h2 + j];
      acc[(col < a ? L.wp + col * h2 : L.wv) + j] += s;
    }
    for (int col = tid; col < a + 1; col += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += col < a ? dlog[r * a + col] : dvs[r];
      acc[col < a ? L.bp + col : L.bv] += s;
    }
    PHASE(6);
    // dy2 = (dlogits Wp + dv Wv) * (y2 > 0), into p over h2: item (j,
    // half) takes column j of half the rows.
    for (int i = tid; i < 2 * h2; i += kThreads) {
      constexpr int kHalf = kRows / 2;
      const int j = i % h2, rh = (i / h2) * kHalf;
      float s[kHalf];
#pragma unroll
      for (int r = 0; r < kHalf; ++r) s[r] = 0.0f;
      for (int k = 0; k < a; ++k) {
        const float wk = w.wp[k * h2 + j];
#pragma unroll
        for (int r = 0; r < kHalf; ++r) s[r] += dlog[(rh + r) * a + k] * wk;
      }
      const float wvj = w.wv[j], gj = w.g2[j], bj = w.be2[j];
#pragma unroll
      for (int r = 0; r < kHalf; ++r) {
        const int e = (rh + r) * h2 + j;
        const float dh2 = s[r] + dvs[rh + r] * wvj;
        const float y2 = q[e] * gj + bj;
        p[e] = dh2 * (y2 > 0.0f ? 1.0f : 0.0f);
      }
    }
    PHASE(7);
    // LayerNorm_1 scale and bias grads, then dz2 in place
    for (int j = tid; j < h2; j += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float dy = p[r * h2 + j];
        sg += dy * q[r * h2 + j];
        sb += dy;
      }
      acc[L.g2 + j] += sg;
      acc[L.be2 + j] += sb;
    }
    PHASE(8);
    layer_norm_back_rows(p, q, rstd2, w.g2, h2);
    PHASE(9);

    // db2 += sum dz2; dz2 to the workspace for the dW2 kernel
    for (int j = tid; j < h2; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += p[r * h2 + j];
      acc[L.b2 + j] += s;
    }
    for (int i = tid; i < kRows * h2; i += kThreads)
      dz2_out[static_cast<size_t>(row0) * h2 + i] = p[i];
    PHASE(10);

    // dy1 = (dz2 W2) * (y1 > 0), into p over h1
    if (h1 > kCols)
      backward_dh1<2>(p, xa, ws, w.w2, w.g1, w.be1, h1, h2);
    else
      backward_dh1<1>(p, xa, ws, w.w2, w.g1, w.be1, h1, h2);
    PHASE(11);
    // LayerNorm_0 scale and bias grads, then dz1 in place
    for (int j = tid; j < h1; j += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float dy = p[r * h1 + j];
        sg += dy * xa[r * h1 + j];
        sb += dy;
      }
      acc[L.g1 + j] += sg;
      acc[L.be1 + j] += sb;
    }
    PHASE(12);
    layer_norm_back_rows(p, xa, rstd1, w.g1, h1);
    PHASE(13);

    // dW1 += dz1^T x, db1 += sum dz1
    for (int i = tid; i < h1 * d; i += kThreads) {
      const int j = i / d, k = i % d;
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += p[r * h1 + j] * xs[r * d + k];
      acc[L.w1 + i] += s;
    }
    for (int j = tid; j < h1; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += p[r * h1 + j];
      acc[L.b1 + j] += s;
    }
    PHASE(14);
  }
  __syncthreads();
  float* out = slab + static_cast<size_t>(blockIdx.x) * L.total;
  for (int i = tid; i < L.total; i += kThreads) out[i] = acc[i];
}

// dW2 partials: block (tile, s) sums dz2[r][j] h1[r][k] over rows
// [s rows_per_split, (s + 1) rows_per_split) in turn, for the 128 x 128 tile
// of (j, k), into slab2[s][j][k].  Thread (ty, tx) owns the 8 x 8 outputs
// j = j0 + 4 ty + {0..3, 64..67}, k = k0 + 4 tx + {0..3, 64..67}: per row it
// loads 16 operands from shared memory for 64 multiply-adds.  The next
// 16-row chunk is loaded into registers while the current one is
// multiplied.
__global__ void __launch_bounds__(kThreads)
    ppo_dw2_kernel(const float* __restrict__ dz2, const float* __restrict__ h1,
                   float* __restrict__ slab2, int n, int h1w, int h2w,
                   int rows_per_split) {
  constexpr int kQuads = kTile / 4;
  __shared__ float4 ds4[kStepRows * kQuads];
  __shared__ float4 hs4[kStepRows * kQuads];
  static_assert(kStepRows * kQuads == 2 * kThreads, "two float4 a thread");
  const int tiles_k = (h1w + kTile - 1) / kTile;
  const int j0 = (blockIdx.x / tiles_k) * kTile;
  const int k0 = (blockIdx.x % tiles_k) * kTile;
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(n, r_begin + rows_per_split);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // Item e = tid + 256 u of a chunk: row e / 32, columns 4 (e % 32) + 0..3.
  auto load = [&](const float* src, int width, int col0, int r0,
                  float4 (&v)[2]) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int e = tid + u * kThreads;
      const int r = r0 + e / kQuads, col = col0 + 4 * (e % kQuads);
      v[u] = r < r_end && col < width
                 ? __ldg(reinterpret_cast<const float4*>(
                       src + static_cast<size_t>(r) * width + col))
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  };
  float4 nd[2], nh[2];
  load(dz2, h2w, j0, r_begin, nd);
  load(h1, h1w, k0, r_begin, nh);

  float acc[8][8];
#pragma unroll
  for (int u = 0; u < 8; ++u)
#pragma unroll
    for (int v = 0; v < 8; ++v) acc[u][v] = 0.0f;

  for (int r0 = r_begin; r0 < r_end; r0 += kStepRows) {
    __syncthreads();  // the previous chunk is consumed
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      ds4[tid + u * kThreads] = nd[u];
      hs4[tid + u * kThreads] = nh[u];
    }
    __syncthreads();
    if (r0 + kStepRows < r_end) {
      load(dz2, h2w, j0, r0 + kStepRows, nd);
      load(h1, h1w, k0, r0 + kStepRows, nh);
    }
#pragma unroll 4
    for (int rr = 0; rr < kStepRows; ++rr) {
      const float4 d0 = ds4[rr * kQuads + ty], d1 = ds4[rr * kQuads + 16 + ty];
      const float4 g0 = hs4[rr * kQuads + tx], g1 = hs4[rr * kQuads + 16 + tx];
      const float dj[8] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
      const float hk[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int v = 0; v < 8; ++v)
          acc[u][v] = __fmaf_rn(dj[u], hk[v], acc[u][v]);
    }
  }
  float* out = slab2 + static_cast<size_t>(blockIdx.y) * h2w * h1w;
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int j = j0 + 4 * ty + (u < 4 ? u : 60 + u);
    if (j >= h2w) continue;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      const int k = k0 + 4 * tx + (v < 4 ? v : 60 + v);
      if (k < h1w) out[static_cast<size_t>(j) * h1w + k] = acc[u][v];
    }
  }
}

// out[p], p over the gradient entries in the torch order (w1, b1, g1, be1,
// w2, b2, ...): dW2 entries sum the ``splits`` dW2 slabs, the others the
// ``blocks`` row slabs; then the six metrics, means over the minibatch, as
// pallas_ppo.py:321-332 takes them.  Block x takes the 32 entries 32 x ..
// 32 x + 31 (the last block the 5 metric sums): warp w sums slabs w, w + 8,
// ... in turn, then the 8 warp sums are added in warp order.  The order is
// fixed, so repeats are bit-equal.
__global__ void __launch_bounds__(kThreads)
    ppo_reduce_kernel(const float* __restrict__ slab, int blocks,
                      int per_block, const float* __restrict__ slab2,
                      int splits, float* __restrict__ out, int w2_start,
                      int w2_size, int ngrad, float inv_n, float ent_beta) {
  __shared__ float part[kWarps][32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const bool metrics = blockIdx.x == (ngrad + 31) / 32;
  const int p = blockIdx.x * 32 + lane;
  const float* base = nullptr;
  size_t stride = per_block;
  int count = blocks;
  if (metrics) {
    if (lane < kMetrics) base = slab + per_block - kMetrics + lane;
  } else if (p < ngrad) {
    if (p >= w2_start && p < w2_start + w2_size) {
      base = slab2 + (p - w2_start);
      stride = w2_size;
      count = splits;
    } else {
      base = slab + (p < w2_start ? p : p - w2_size);
    }
  }
  float s = 0.0f;
  if (base) {
#pragma unroll 4
    for (int b = warp; b < count; b += kWarps) s += base[b * stride];
  }
  part[warp][lane] = s;
  __syncthreads();
  if (warp != 0) return;
  float t = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += part[w][lane];
  if (!metrics) {
    if (p < ngrad) out[p] = t;
    return;
  }
  float m[kMetrics];
#pragma unroll
  for (int i = 0; i < kMetrics; ++i) m[i] = __shfl_sync(0xffffffffu, t, i);
  if (lane == 0) {
    const float pol = m[0] * inv_n, val = m[1] * inv_n, ent = m[2] * inv_n;
    out[ngrad + 0] = pol + val - ent_beta * ent;
    out[ngrad + 1] = pol;
    out[ngrad + 2] = val;
    out[ngrad + 3] = ent;
    out[ngrad + 4] = m[3] * inv_n;
    out[ngrad + 5] = m[4] * inv_n;
  }
}

}  // namespace

// Shared memory bytes of the row kernel at these widths, how many of its
// blocks the card holds at once, and the number of SMs.  Opts the kernel in
// to the card's per-block maximum of dynamic shared memory.  Returns a
// cudaError (0 on success); cudaErrorInvalidValue for widths the kernels do
// not take (H1 or H2 not a multiple of 16 or above 256, more than 7
// actions, or more shared memory than a block may have).
extern "C" int ppo_fused_plan(int d, int h1, int h2, int a, int* smem,
                              int* blocks, int* sms) {
  const size_t bytes = static_cast<size_t>(row_smem_floats(d, h1, h2, a)) *
                       sizeof(float);
  *smem = static_cast<int>(bytes);
  *blocks = 0;
  *sms = 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(optin) || d < 1 || a < 1 || h1 < 16 ||
      h2 < 16 || h1 % 16 || h2 % 16 || h1 > kMaxWidth || h2 > kMaxWidth ||
      a + 1 > kMaxHeads)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ppo_row_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ppo_row_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ppo_row_kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = per_sm * *sms;
  return 0;
}

// Launches the row kernel on ``stream`` with ``blocks`` blocks, each writing
// ``slab[block][0 : layout total]``, and h1 [n, h1] and dz2 [n, h2] to the
// workspace.  ``n`` must be a multiple of 32 and ``smem`` the value
// ppo_fused_plan gave.  Returns cudaGetLastError() (0 on success); it does
// not synchronise.
extern "C" int ppo_fused_rows(
    const void* obs, const void* act, const void* oldlp, const void* adv,
    const void* ret, const void* oldv, const void* w1, const void* b1,
    const void* g1, const void* be1, const void* w2, const void* b2,
    const void* g2, const void* be2, const void* wp, const void* bp,
    const void* wv, const void* bv, void* slab, void* h1_out, void* dz2_out,
    int blocks, int smem, int n, int d, int h1, int h2, int a, int bf16,
    float inv_n, float lo, float hi, float clip_eps, float v_scale,
    float v_coef, float ent_scale, void* stream) {
  if (n <= 0 || n % kRows != 0 || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Batch in{static_cast<const float*>(obs), static_cast<const int64_t*>(act),
           static_cast<const float*>(oldlp), static_cast<const float*>(adv),
           static_cast<const float*>(ret), static_cast<const float*>(oldv)};
  Params w{static_cast<const float*>(w1), static_cast<const float*>(b1),
           static_cast<const float*>(g1), static_cast<const float*>(be1),
           static_cast<const float*>(w2), static_cast<const float*>(b2),
           static_cast<const float*>(g2), static_cast<const float*>(be2),
           static_cast<const float*>(wp), static_cast<const float*>(bp),
           static_cast<const float*>(wv), static_cast<const float*>(bv)};
  Scalars c{inv_n, lo, hi, clip_eps, v_scale, v_coef, ent_scale};
  ppo_row_kernel<<<blocks, kThreads, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      in, w, static_cast<float*>(slab), static_cast<float*>(h1_out),
      static_cast<float*>(dz2_out), n, d, h1, h2, a, bf16, c);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dW2 kernel: ``tiles`` 128 x 128 output tiles of [h2, h1] times
// ``splits`` row ranges of ``rows_per_split`` rows, into slab2 [splits][h2
// h1].  Returns cudaGetLastError().
extern "C" int ppo_fused_dw2(const void* dz2, const void* h1, void* slab2,
                             int n, int h1w, int h2w, int splits,
                             int rows_per_split, void* stream) {
  const int tiles = ((h2w + kTile - 1) / kTile) * ((h1w + kTile - 1) / kTile);
  if (n <= 0 || splits <= 0 || rows_per_split % kStepRows != 0 ||
      h1w % 4 || h2w % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  ppo_dw2_kernel<<<dim3(tiles, splits), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dz2), static_cast<const float*>(h1),
      static_cast<float*>(slab2), n, h1w, h2w, rows_per_split);
  return static_cast<int>(cudaGetLastError());
}

// Launches the reduction over the ``blocks`` row slabs of ``per_block``
// floats and the ``splits`` dW2 slabs into ``out``: ``ngrad`` gradient
// entries (dW2 at [w2_start, w2_start + w2_size)), then the six metrics.
extern "C" int ppo_fused_reduce(const void* slab, int blocks, int per_block,
                                const void* slab2, int splits, void* out,
                                int w2_start, int w2_size, int ngrad,
                                float inv_n, float ent_beta, void* stream) {
  const int grid = (ngrad + 31) / 32 + 1;
  ppo_reduce_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), blocks, per_block,
      static_cast<const float*>(slab2), splits, static_cast<float*>(out),
      w2_start, w2_size, ngrad, inv_n, ent_beta);
  return static_cast<int>(cudaGetLastError());
}

#ifdef PPO_PHASE_CLOCKS
// Copies the phase cycle sums of block 0 to ``out`` (kPhases values) and
// sets them to 0.
extern "C" int ppo_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, ppo_phase_cycles,
                                         sizeof(ppo_phase_cycles));
  unsigned long long zero[kPhases] = {};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(ppo_phase_cycles, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
