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
// Design.  The TPU kernel accumulates the gradients in place across a
// sequential grid.  H100 blocks run concurrently, so here:
//   ppo_fused_kernel    G blocks (G = what the card holds at once, at most
//                       the number of 16-row tiles); block b walks the tiles
//                       b, b + G, ... in order, keeps every activation of
//                       the tile in shared memory, and accumulates all
//                       gradients and metric sums of its tiles in shared
//                       memory; it writes them, once, to its own slab of a
//                       workspace;
//   ppo_reduce_kernel   sums the G slabs in block order for each entry and
//                       turns the metric sums into means.
// No float atomics: two calls on the same inputs give bit-equal gradients.
// Each forward product sums over k in turn from 0, and each LayerNorm stat
// in the lane order of warp_sum; the plain version in ops/ppo.py repeats
// that order under bf16, where the next product's rounding to bf16 would
// turn another order's last-bit differences into bf16-ulp ones.  Change
// both together.
// Weights are read from global memory (they stay in L1/L2); the products are
// FMA loops on the CUDA cores, with no tensor cores, TMA or cuBLAS.
//
// Bound: per row 2(D H1 + H1 H2 + H2 (A+1)) forward and about twice that
// backward operations; at the main path's (6, 256, 128, 5) and 65536 rows,
// about 1.4e10 operations, or 0.2 ms at the f32 CUDA-core peak, while the
// bytes (44 per row plus the weights) take about 1 us: the kernel is bound
// by operations.  This first version reads every operand of its inner loops
// from shared memory, which caps it well below that peak.
//
// Shared memory: the per-block accumulators (all gradients, about 145 KB
// at (256, 128)) plus one tile's activations, 16 x (D + 2 H1 + 3 H2 + A + 8)
// floats; above 48 KB it is opted in with cudaFuncSetAttribute.  Widths
// that need more than the card's per-block limit are refused by
// ppo_fused_plan, and the wrapper raises.
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
constexpr int kRows = 16;  // rows per tile (KERNEL_ROWS in ops/ppo.py)
constexpr int kMetrics = 5;
constexpr float kLnEps = 1e-6f;

// Offsets (floats) of each gradient in one block's accumulator, in the
// torch layout: Dense weights [out, in].  ``met`` is the number of gradient
// entries; the metric sums follow it.
struct Layout {
  int w1, b1, g1, be1, w2, b2, g2, be2, wp, bp, wv, bv, met, total;
};

__host__ __device__ inline Layout make_layout(int d, int h1, int h2, int a) {
  Layout l;
  int o = 0;
  l.w1 = o; o += h1 * d;
  l.b1 = o; o += h1;
  l.g1 = o; o += h1;
  l.be1 = o; o += h1;
  l.w2 = o; o += h2 * h1;
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

inline size_t smem_bytes(int d, int h1, int h2, int a) {
  const Layout l = make_layout(d, h1, h2, a);
  const size_t tile = static_cast<size_t>(kRows) *
                      (d + 2 * h1 + 3 * h2 + a + 3 + kMetrics);
  return (l.total + tile) * sizeof(float);
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
// z * g + be, rstd[r] <- 1 / sqrt(var + eps); one warp per row.
__device__ void layer_norm_rows(float* z, float* out, float* rstd,
                                const float* __restrict__ g,
                                const float* __restrict__ be, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* zr = z + r * h;
    float s = 0.0f, s2 = 0.0f;
    for (int k = lane; k < h; k += 32) {
      const float v = zr[k];
      s += v;
      s2 += v * v;
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mu = s / static_cast<float>(h);
    const float var = s2 / static_cast<float>(h) - mu * mu;
    const float rs = rsqrtf(var + kLnEps);
    for (int k = lane; k < h; k += 32) {
      const float xh = (zr[k] - mu) * rs;
      zr[k] = xh;
      out[r * h + k] = fmaxf(xh * g[k] + be[k], 0.0f);
    }
    if (lane == 0) rstd[r] = rs;
  }
}

// In place over rows of dy[kRows][h]: the LayerNorm backward
// dz = rstd * (dxh - mean(dxh) - xh * mean(dxh * xh)), dxh = dy * g;
// one warp per row.
__device__ void layer_norm_back_rows(float* dy, const float* xh,
                                     const float* rstd,
                                     const float* __restrict__ g, int h) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kWarps) {
    float* dr = dy + r * h;
    const float* xr = xh + r * h;
    float s = 0.0f, s2 = 0.0f;
    for (int k = lane; k < h; k += 32) {
      const float dxh = dr[k] * g[k];
      s += dxh;
      s2 += dxh * xr[k];
    }
    const float m1 = warp_sum(s) / static_cast<float>(h);
    const float m2 = warp_sum(s2) / static_cast<float>(h);
    const float rs = rstd[r];
    for (int k = lane; k < h; k += 32) {
      const float dxh = dr[k] * g[k];
      dr[k] = rs * (dxh - m1 - xr[k] * m2);
    }
  }
}

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

__global__ void __launch_bounds__(kThreads)
    ppo_fused_kernel(Batch in, Params w, float* __restrict__ slab, int n,
                     int d, int h1, int h2, int a, int bf16, Scalars c) {
  extern __shared__ float smem[];
  const Layout L = make_layout(d, h1, h2, a);
  float* acc = smem;                  // L.total
  float* xs = acc + L.total;          // [kRows][d]
  float* xh1 = xs + kRows * d;        // [kRows][h1]  z1, then its xh
  float* h1s = xh1 + kRows * h1;      // [kRows][h1]  h1, then dh1 -> dz1
  float* xh2 = h1s + kRows * h1;      // [kRows][h2]  z2, then its xh
  float* h2s = xh2 + kRows * h2;      // [kRows][h2]  h2
  float* dz2 = h2s + kRows * h2;      // [kRows][h2]  dy2 -> dz2
  float* rstd1 = dz2 + kRows * h2;    // [kRows]
  float* rstd2 = rstd1 + kRows;       // [kRows]
  float* dvs = rstd2 + kRows;         // [kRows]      value, then dv
  float* mrow = dvs + kRows;          // [kRows][kMetrics]
  float* dlog = mrow + kRows * kMetrics;  // [kRows][a]  logits, then dlogits

  const int tid = threadIdx.x;
  for (int i = tid; i < L.total; i += kThreads) acc[i] = 0.0f;

  const int tiles = n / kRows;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int row0 = tile * kRows;
    __syncthreads();  // the previous tile is done with every buffer
    for (int i = tid; i < kRows * d; i += kThreads)
      xs[i] = in.obs[static_cast<size_t>(row0) * d + i];
    __syncthreads();

    // ---- forward ----------------------------------------------------------
    // z1 = x W1^T + b1
    for (int i = tid; i < kRows * h1; i += kThreads) {
      const int r = i / h1, j = i % h1;
      float s = 0.0f;
      for (int k = 0; k < d; ++k)
        s += rnd(xs[r * d + k], bf16) * rnd(w.w1[j * d + k], bf16);
      xh1[i] = s + w.b1[j];
    }
    __syncthreads();
    layer_norm_rows(xh1, h1s, rstd1, w.g1, w.be1, h1);
    __syncthreads();

    // z2 = h1 W2^T + b2: item (j, half of the rows); W2's row j is read
    // once for the rows of the half.
    for (int i = tid; i < 2 * h2; i += kThreads) {
      const int j = i % h2, r0 = (i / h2) * (kRows / 2);
      float s[kRows / 2];
#pragma unroll
      for (int r = 0; r < kRows / 2; ++r) s[r] = 0.0f;
      const float* wr = w.w2 + static_cast<size_t>(j) * h1;
      for (int k = 0; k < h1; ++k) {
        const float wk = rnd(__ldg(wr + k), bf16);
#pragma unroll
        for (int r = 0; r < kRows / 2; ++r)
          s[r] += rnd(h1s[(r0 + r) * h1 + k], bf16) * wk;
      }
#pragma unroll
      for (int r = 0; r < kRows / 2; ++r) xh2[(r0 + r) * h2 + j] = s[r] + w.b2[j];
    }
    __syncthreads();
    layer_norm_rows(xh2, h2s, rstd2, w.g2, w.be2, h2);
    __syncthreads();

    // heads: logits = h2 Wp^T + bp, v = h2 Wv^T + bv
    for (int i = tid; i < kRows * (a + 1); i += kThreads) {
      const int r = i / (a + 1), col = i % (a + 1);
      const float* wr = col < a ? w.wp + col * h2 : w.wv;
      float s = 0.0f;
      for (int k = 0; k < h2; ++k)
        s += rnd(h2s[r * h2 + k], bf16) * rnd(wr[k], bf16);
      if (col < a)
        dlog[r * a + col] = s + w.bp[col];
      else
        dvs[r] = s + w.bv[0];
    }
    __syncthreads();

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
        const float p = expf(lp);
        const float aoh = k == act ? 1.0f : 0.0f;
        l[k] = g_newlp * (aoh - p) + (c.ent_scale * p) * (lp + ent);
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
    __syncthreads();

    // ---- backward -----------------------------------------------------------
    // metric sums; head grads; dy2 = (dlogits Wp + dv Wv) * (y2 > 0)
    if (tid < kMetrics) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += mrow[r * kMetrics + tid];
      acc[L.met + tid] += s;
    }
    for (int i = tid; i < (a + 1) * h2; i += kThreads) {
      const int col = i / h2, j = i % h2;
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r)
        s += (col < a ? dlog[r * a + col] : dvs[r]) * h2s[r * h2 + j];
      acc[(col < a ? L.wp + col * h2 : L.wv) + j] += s;
    }
    for (int col = tid; col < a + 1; col += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += col < a ? dlog[r * a + col] : dvs[r];
      acc[col < a ? L.bp + col : L.bv] += s;
    }
    for (int i = tid; i < kRows * h2; i += kThreads) {
      const int r = i / h2, j = i % h2;
      float s = 0.0f;
      for (int k = 0; k < a; ++k) s += dlog[r * a + k] * w.wp[k * h2 + j];
      const float dh2 = s + dvs[r] * w.wv[j];
      const float y2 = xh2[i] * w.g2[j] + w.be2[j];
      dz2[i] = dh2 * (y2 > 0.0f ? 1.0f : 0.0f);
    }
    __syncthreads();
    // LayerNorm_1 scale and bias grads, then dz2 in place
    for (int j = tid; j < h2; j += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float dy = dz2[r * h2 + j];
        sg += dy * xh2[r * h2 + j];
        sb += dy;
      }
      acc[L.g2 + j] += sg;
      acc[L.be2 + j] += sb;
    }
    __syncthreads();
    layer_norm_back_rows(dz2, xh2, rstd2, w.g2, h2);
    __syncthreads();

    // dW2 += dz2^T h1, db2 += sum dz2
    for (int i = tid; i < h2 * h1; i += kThreads) {
      const int j = i / h1, k = i % h1;
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += dz2[r * h2 + j] * h1s[r * h1 + k];
      acc[L.w2 + i] += s;
    }
    for (int j = tid; j < h2; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += dz2[r * h2 + j];
      acc[L.b2 + j] += s;
    }
    __syncthreads();

    // dy1 = (dz2 W2) * (y1 > 0), into h1s: item k, all rows
    for (int k = tid; k < h1; k += kThreads) {
      float s[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = 0.0f;
      for (int j = 0; j < h2; ++j) {
        const float wjk = __ldg(w.w2 + static_cast<size_t>(j) * h1 + k);
#pragma unroll
        for (int r = 0; r < kRows; ++r) s[r] += dz2[r * h2 + j] * wjk;
      }
      const float g = w.g1[k], be = w.be1[k];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float y1 = xh1[r * h1 + k] * g + be;
        h1s[r * h1 + k] = s[r] * (y1 > 0.0f ? 1.0f : 0.0f);
      }
    }
    __syncthreads();
    // LayerNorm_0 scale and bias grads, then dz1 in place
    for (int j = tid; j < h1; j += kThreads) {
      float sg = 0.0f, sb = 0.0f;
      for (int r = 0; r < kRows; ++r) {
        const float dy = h1s[r * h1 + j];
        sg += dy * xh1[r * h1 + j];
        sb += dy;
      }
      acc[L.g1 + j] += sg;
      acc[L.be1 + j] += sb;
    }
    __syncthreads();
    layer_norm_back_rows(h1s, xh1, rstd1, w.g1, h1);
    __syncthreads();

    // dW1 += dz1^T x, db1 += sum dz1
    for (int i = tid; i < h1 * d; i += kThreads) {
      const int j = i / d, k = i % d;
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += h1s[r * h1 + j] * xs[r * d + k];
      acc[L.w1 + i] += s;
    }
    for (int j = tid; j < h1; j += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < kRows; ++r) s += h1s[r * h1 + j];
      acc[L.b1 + j] += s;
    }
  }
  __syncthreads();
  float* out = slab + static_cast<size_t>(blockIdx.x) * L.total;
  for (int i = tid; i < L.total; i += kThreads) out[i] = acc[i];
}

// out[p] = sum over blocks b (in order) of slab[b][p] for the gradient
// entries; then the six metrics, means over the minibatch, as
// pallas_ppo.py:321-332 takes them.
__global__ void ppo_reduce_kernel(const float* __restrict__ slab,
                                  float* __restrict__ out, int blocks,
                                  int per_block, int ngrad, float inv_n,
                                  float ent_beta) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p < ngrad) {
    float s = 0.0f;
    for (int b = 0; b < blocks; ++b)
      s += slab[static_cast<size_t>(b) * per_block + p];
    out[p] = s;
  } else if (p == ngrad) {
    float m[kMetrics];
    for (int i = 0; i < kMetrics; ++i) {
      float s = 0.0f;
      for (int b = 0; b < blocks; ++b)
        s += slab[static_cast<size_t>(b) * per_block + ngrad + i];
      m[i] = s;
    }
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

// Shared memory bytes of the fused kernel at these widths, and how many of
// its blocks the card holds at once.  Opts the kernel in to the card's
// per-block maximum of dynamic shared memory.  Returns a cudaError (0 on
// success); cudaErrorInvalidValue when the widths need more shared memory
// than a block may have.
extern "C" int ppo_fused_plan(int d, int h1, int h2, int a, int* smem,
                              int* blocks) {
  const size_t bytes = smem_bytes(d, h1, h2, a);
  *smem = static_cast<int>(bytes);
  *blocks = 0;
  int dev = 0, optin = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (bytes > static_cast<size_t>(optin) || d < 1 || h1 < 1 || h2 < 1 ||
      a < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(ppo_fused_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ppo_fused_kernel,
                                                      kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *blocks = per_sm * sms;
  return 0;
}

// Launches the fused kernel on ``stream`` with ``blocks`` blocks, each
// writing ``slab[block][0 : layout total]``.  ``n`` must be a multiple of 16
// and ``smem`` the value ppo_fused_plan gave.  Returns cudaGetLastError()
// (0 on success); it does not synchronise.
extern "C" int ppo_fused_partials(
    const void* obs, const void* act, const void* oldlp, const void* adv,
    const void* ret, const void* oldv, const void* w1, const void* b1,
    const void* g1, const void* be1, const void* w2, const void* b2,
    const void* g2, const void* be2, const void* wp, const void* bp,
    const void* wv, const void* bv, void* slab, int blocks, int smem, int n,
    int d, int h1, int h2, int a, int bf16, float inv_n, float lo, float hi,
    float clip_eps, float v_scale, float v_coef, float ent_scale,
    void* stream) {
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
  ppo_fused_kernel<<<blocks, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      in, w, static_cast<float*>(slab), n, d, h1, h2, a, bf16, c);
  return static_cast<int>(cudaGetLastError());
}

// Launches the reduction over the ``blocks`` slabs of ``per_block`` floats
// into ``out``: ``ngrad`` gradient entries, then the six metrics.
extern "C" int ppo_fused_reduce(const void* slab, void* out, int blocks,
                                int per_block, int ngrad, float inv_n,
                                float ent_beta, void* stream) {
  constexpr int kReduceThreads = 256;
  const int grid = (ngrad + 1 + kReduceThreads - 1) / kReduceThreads;
  ppo_reduce_kernel<<<grid, kReduceThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(slab), static_cast<float*>(out), blocks,
      per_block, ngrad, inv_n, ent_beta);
  return static_cast<int>(cudaGetLastError());
}
