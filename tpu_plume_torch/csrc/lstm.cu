// The pointwise half of one step of the plain LSTM cell's BPTT replay,
// forward and backward: tpu_plume_torch/models/recurrent.py LSTMCell
// (flax's OptimizedLSTMCell), gates in the order (i, f, g, o), one bias on
// the hidden side, no +1 on the forget gate.
//
// Replaces no TPU kernel: the JAX package leaves the replay's scan to XLA
// (tpu_plume/models/recurrent.py), which fuses each step's gate arithmetic
// itself.  In PyTorch that arithmetic is about 13 elementwise kernels a step
// forward and 25 backward, each reading and writing whole [N, H] or [N, 4H]
// f32 tensors; at T = 128 steps those launches, not the work, set the
// replay's pace.  The wrapper, the plain PyTorch version of the same step and
// the loop around both are tpu_plume_torch/ops/lstm.py.
//
// Bound: bytes.  A step's products (z = h W_hh^T + b, and dz W_hh in the
// backward) stay cuBLAS calls outside these kernels; what is left does a few
// dozen operations per hidden unit on 16 (forward) and 14 (backward) floats
// of device memory.  At N = 2048, H = 128 that is about 16.8 MB and 14.7 MB
// a step: 5.0 us and 4.4 us at 3.35 TB/s.
//
// Design.  One thread per (row, 4 hidden units), with 16-byte loads and
// stores where H is a multiple of 4 and every pointer 16-byte aligned (else
// one unit a thread), so that a warp's accesses of each [N, H] or gate slice
// are contiguous.  The forward kernel of step t
//   - adds xi_t to the product's output,
//   - applies the gates with the eager ops' formulas: sigmoid(x) =
//     1 / (1 + expf(-x)) as PyTorch's CUDA sigmoid, tanhf as its tanh, and
//     each product and sum rounded on its own (-fmad=false), as the eager
//     ops round them, so that its outputs can equal the eager loop's to the
//     bit;
//   - zeroes the carry it reads where resets[t] is set, and writes the next
//     step's product input h already zeroed where resets[t + 1] is set: the
//     loop's two torch.where calls;
//   - writes h_t into hs[t] (what the heads read), c_t, and the four gate
//     activations, which with the masked h entering each step are all the
//     backward keeps: 6 [N, H] a step, against autograd's 7.
// The backward kernel of step t adds the heads' gradient of h_t to the
// recurrent one (dz_{t+1} W_hh, zeroed where resets[t + 1] is set),
// recomputes tanh(c_t), writes dz_t into a [T, N, 4H] buffer, which is the
// gradient of the input-side product's output, and updates dc in place to
// the gradient of c_{t-1} (zeroed where resets[t] is set; at t = 0 the
// initial carry's).  Each thread reads and writes only its own elements, so
// dc needs no second buffer.  The weight and bias gradients are one product
// and one reduction over all T x N rows of dz after the loop (ops/lstm.py).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -o liblstm.so lstm.cu
// (done by tpu_plume_torch/ops/build.py at first use).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGates = 4;

template <int V>
__device__ __forceinline__ void load(const float* p, float (&r)[V]) {
  if constexpr (V == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    r[0] = v.x;
    r[1] = v.y;
    r[2] = v.z;
    r[3] = v.w;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) r[k] = p[k];
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&r)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = r[k];
  }
}

// PyTorch's CUDA sigmoid: one / (one + std::exp(-a)).
__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Step t forward.  z [N, 4H]: h_{t-1} W_hh^T + b; xi [N, 4H]; c_prev [N, H]
// (c_{t-1}, or the initial c), zeroed here where reset[row]; act [N, 4H]
// gets (sig i, sig f, tanh g, sig o); c_out, h_out [N, H] get c_t, h_t;
// h_next [N, H] (null at the last step) gets h_t zeroed where
// reset_next[row].
template <int V>
__global__ void __launch_bounds__(kThreads)
    lstm_step_fwd_kernel(const float* __restrict__ z,
                         const float* __restrict__ xi,
                         const float* __restrict__ c_prev,
                         const bool* __restrict__ reset,
                         const bool* __restrict__ reset_next,
                         float* __restrict__ act, float* __restrict__ c_out,
                         float* __restrict__ h_out,
                         float* __restrict__ h_next, int n, int h) {
  const int groups = h / V;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(n) * groups) return;
  const int64_t row = idx / groups;
  const int col = static_cast<int>(idx - row * groups) * V;
  const int64_t gate = row * kGates * h + col;
  const int64_t unit = row * h + col;

  float zi[V], zf[V], zg[V], zo[V], x[V], c[V];
  load<V>(z + gate, zi);
  load<V>(z + gate + h, zf);
  load<V>(z + gate + 2 * h, zg);
  load<V>(z + gate + 3 * h, zo);
  load<V>(xi + gate, x);
#pragma unroll
  for (int k = 0; k < V; ++k) zi[k] = zi[k] + x[k];
  load<V>(xi + gate + h, x);
#pragma unroll
  for (int k = 0; k < V; ++k) zf[k] = zf[k] + x[k];
  load<V>(xi + gate + 2 * h, x);
#pragma unroll
  for (int k = 0; k < V; ++k) zg[k] = zg[k] + x[k];
  load<V>(xi + gate + 3 * h, x);
#pragma unroll
  for (int k = 0; k < V; ++k) zo[k] = zo[k] + x[k];
  load<V>(c_prev + unit, c);
  const bool r = reset[row];

  float hh[V], hm[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float si = sigmoid(zi[k]);
    const float sf = sigmoid(zf[k]);
    const float tg = tanhf(zg[k]);
    const float so = sigmoid(zo[k]);
    const float cp = r ? 0.0f : c[k];
    const float nc = sf * cp + si * tg;
    zi[k] = si;
    zf[k] = sf;
    zg[k] = tg;
    zo[k] = so;
    c[k] = nc;
    hh[k] = so * tanhf(nc);
  }
  store<V>(act + gate, zi);
  store<V>(act + gate + h, zf);
  store<V>(act + gate + 2 * h, zg);
  store<V>(act + gate + 3 * h, zo);
  store<V>(c_out + unit, c);
  store<V>(h_out + unit, hh);
  if (h_next != nullptr) {
    const bool rn = reset_next[row];
#pragma unroll
    for (int k = 0; k < V; ++k) hm[k] = rn ? 0.0f : hh[k];
    store<V>(h_next + unit, hm);
  }
}

// Step t backward.  dh_out [N, H]: the heads' gradient of h_t (null: 0);
// dh_rec [N, H]: dz_{t+1} W_hh, zeroed here where reset_next[row] (null:
// 0; reset_next null: not zeroed); act, c [N, 4H], [N, H]: step t's
// activations and c_t; c_prev as in the forward, zeroed where reset[row];
// dc [N, H]: in, the gradient of c_t from later steps; out, that of c_{t-1}
// zeroed where reset[row]; dz [N, 4H] gets the gates' pre-activation
// gradients.  The sigmoid and tanh backward keep autograd's forms,
// (g (1 - y)) y and g (1 - y^2).
template <int V>
__global__ void __launch_bounds__(kThreads)
    lstm_step_bwd_kernel(const float* __restrict__ dh_out,
                         const float* __restrict__ dh_rec,
                         const bool* __restrict__ reset_next,
                         const float* __restrict__ act,
                         const float* __restrict__ c_cur,
                         const float* __restrict__ c_prev,
                         const bool* __restrict__ reset,
                         float* __restrict__ dc, float* __restrict__ dz,
                         int n, int h) {
  const int groups = h / V;
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  if (idx >= static_cast<int64_t>(n) * groups) return;
  const int64_t row = idx / groups;
  const int col = static_cast<int>(idx - row * groups) * V;
  const int64_t gate = row * kGates * h + col;
  const int64_t unit = row * h + col;

  float dh[V], t[V];
#pragma unroll
  for (int k = 0; k < V; ++k) dh[k] = 0.0f;
  if (dh_out != nullptr) load<V>(dh_out + unit, dh);
  if (dh_rec != nullptr && !(reset_next != nullptr && reset_next[row])) {
    load<V>(dh_rec + unit, t);
#pragma unroll
    for (int k = 0; k < V; ++k) dh[k] = dh[k] + t[k];
  }
  float si[V], sf[V], tg[V], so[V], c[V], cp[V], dcv[V];
  load<V>(act + gate, si);
  load<V>(act + gate + h, sf);
  load<V>(act + gate + 2 * h, tg);
  load<V>(act + gate + 3 * h, so);
  load<V>(c_cur + unit, c);
  load<V>(c_prev + unit, cp);
  load<V>(dc + unit, dcv);
  const bool r = reset[row];

  float di[V], df[V], dg[V], dout[V];
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float tc = tanhf(c[k]);
    const float d = dcv[k] + (dh[k] * so[k]) * (1.0f - tc * tc);
    const float cprev = r ? 0.0f : cp[k];
    di[k] = ((d * tg[k]) * (1.0f - si[k])) * si[k];
    df[k] = ((d * cprev) * (1.0f - sf[k])) * sf[k];
    dg[k] = (d * si[k]) * (1.0f - tg[k] * tg[k]);
    dout[k] = ((dh[k] * tc) * (1.0f - so[k])) * so[k];
    dcv[k] = r ? 0.0f : d * sf[k];
  }
  store<V>(dz + gate, di);
  store<V>(dz + gate + h, df);
  store<V>(dz + gate + 2 * h, dg);
  store<V>(dz + gate + 3 * h, dout);
  store<V>(dc + unit, dcv);
}

inline bool bad_shape(int n, int h, int vec) {
  return n <= 0 || h <= 0 || (vec != 1 && vec != 4) || h % vec != 0;
}

inline unsigned grid_of(int n, int h, int vec) {
  const int64_t threads = static_cast<int64_t>(n) * (h / vec);
  return static_cast<unsigned>((threads + kThreads - 1) / kThreads);
}

template <int V>
void launch_fwd(const void* z, const void* xi, const void* c_prev,
                const void* reset, const void* reset_next, void* act,
                void* c_out, void* h_out, void* h_next, int n, int h,
                cudaStream_t stream) {
  lstm_step_fwd_kernel<V><<<grid_of(n, h, V), kThreads, 0, stream>>>(
      static_cast<const float*>(z), static_cast<const float*>(xi),
      static_cast<const float*>(c_prev), static_cast<const bool*>(reset),
      static_cast<const bool*>(reset_next), static_cast<float*>(act),
      static_cast<float*>(c_out), static_cast<float*>(h_out),
      static_cast<float*>(h_next), n, h);
}

template <int V>
void launch_bwd(const void* dh_out, const void* dh_rec,
                const void* reset_next, const void* act, const void* c_cur,
                const void* c_prev, const void* reset, void* dc, void* dz,
                int n, int h, cudaStream_t stream) {
  lstm_step_bwd_kernel<V><<<grid_of(n, h, V), kThreads, 0, stream>>>(
      static_cast<const float*>(dh_out), static_cast<const float*>(dh_rec),
      static_cast<const bool*>(reset_next), static_cast<const float*>(act),
      static_cast<const float*>(c_cur), static_cast<const float*>(c_prev),
      static_cast<const bool*>(reset), static_cast<float*>(dc),
      static_cast<float*>(dz), n, h);
}

}  // namespace

// Launches the forward kernel of one step on ``stream``; ``vec`` is 4 (H a
// multiple of 4, every pointer 16-byte aligned) or 1.  ``reset_next`` and
// ``h_next`` are null at the last step.  Returns cudaGetLastError() (0 on
// success); it does not synchronise.
extern "C" int lstm_step_fwd(const void* z, const void* xi,
                             const void* c_prev, const void* reset,
                             const void* reset_next, void* act, void* c_out,
                             void* h_out, void* h_next, int n, int h, int vec,
                             void* stream) {
  if (bad_shape(n, h, vec) || (h_next != nullptr && reset_next == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    launch_fwd<4>(z, xi, c_prev, reset, reset_next, act, c_out, h_out, h_next,
                  n, h, s);
  else
    launch_fwd<1>(z, xi, c_prev, reset, reset_next, act, c_out, h_out, h_next,
                  n, h, s);
  return static_cast<int>(cudaGetLastError());
}

// Launches the backward kernel of one step on ``stream``: ``dh_out``,
// ``dh_rec`` and ``reset_next`` may be null (see the kernel).  Returns
// cudaGetLastError().
extern "C" int lstm_step_bwd(const void* dh_out, const void* dh_rec,
                             const void* reset_next, const void* act,
                             const void* c_cur, const void* c_prev,
                             const void* reset, void* dc, void* dz, int n,
                             int h, int vec, void* stream) {
  if (bad_shape(n, h, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    launch_bwd<4>(dh_out, dh_rec, reset_next, act, c_cur, c_prev, reset, dc,
                  dz, n, h, s);
  else
    launch_bwd<1>(dh_out, dh_rec, reset_next, act, c_cur, c_prev, reset, dc,
                  dz, n, h, s);
  return static_cast<int>(cudaGetLastError());
}
