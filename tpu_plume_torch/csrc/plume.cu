// Analytic plume sample, and the whole analytic env step built around it.
//
// Replaces the Pallas kernel tpu_plume/ops/pallas_plume.py (_kernel,
// sample_plume_pallas), with the analytic models that the JAX package
// computes in XLA around it (tpu_plume/fields/analytic.py).  The sample at a
// query: cell = clip(floor(pos), 0, g-1); the base at the cell: the
// isotropic Gaussian peak*exp(-d^2 / 2 sigma^2), or the anisotropic
// dispersion in the episode's wind (crosswind sigma_y = max(sigma_y_min,
// 0.3 d^0.71) growing downwind, the centerline decaying as sigma_y_min /
// sigma_y, a compact kernel around and upwind of the source), of one source
// or of S sources, the extra ones and their strengths hashed from the seed,
// summed and capped at the peak; in 3-D flight the height's term (d^2 gains
// (z - source_z)^2, or the anisotropic plume's vertical profile); turbulence
// TI * (|N| or N + 0.3 sin(0.05x) cos(0.07y) + 0.2 U) with N and U from the
// two-round avalanche cell hash (tpu_plume/core/prng.py) and Box-Muller;
// conc = clip(base + turb, 0, peak); tke = turb, or 2|turb| (V1.0).  Two
// kernels compute it:
//
// - plume_sample_kernel: the sample alone, one thread per query (the TPU
//   kernel's own call; the env's fresh episodes of reset_from_draws).  28
//   bytes a query; at N = 4096 that is 115 KB, about 0.03 us at 3.35 TB/s,
//   so a call costs one launch whatever its work.
// - env_step_kernel: one analytic env step of every env, one thread per env
//   and one launch per step of the rollout (the JAX package's building block
//   "for future in-kernel rollout fusion", pallas_plume.py:6-7).  It computes
//   what env_step_plain (tpu_plume_torch/rollout/rollout.py) computes for
//   the analytic plume in 2-D or 3-D flight: the action from the logits
//   (Gumbel-max with the step's row of the chunk's Gumbel noise, or argmax)
//   and its log-prob; the move with the turbulence displacement and the
//   wind's advection, clipped or bounced (v1_0's elastic walls); the sample
//   at the new cell; the visit count; the v1_1, v1_0 or delta reward terms,
//   the terminal bonus with its depth and gate terms at the nearest source,
//   and done; the episode totals, row t of the trajectory and of the episode
//   record; and, where done, the fresh episode from the step's reset draws
//   (source, seed and wind) with its sample at the origin and a cleared
//   visit grid.  It writes the next obs into the obs row the policy reads
//   next.  The env state and the totals are updated in place.
// - bank_step_kernel: the same env step over a gridded bank read between
//   cells (subcell_sampling), one thread per env and one launch per step of
//   the rollout in place of env_step_plain's eager ops and its two bank
//   sample launches.  It runs env_step_kernel's body (step_env) with the
//   bank's field: the wind of the env's bank row at the new step (a [K, 2]
//   wind, or a [K, T, 2] one lerped over frames), the sub-cell sample of
//   bank_sample.cuh (shared with gather.cu) at the new position and step,
//   and for a finished env the fresh row min(floor(u K), K - 1), its source
//   and the sample at the origin at step 0.  Its log_softmax sums in the
//   order of PyTorch's on the card, so that the whole step equals
//   env_step_plain's on the card to the bit.  It takes the four bank
//   layouts of the bank sample (static, frames, one-frame and two-frame
//   3-D), in 2-D or 3-D flight.
//
// Modes.  The models are template parameters of both kernels (anisotropic,
// S > 1 sources, 3-D flight and, for the env step, a field with a wind), so
// that each configuration runs code without the others' branches and the
// isotropic 2-D instantiation is the code it was before the others
// existed; the entry points pick the instantiation from the PlumeField.  S
// is at most kMaxSources: the sources of one field live in a small array of
// the thread's, computed once per sample from the seed (3 hashes a source).
//
// Bound: about 290 bytes per env step for ppo_v2_0 (logits, Gumbel row,
// draws and state read; trajectory, record, state and obs written; a
// visit-grid clear adds D*D*4 bytes per finished env), about 1.2 MB and
// 0.35 us at N = 4096, bytes-bound.  The plain version takes about a
// hundred launches per step, each a fraction of that; one launch carries it
// all.  The work is per-env scalar code (two cell hashes, a few
// transcendentals, and for the anisotropic model two powf and four expf a
// source), so no shared memory or tensor cores: each thread reads its env's
// fields, which lie apart in memory, and the loads of one warp are
// coalesced across envs.  Blocks of 64 threads: at N = 4096 that is 64
// blocks on 64 of the 132 SMs, two warps on each, each warp on its own
// scheduler, so the latency of one thread's dependent chain (hash,
// exp/log/sin/cos) is what a step costs on the device; larger blocks would
// pile four warps on fewer SMs for no gain, and at 2^20 envs 64-thread
// blocks still fill every SM.  The bank step moves the env step's bytes
// less the wind's, plus the env's bank row, its wind frames and the
// sample's corners (4, 8 or 16 floats by layout, and as many again for a
// finished env's fresh sample): at wrf_les_3d's N = 32768 about 12 MB, a
// few microseconds at 3.35 TB/s, against the eager step's ~80 launches.
//
// Numerics: the hash and the turbulence are those of cell_hash.cuh (shared
// with the bank sample kernels of gather.cu): native uint32_t with the JAX
// package's constants, salts and order of operations, so the hash bits are
// equal, and the accurate libm floats; build without --use_fast_math and with
// -fmad=false so no multiply-add is contracted.  The env step and the bases
// repeat the plain version's operations in its order, with its constants
// folded as Python and PyTorch fold them (the wrapper passes each as the f32
// PyTorch uses): products of Python scalars in double, then one f32
// multiply; a division of a tensor by a Python scalar as a multiply by the
// f32 reciprocal, as PyTorch computes it on the card; a Python scalar divided
// by a tensor as reciprocal(tensor) * scalar; tensor ** p as torch.pow takes
// it (torch_pow).  So the position, the cells, the wind, the distance and
// done are bit-equal to the plain version's on the card for the same state.
//
// At N = 4096 a call's cost is the host's, so the entry points are a Python
// extension module (METH_FASTCALL functions of plain ints), as
// gather.cu's are.  The env step's pointers and scalars arrive once per
// chunk in an EnvStepParams (the bank step's in a BankStepParams) the
// wrapper fills; a launch takes its address, the step and the policy's two
// outputs.  The sample takes the address of its config's PlumeField.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -I<Python include> -o libplume.so plume.cu
// (done by tpu_plume_torch/ops/build.py at first use, and imported as the
// module ``plume``).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "bank_sample.cuh"
#include "cell_hash.cuh"

namespace {

using cell_hash::bits_to_uniform;
using cell_hash::cell_of;
using cell_hash::hash_cell;
using cell_hash::turbulence;

constexpr int kMaxSources = 8;
// Salts of the extra sources' hash draws (tpu_plume/fields/analytic.py:31):
// x, y and strength.
constexpr uint32_t kSaltSrc = 3u;

// The field scalars of the analytic plume, all 4 bytes (no padding), and
// the modes that pick a kernel's instantiation: filled by
// tpu_plume_torch/ops/plume.py (_PlumeField, field by field).
struct PlumeField {
  int grid;
  int signed_normal;
  int tke_abs_times_two;
  int anisotropic;
  int num_sources;           // S, 1 to kMaxSources
  int pos_dim;               // 2, or 3 in 3-D flight
  float peak;
  float two_sigma2;          // isotropic: 2 sigma^2
  float ti;
  float src_lo;              // extra sources: source_padding
  float src_span;            //   grid - 2 source_padding
  float q_lo;                //   strengths: source_strength_range
  float q_span;
  float sy_coef;             // anisotropic: sigma_y = max(sy_min,
  float sy_exp;              //   sy_coef d^sy_exp)
  float sy_min;
  float inv_two_sy_min2;     //   1 / (2 sy_min^2)
  float sz_coef;             // 3-D: sigma_z likewise
  float sz_exp;
  float sz_min;
  float inv_two_sz_min2;
  float source_z;
};

// The sources of one field: the primary source with strength 1, then, with
// kMulti, sources 1..S-1 and their strengths hashed from the seed
// (extra_sources and source_strengths of ops/plume.py).
struct Sources {
  float x[kMaxSources];
  float y[kMaxSources];
  float q[kMaxSources];
};

template <bool kMulti>
__device__ __forceinline__ void sources_of(const PlumeField& f, float sx,
                                           float sy, uint32_t seed,
                                           Sources& s) {
  s.x[0] = sx;
  s.y[0] = sy;
  s.q[0] = 1.0f;
  if constexpr (kMulti) {
    for (int k = 1; k < f.num_sources; ++k) {
      const uint32_t uk = static_cast<uint32_t>(k);
      const float ux = bits_to_uniform(hash_cell(seed, uk, 0u, kSaltSrc));
      const float uy = bits_to_uniform(hash_cell(seed, 0u, uk, kSaltSrc + 1u));
      const float uq = bits_to_uniform(hash_cell(seed, uk, uk, kSaltSrc + 2u));
      s.x[k] = f.src_span * ux + f.src_lo;
      s.y[k] = f.src_span * uy + f.src_lo;
      s.q[k] = f.q_span * uq + f.q_lo;
    }
  }
}

// x ** p as torch.pow(tensor, scalar) computes it on the card, which takes
// these exponents apart.
__device__ __forceinline__ float torch_pow(float x, float p) {
  if (p == 2.0f) return x * x;
  if (p == 3.0f) return x * x * x;
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

// The unit vector of the wind (w0, w1) as the plain version takes it,
// w / (sqrt(w0^2 + w1^2) + 1e-8).
__device__ __forceinline__ float2 unit_wind(float w0, float w1) {
  const float speed = sqrtf(w0 * w0 + w1 * w1) + 1e-8f;
  return make_float2(w0 / speed, w1 / speed);
}

// The base of one source at (sx, sy) at cell (fx, fy) and height z, in the
// order of isotropic_kernel / anisotropic_kernel (ops/plume.py); (u0, u1)
// is the unit wind.
template <bool kAniso, bool k3d>
__device__ __forceinline__ float source_base(const PlumeField& f, float fx,
                                             float fy, float z, float sx,
                                             float sy, float u0, float u1) {
  if constexpr (!kAniso) {
    const float dx = fx - sx;
    const float dy = fy - sy;
    float d2 = dx * dx + dy * dy;
    if constexpr (k3d) {
      const float dz = z - f.source_z;
      d2 = d2 + dz * dz;
    }
    return f.peak * expf(-d2 / f.two_sigma2);
  } else {
    const float r0 = fx - sx;
    const float r1 = fy - sy;
    const float downwind = r0 * u0 + r1 * u1;
    const float r2 = r0 * r0 + r1 * r1;
    const float cross2 = fmaxf(r2 - downwind * downwind, 0.0f);
    const float d = fmaxf(downwind, 0.0f);
    const float sigma = fmaxf(torch_pow(d, f.sy_exp) * f.sy_coef, f.sy_min);
    float centerline = ((1.0f / sigma) * f.sy_min) * f.peak;
    const float e_plume = expf(-cross2 / ((sigma * sigma) * 2.0f));
    const float e_blob = expf(-r2 * f.inv_two_sy_min2);
    float plume, blob;
    if constexpr (k3d) {
      const float dz = z - f.source_z;
      const float sigma_z =
          fmaxf(torch_pow(d, f.sz_exp) * f.sz_coef, f.sz_min);
      centerline = centerline * ((1.0f / sigma_z) * f.sz_min);
      const float vert = expf(-(dz * dz) / ((sigma_z * sigma_z) * 2.0f));
      const float blob_vert = expf(-(dz * dz) * f.inv_two_sz_min2);
      plume = (centerline * e_plume) * vert;
      blob = (e_blob * f.peak) * blob_vert;
    } else {
      plume = centerline * e_plume;
      blob = e_blob * f.peak;
    }
    return downwind >= 0.0f ? fmaxf(plume, blob) : blob;
  }
}

// conc and tke at the cell of (px, py) and height pz (3-D flight) of the
// field with sources ``s``, unit wind (u0, u1) (anisotropic) and 32-bit
// seed: one source's base, or min(peak, sum of strength * base).
template <bool kAniso, bool kMulti, bool k3d>
__device__ __forceinline__ void sample_at(const PlumeField& f, float px,
                                          float py, float pz,
                                          const Sources& s, float u0,
                                          float u1, uint32_t seed,
                                          float* conc, float* tke) {
  const int ix = cell_of(px, f.grid);
  const int iy = cell_of(py, f.grid);
  const float fx = static_cast<float>(ix);
  const float fy = static_cast<float>(iy);
  float base;
  if constexpr (kMulti) {
    float total = 0.0f;
    for (int k = 0; k < f.num_sources; ++k) {
      total = total + s.q[k] * source_base<kAniso, k3d>(f, fx, fy, pz, s.x[k],
                                                        s.y[k], u0, u1);
    }
    base = fminf(total, f.peak);
  } else {
    base = source_base<kAniso, k3d>(f, fx, fy, pz, s.x[0], s.y[0], u0, u1);
  }
  const float turb = turbulence(seed, ix, iy, f.ti, f.signed_normal);
  *conc = fminf(fmaxf(base + turb, 0.0f), f.peak);
  *tke = f.tke_abs_times_two ? fabsf(turb) * 2.0f : turb;
}

template <bool kAniso, bool kMulti, bool k3d>
__global__ void plume_sample_kernel(const PlumeField field,
                                    const float* __restrict__ pos,
                                    const float2* __restrict__ source,
                                    const int32_t* __restrict__ seed,
                                    const float2* __restrict__ wind,
                                    float* __restrict__ conc,
                                    float* __restrict__ tke, int n) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    float px, py, pz = 0.0f;
    if constexpr (k3d) {
      px = pos[3 * static_cast<int64_t>(i)];
      py = pos[3 * static_cast<int64_t>(i) + 1];
      pz = pos[3 * static_cast<int64_t>(i) + 2];
    } else {
      const float2 p = reinterpret_cast<const float2*>(pos)[i];
      px = p.x;
      py = p.y;
    }
    const float2 src = source[i];
    const uint32_t sd = static_cast<uint32_t>(seed[i]);
    Sources s;
    sources_of<kMulti>(field, src.x, src.y, sd, s);
    float2 u = make_float2(0.0f, 0.0f);
    if constexpr (kAniso) {
      if (wind != nullptr) {
        const float2 w = wind[i];
        u = unit_wind(w.x, w.y);
      }
    }
    sample_at<kAniso, kMulti, k3d>(field, px, py, pz, s, u.x, u.y, sd,
                                   &conc[i], &tke[i]);
  }
}

// --- the env step ------------------------------------------------------------

// Reward forms (EnvConfig.reward_variant).
constexpr int kV11 = 0;
constexpr int kV10 = 1;
constexpr int kDelta = 2;
constexpr int kEnvThreads = 64;
constexpr int kMaxActions = 8;

// Everything a launch of the env step needs but the step and the policy's
// outputs: filled once per chunk by tpu_plume_torch/ops/plume.py
// (_EnvStepParams, field by field; pointers, then ints, then the field, then
// floats, so the layout has no padding to disagree on).  P is pos_dim.
struct EnvStepParams {
  // The chunk's draws, [T', N, ...] with T' >= T; row t is read at step t.
  const float* turb;         // [T', N, P] displacement normals
  const float* gumbel;       // [T', N, A] Gumbel noise; null: argmax
  const float* u_src;        // [T', N, 2] reset source uniforms
  const float* u_wind;       // [T', N, 2] reset wind uniforms; null: no wind
  const int32_t* bits;       // [T', N] reset field seeds
  // The env state, [N, ...], updated in place.
  float* pos;                // [N, P]
  int32_t* t;
  int32_t* visited;          // [N, D, D]
  float* source;             // [N, 2]
  int32_t* seed;
  float* wind;               // [N, 2]; null: a field without wind
  float* conc;
  float* tke;
  float* prev_conc;
  int64_t* prev_action;
  const float* radius;
  const float* explore_bonus;
  // Episode totals [N], in EpisodeAccum's order: total reward,
  // concentration, exploration, move, TKE and boundary terms.
  float* acc[6];
  // The trajectory: obs [T+1, N, obs_dim] (step t writes row t+1), and
  // [T, N, ...] rows of RolloutStep and EpisodeRecord (step t writes row t).
  float* obs;
  int64_t* action;
  float* log_prob;
  float* value;
  float* reward;
  uint8_t* done;             // also the record's done
  float* traj_pos;           // [T, N, P], also the record's final x and y
  float* traj_conc;
  uint8_t* success;
  int32_t* steps;
  float* rec[6];             // the totals after the step, as acc
  float* final_conc;
  float* source_x;
  float* source_y;
  float* rec_radius;
  float* distance;
  // [T, N]: the executed action differs from the sampled one (a guided
  // chunk); null: an unguided chunk.
  uint8_t* override;
  int n;
  int length;                // T
  int num_actions;
  int obs_dim;
  int divisions;             // D
  int max_steps;
  int variant;
  int elastic;
  int obs_memory;
  PlumeField field;
  float move_step;
  float turb_scale;          // move_step * turb_displacement_coef
  float inv_tke_norm;        // 1 / (3 TI)
  float clip_hi;             // grid - clip_edge_eps
  float wall_lo;             // -0.1 grid
  float wall_hi;             // 1.1 grid
  float g;                   // grid
  float inv_g;
  float inv_peak;
  float inv_cell;
  float inv_visit_norm;
  float visit_pow;
  float inv_max_steps;
  float neg_move_coef;
  float inv_move_step;
  float v10_move;            // -v10_flat_move_penalty
  float v10_margin;          // v10_boundary_margin_frac * grid
  float v10_boundary;        // -v10_boundary_penalty
  float decay_start;
  float gradient_gate;
  float neg_boundary_penalty;
  float conc_coef;
  float inplume_bonus;
  float inplume_floor;
  float turn_half;           // readme_turn_penalty * 0.5
  float neg_tke_factor;
  float r0;                  // initial_radius
  float term_coef;
  float term_cap;
  float depth_coef;
  float depth_power;
  float gate_radius;
  float src_lo;              // source_padding
  float src_span;            // grid - 2 source_padding
  float z_move;              // 3-D: z_move_step
  float z_hi;                //   domain_height
  float inv_h;               //   1 / domain_height
  float advect;              // wind_advect_coef
  float w_lo;                // wind: wind_speed_range
  float w_span;
  float two_pi;
};

// The field of a step: the analytic plume, or a bank read by one of
// bank_sample.cuh's sample modes.
constexpr int kAnalytic = -1;

// Everything a launch of the bank step needs but the step and the policy's
// outputs: the env step's params (their field scalars only for the extra
// sources' hash and the checks; the state has no wind) and the bank's.
// Filled once per chunk by tpu_plume_torch/ops/plume.py (_BankStepParams).
struct BankStepParams {
  EnvStepParams env;
  BankParams bank;             // FieldBank.sampler's, the bank read
  int32_t* idx;                // [N] each env's bank row, updated in place
  const float* bank_source;    // [K, 2] each row's source
  const float* bank_wind;      // [K, 2] or [K, WT, 2]; null: no wind
  int rows;                    // K
  int wind_frames;             // WT, or 0 for a [K, 2] wind
};

// The bank's wind of row k at env step t, as fields/gridded.py bank_wind
// computes it: a [K, 2] wind's row, or a [K, WT, 2] wind lerped between
// frames t0 and min(t0 + 1, WT - 1) at t / steps_per_frame (a true
// division, frame_coord's); zero where the bank has no wind.
__device__ __forceinline__ float2 bank_wind(const BankStepParams& b, int64_t k,
                                            int t) {
  const float2* wind = reinterpret_cast<const float2*>(b.bank_wind);
  if (wind == nullptr) return make_float2(0.0f, 0.0f);
  const int nf = b.wind_frames;
  if (nf == 0) return wind[k];
  const float tf = static_cast<float>(t) / b.bank.steps_per_frame;
  const int t0 = min(max(static_cast<int>(floorf(tf)), 0), max(nf - 2, 0));
  const float ft = fminf(fmaxf(tf - static_cast<float>(t0), 0.0f), 1.0f);
  const float2 lo = wind[k * nf + t0];
  const float2 hi = wind[k * nf + min(t0 + 1, nf - 1)];
  return make_float2((1.0f - ft) * lo.x + ft * hi.x,
                     (1.0f - ft) * lo.y + ft * hi.y);
}

// The sum of expf(l[j] - lmax) over j < na in the order of log_softmax on
// the card for a row of at most 32 (PyTorch's softmax_warp_forward): a lane
// per element of the row padded with zeros to a power of two, summed by xor
// shuffles of halving offsets.  Padding to 8 adds zeros, which leaves each
// smaller power's sums as they are.
__device__ __forceinline__ float softmax_sum(const float (&l)[kMaxActions],
                                             int na, float lmax) {
  float e[kMaxActions];
#pragma unroll
  for (int j = 0; j < kMaxActions; ++j) e[j] = j < na ? expf(l[j] - lmax) : 0.0f;
#pragma unroll
  for (int w = kMaxActions / 2; w >= 1; w /= 2) {
#pragma unroll
    for (int j = 0; j < w; ++j) e[j] = e[j] + e[j + w];
  }
  return e[0];
}

// The displacement of an action: stay, +y, -y, +x, -x, and in 3-D flight
// +z, -z.
template <int P>
__device__ __forceinline__ void action_delta(int a, float m, float zm,
                                             float (&d)[P]) {
  for (int k = 0; k < P; ++k) d[k] = 0.0f;
  switch (a) {
    case 1: d[1] = m; break;
    case 2: d[1] = -m; break;
    case 3: d[0] = m; break;
    case 4: d[0] = -m; break;
    case 5: if constexpr (P == 3) d[2] = zm; break;
    case 6: if constexpr (P == 3) d[2] = -zm; break;
    default: break;
  }
}

// The sum of x[k] * y[k] over k, left to right.
template <int P>
__device__ __forceinline__ float dot(const float (&x)[P], const float (&y)[P]) {
  float s = x[0] * y[0] + x[1] * y[1];
  if constexpr (P == 3) s = s + x[2] * y[2];
  return s;
}

// One env step of this thread's env: the body of env_step_kernel (kBank ==
// kAnalytic) and of bank_step_kernel (kBank a bank_sample::Mode, with the
// bank's params ``b``), which differ in the field alone: its wind, its
// sample, its fresh episodes, and the order of log_softmax's sum.  ``p``
// arrives by value: a reference to the kernel's parameter keeps the
// compiler from loading its fields ahead of a branch, and the analytic
// instantiations then compile to other code than the kernel's own body did.
template <bool kAniso, bool kMulti, bool k3d, bool kWind, int kBank>
__device__ __forceinline__ void step_env(const EnvStepParams p,
                                         const BankStepParams* b, int step,
                                         const float* __restrict__ logits,
                                         const float* __restrict__ value_in,
                                         const int64_t* __restrict__ exec_action) {
  constexpr int P = k3d ? 3 : 2;
  constexpr bool kOnBank = kBank != kAnalytic;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p.n) return;
  const int64_t row = static_cast<int64_t>(step) * p.n + i;
  const int na = p.num_actions;

  // The action: the first maximal index of logits (+ Gumbel row), as
  // torch.argmax; log_prob as log_softmax takes it, (l - max) - log(sum).
  const float* lg = logits + static_cast<int64_t>(i) * na;
  const float* gb = p.gumbel == nullptr ? nullptr : p.gumbel + row * na;
  float l[kMaxActions];
  for (int j = 0; j < na; ++j) l[j] = lg[j];
  float lmax = l[0];
  float best = gb == nullptr ? l[0] : l[0] + gb[0];
  int action = 0;
  for (int j = 1; j < na; ++j) {
    lmax = fmaxf(lmax, l[j]);
    const float s = gb == nullptr ? l[j] : l[j] + gb[j];
    if (s > best) {
      best = s;
      action = j;
    }
  }
  float sum = 0.0f;
  if constexpr (kOnBank) {
    sum = softmax_sum(l, na, lmax);
  } else {
    for (int j = 0; j < na; ++j) sum += expf(l[j] - lmax);
  }
  const float log_prob = (l[action] - lmax) - logf(sum);
  // The executed action: a guide's where the launch gives one, else the
  // sampled one.  The record keeps the sampled action and its log-prob;
  // the move, prev_action and the obs one-hot take the executed one.
  const int act =
      exec_action == nullptr ? action : static_cast<int>(exec_action[i]);

  // The move: delta, the turbulence displacement from the TKE at the old
  // cell, the wind's advection (horizontal), then the clip (or v1_0's
  // bounce back; z to [0, domain_height]).
  float pos0[P], nz[P], d[P], r[P];
  if constexpr (k3d) {
    for (int k = 0; k < P; ++k) {
      pos0[k] = p.pos[static_cast<int64_t>(i) * P + k];
      nz[k] = p.turb[row * P + k];
    }
  } else {
    const float2 q = reinterpret_cast<const float2*>(p.pos)[i];
    const float2 e = reinterpret_cast<const float2*>(p.turb)[row];
    pos0[0] = q.x;
    pos0[1] = q.y;
    nz[0] = e.x;
    nz[1] = e.y;
  }
  const float conc0 = p.conc[i];
  const float tke0 = p.tke[i];
  const int t_new = p.t[i] + 1;
  int64_t bank_row = 0;
  if constexpr (kOnBank) bank_row = b->idx[i];
  action_delta<P>(act, p.move_step, p.z_move, d);
  const float delta_norm = sqrtf(dot<P>(d, d));
  for (int k = 0; k < P; ++k) {
    r[k] = (pos0[k] + d[k]) + ((p.turb_scale * nz[k]) * tke0) * p.inv_tke_norm;
  }
  float2 w = make_float2(0.0f, 0.0f);
  if constexpr (kOnBank) {
    // the bank's wind at the new step (zero where the bank has none)
    if (p.advect != 0.0f) {
      w = bank_wind(*b, bank_row, t_new);
      r[0] = r[0] + w.x * p.advect;
      r[1] = r[1] + w.y * p.advect;
      if constexpr (k3d) r[2] = r[2] + 0.0f;
    }
  } else if constexpr (kWind) {
    w = reinterpret_cast<const float2*>(p.wind)[i];
    if (p.advect != 0.0f) {
      r[0] = r[0] + w.x * p.advect;
      r[1] = r[1] + w.y * p.advect;
      if constexpr (k3d) r[2] = r[2] + 0.0f;
    }
  }
  float pn[P];
  if (!k3d && p.elastic) {
    const float cx = fminf(fmaxf(r[0], p.wall_lo), p.wall_hi);
    const float cy = fminf(fmaxf(r[1], p.wall_lo), p.wall_hi);
    const bool out = cx < 0.0f || cx > p.g || cy < 0.0f || cy > p.g;
    pn[0] = out ? pos0[0] : cx;
    pn[1] = out ? pos0[1] : cy;
  } else {
    pn[0] = fminf(fmaxf(r[0], 0.0f), p.clip_hi);
    pn[1] = fminf(fmaxf(r[1], 0.0f), p.clip_hi);
    if constexpr (k3d) pn[P - 1] = fminf(fmaxf(r[P - 1], 0.0f), p.z_hi);
  }
  const float px = pn[0];
  const float py = pn[1];
  const float pz = k3d ? pn[P - 1] : 0.0f;

  // The sample at the new cell, of the field's sources and wind, or of the
  // env's bank row at the new position and step.
  const float2 src = reinterpret_cast<const float2*>(p.source)[i];
  const uint32_t seed = static_cast<uint32_t>(p.seed[i]);
  Sources srcs;
  if constexpr (!kOnBank) sources_of<kMulti>(p.field, src.x, src.y, seed, srcs);
  float2 uw = make_float2(0.0f, 0.0f);
  if constexpr (kAniso && kWind) uw = unit_wind(w.x, w.y);
  float cur_conc, cur_tke;
  if constexpr (kOnBank) {
    bank_sample::Query<kBank> q;
    q.fetch(b->bank, bank_row, px, py, pz, &t_new, seed);
    q.finish(b->bank, &cur_conc, &cur_tke);
  } else {
    sample_at<kAniso, kMulti, k3d>(p.field, px, py, pz, srcs, uw.x, uw.y, seed,
                                   &cur_conc, &cur_tke);
  }
  const float cur_n = cur_conc * p.inv_peak;
  const float prev_n = conc0 * p.inv_peak;

  // The boundary term.
  const float border = fminf(fminf(px, p.g - px), fminf(py, p.g - py));
  float boundary = 0.0f;
  if (p.variant == kV10) {
    if (border < p.v10_margin) boundary = p.v10_boundary;
  } else {
    const float gradient = (cur_n - prev_n) / (delta_norm + 1e-6f);
    const float bd = border * p.inv_g;
    if (bd < p.decay_start && gradient < p.gradient_gate) {
      const float gap = p.decay_start - bd;
      boundary = p.neg_boundary_penalty * (gap * gap);
    }
  }

  // The visit at the new cell, counted before it is read.
  const int nd = p.divisions;
  const int ex = min(max(static_cast<int>(floorf(px * p.inv_cell)), 0), nd - 1);
  const int ey = min(max(static_cast<int>(floorf(py * p.inv_cell)), 0), nd - 1);
  int32_t* grid = p.visited + static_cast<int64_t>(i) * nd * nd;
  const int visits_i = grid[ex * nd + ey] + 1;
  const float visits = static_cast<float>(visits_i);
  const float level = fminf(visits * p.inv_visit_norm, 1.0f);
  const float bonus = p.explore_bonus[i];
  const float explore =
      p.variant == kV10
          ? bonus / (visits + 1.0f)
          : (bonus * (1.0f - level)) / (torch_pow(visits, p.visit_pow) + 1.0f);

  // The move, concentration and TKE terms; in 3-D flight every move,
  // vertical ones too, is a full move.
  float move;
  if (p.variant == kV10) {
    move = p.v10_move;
  } else if constexpr (k3d) {
    move = p.neg_move_coef * (1.0f - (delta_norm > 0.0f ? 1.0f : 0.0f));
  } else {
    move = p.neg_move_coef * (1.0f - delta_norm * p.inv_move_step);
  }
  float conc_r;
  if (p.variant == kDelta) {
    conc_r = p.conc_coef * (cur_n - prev_n);
    if (p.inplume_bonus > 0.0f) {
      conc_r = conc_r +
               p.inplume_bonus * (cur_n >= p.inplume_floor ? 1.0f : 0.0f);
    }
    float dp[P];
    action_delta<P>(static_cast<int>(p.prev_action[i]), p.move_step, p.z_move,
                    dp);
    const float dotv = dot<P>(dp, d);
    const float norms = sqrtf(dot<P>(dp, dp)) * delta_norm;
    const float cosv = norms > 0.0f ? dotv / fmaxf(norms, 1e-6f) : 1.0f;
    move = move - p.turn_half * (1.0f - cosv);
  } else {
    conc_r = p.conc_coef * cur_n;
  }
  const float tke_r = p.neg_tke_factor * (cur_tke * p.inv_tke_norm);
  float total = (((conc_r + explore) + move) + tke_r) + boundary;

  // The terminal bonus within the curriculum radius of the nearest source
  // (horizontal), and done.
  const float dxs = px - src.x;
  const float dys = py - src.y;
  float distance = sqrtf(dxs * dxs + dys * dys);
  if constexpr (kMulti) {
    for (int k = 1; k < p.field.num_sources; ++k) {
      const float ex2 = px - srcs.x[k];
      const float ey2 = py - srcs.y[k];
      distance = fminf(distance, sqrtf(ex2 * ex2 + ey2 * ey2));
    }
  } else if constexpr (kOnBank) {
    // a bank's field has one source, but the terminal gate still takes the
    // nearest of num_sources, the extra ones hashed from the seed
    if (p.field.num_sources > 1) {
      sources_of<true>(p.field, src.x, src.y, seed, srcs);
      for (int k = 1; k < p.field.num_sources; ++k) {
        const float ex2 = px - srcs.x[k];
        const float ey2 = py - srcs.y[k];
        distance = fminf(distance, sqrtf(ex2 * ex2 + ey2 * ey2));
      }
    }
  }
  const float radius = p.radius[i];
  const bool reached = distance <= radius;
  const float ratio = (1.0f / radius) * p.r0;
  float term = p.variant == kV10 ? ratio * 100.0f
                                 : fminf(p.term_coef * ratio, p.term_cap);
  if (p.depth_coef != 0.0f) {
    float depth = fmaxf(radius - distance, 0.0f) / radius;
    if (p.depth_power != 1.0f) depth = torch_pow(depth, p.depth_power);
    term = term + p.depth_coef * depth;
  }
  if (p.gate_radius != 0.0f) {
    term = term * (distance <= p.gate_radius ? 1.0f : 0.0f);
  }
  total = total + (reached ? term : 0.0f);
  const bool done = t_new >= p.max_steps || reached;

  // Every load is issued before the first store: as far as the compiler
  // knows the params' pointers may alias, so a load after a store would
  // wait for it, one memory round trip each.
  float acc[6];
  for (int k = 0; k < 6; ++k) acc[k] = p.acc[k][i];
  const float value = value_in[i];
  const float2 u = reinterpret_cast<const float2*>(p.u_src)[row];
  const int32_t nseed = p.bits[row];
  float2 uwd = make_float2(0.0f, 0.0f);
  if constexpr (kWind) uwd = reinterpret_cast<const float2*>(p.u_wind)[row];
  // A finished env's fresh episode on the bank: its row min(floor(u K),
  // K - 1) (the f32 product of new_field_from_draws), that row's source,
  // and the sample at the origin at step 0.
  int fresh_row = 0;
  float2 fresh_src = make_float2(0.0f, 0.0f);
  float fresh_conc = 0.0f, fresh_tke = 0.0f;
  if constexpr (kOnBank) {
    if (done) {
      fresh_row = min(static_cast<int>(u.x * static_cast<float>(b->rows)),
                      b->rows - 1);
      fresh_src = reinterpret_cast<const float2*>(b->bank_source)[fresh_row];
      const int32_t t0 = 0;
      bank_sample::Query<kBank> q;
      q.fetch(b->bank, fresh_row, 0.0f, 0.0f, 0.0f, &t0,
              static_cast<uint32_t>(nseed));
      q.finish(b->bank, &fresh_conc, &fresh_tke);
    }
  }

  // Episode totals: the record holds them after the step; a finished env's
  // are cleared by the plain version's multiply (signed zeros kept).
  const float terms[6] = {total, conc_r, explore, move, tke_r, boundary};
  const float keep = 1.0f - (done ? 1.0f : 0.0f);
  for (int k = 0; k < 6; ++k) {
    const float s = acc[k] + terms[k];
    p.rec[k][row] = s;
    p.acc[k][i] = s * keep;
  }
  p.action[row] = action;
  p.log_prob[row] = log_prob;
  if (p.override != nullptr) p.override[row] = act != action;
  p.value[row] = value;
  p.reward[row] = total;
  p.done[row] = done;
  if constexpr (k3d) {
    for (int k = 0; k < P; ++k) p.traj_pos[row * P + k] = pn[k];
  } else {
    reinterpret_cast<float2*>(p.traj_pos)[row] = make_float2(px, py);
  }
  p.traj_conc[row] = cur_conc;
  p.success[row] = reached;
  p.steps[row] = t_new;
  p.final_conc[row] = reached ? cur_conc : 0.0f;
  p.source_x[row] = src.x;
  p.source_y[row] = src.y;
  p.rec_radius[row] = radius;
  p.distance[row] = distance;

  // The next state and obs: a fresh episode where done, else the moved env.
  float* obs = p.obs + (static_cast<int64_t>(step + 1) * p.n + i) * p.obs_dim;
  float ox, oy, oz, oc, ok, ot, ol, odc;
  int oa;
  float* pos_out = p.pos + static_cast<int64_t>(i) * P;
  if (done) {
    // a bank's fresh episode: the row, source and sample found above
    const float sx = kOnBank ? fresh_src.x : p.src_span * u.x + p.src_lo;
    const float sy = kOnBank ? fresh_src.y : p.src_span * u.y + p.src_lo;
    const uint32_t ns = static_cast<uint32_t>(nseed);
    Sources fresh;
    if constexpr (!kOnBank) sources_of<kMulti>(p.field, sx, sy, ns, fresh);
    float2 nw = make_float2(0.0f, 0.0f);
    float2 nu = make_float2(0.0f, 0.0f);
    if constexpr (kWind) {
      const float speed = p.w_span * uwd.x + p.w_lo;
      const float theta = uwd.y * p.two_pi;
      nw = make_float2(speed * cosf(theta), speed * sinf(theta));
      if constexpr (kAniso) nu = unit_wind(nw.x, nw.y);
    }
    float c0 = fresh_conc, k0 = fresh_tke;
    if constexpr (kOnBank) {
      b->idx[i] = fresh_row;
    } else {
      sample_at<kAniso, kMulti, k3d>(p.field, 0.0f, 0.0f, 0.0f, fresh, nu.x,
                                     nu.y, ns, &c0, &k0);
    }
    if constexpr (k3d) {
      for (int k = 0; k < P; ++k) pos_out[k] = 0.0f;
    } else {
      reinterpret_cast<float2*>(p.pos)[i] = make_float2(0.0f, 0.0f);
    }
    p.t[i] = 0;
    for (int c = 0; c < nd * nd; ++c) grid[c] = 0;
    reinterpret_cast<float2*>(p.source)[i] = make_float2(sx, sy);
    p.seed[i] = nseed;
    if constexpr (kWind) reinterpret_cast<float2*>(p.wind)[i] = nw;
    p.conc[i] = c0;
    p.tke[i] = k0;
    p.prev_conc[i] = c0;
    p.prev_action[i] = 0;
    ox = oy = oz = ot = ol = 0.0f;
    oc = c0 * p.inv_peak;
    ok = k0 * p.inv_tke_norm;
    odc = (c0 - c0) * p.inv_peak;
    oa = 0;
  } else {
    if constexpr (k3d) {
      for (int k = 0; k < P; ++k) pos_out[k] = pn[k];
    } else {
      reinterpret_cast<float2*>(p.pos)[i] = make_float2(px, py);
    }
    p.t[i] = t_new;
    grid[ex * nd + ey] = visits_i;
    p.conc[i] = cur_conc;
    p.tke[i] = cur_tke;
    p.prev_conc[i] = conc0;
    p.prev_action[i] = act;
    ox = px * p.inv_g;
    oy = py * p.inv_g;
    oz = pz * p.inv_h;
    oc = cur_n;
    ok = cur_tke * p.inv_tke_norm;
    ot = static_cast<float>(t_new) * p.inv_max_steps;
    ol = level;
    odc = (cur_conc - conc0) * p.inv_peak;
    oa = act;
  }
  int o = 0;
  obs[o++] = ox;
  obs[o++] = oy;
  if constexpr (k3d) obs[o++] = oz;
  obs[o++] = oc;
  obs[o++] = ok;
  obs[o++] = ot;
  obs[o++] = ol;
  if (p.obs_memory) {
    obs[o++] = odc;
    for (int j = 0; j < na; ++j) obs[o + j] = j == oa ? 1.0f : 0.0f;
  }
}

template <bool kAniso, bool kMulti, bool k3d, bool kWind>
__global__ void __launch_bounds__(kEnvThreads)
    env_step_kernel(const EnvStepParams p, int step,
                    const float* __restrict__ logits,
                    const float* __restrict__ value_in,
                    const int64_t* __restrict__ exec_action) {
  step_env<kAniso, kMulti, k3d, kWind, kAnalytic>(p, nullptr, step, logits,
                                                  value_in, exec_action);
}

// One env step of every env over a bank (kMode, a sample mode of
// bank_sample.cuh), in 2-D or 3-D flight.
template <int kMode, bool k3d>
__global__ void __launch_bounds__(kEnvThreads)
    bank_step_kernel(const BankStepParams b, int step,
                     const float* __restrict__ logits,
                     const float* __restrict__ value_in,
                     const int64_t* __restrict__ exec_action) {
  step_env<false, false, k3d, false, kMode>(b.env, &b, step, logits,
                                            value_in, exec_action);
}

// The instantiations, indexed by mode: anisotropic * 4 + multi-source * 2 +
// 3-D (the sample); the same * 2 + wind (the env step; a wind only with the
// anisotropic model).
template <bool A, bool M, bool Z>
void launch_sample(const PlumeField& f, const float* pos, const float2* src,
                   const int32_t* seed, const float2* wind, float* conc,
                   float* tke, int n, cudaStream_t stream) {
  constexpr int kThreads = 256;
  const int blocks = min((n + kThreads - 1) / kThreads, 132 * 16);
  plume_sample_kernel<A, M, Z><<<blocks, kThreads, 0, stream>>>(
      f, pos, src, seed, wind, conc, tke, n);
}

using SampleLaunch = void (*)(const PlumeField&, const float*, const float2*,
                              const int32_t*, const float2*, float*, float*,
                              int, cudaStream_t);
constexpr SampleLaunch kSampleLaunch[8] = {
    launch_sample<false, false, false>, launch_sample<false, false, true>,
    launch_sample<false, true, false>,  launch_sample<false, true, true>,
    launch_sample<true, false, false>,  launch_sample<true, false, true>,
    launch_sample<true, true, false>,   launch_sample<true, true, true>};

template <bool A, bool M, bool Z, bool W>
void launch_env_step(const EnvStepParams& p, int step, const float* logits,
                     const float* value, const int64_t* exec_action,
                     cudaStream_t stream) {
  const int blocks = (p.n + kEnvThreads - 1) / kEnvThreads;
  env_step_kernel<A, M, Z, W><<<blocks, kEnvThreads, 0, stream>>>(
      p, step, logits, value, exec_action);
}

using EnvLaunch = void (*)(const EnvStepParams&, int, const float*,
                           const float*, const int64_t*, cudaStream_t);
constexpr EnvLaunch kEnvLaunch[16] = {
    launch_env_step<false, false, false, false>, nullptr,
    launch_env_step<false, false, true, false>,  nullptr,
    launch_env_step<false, true, false, false>,  nullptr,
    launch_env_step<false, true, true, false>,   nullptr,
    launch_env_step<true, false, false, false>,
    launch_env_step<true, false, false, true>,
    launch_env_step<true, false, true, false>,
    launch_env_step<true, false, true, true>,
    launch_env_step<true, true, false, false>,
    launch_env_step<true, true, false, true>,
    launch_env_step<true, true, true, false>,
    launch_env_step<true, true, true, true>};

template <int M, bool Z>
void launch_bank_step(const BankStepParams& b, int step, const float* logits,
                      const float* value, const int64_t* exec_action,
                      cudaStream_t stream) {
  const int blocks = (b.env.n + kEnvThreads - 1) / kEnvThreads;
  bank_step_kernel<M, Z><<<blocks, kEnvThreads, 0, stream>>>(
      b, step, logits, value, exec_action);
}

using BankLaunch = void (*)(const BankStepParams&, int, const float*,
                            const float*, const int64_t*, cudaStream_t);
// Indexed by (sample mode - kStatic) * 2 + 3-D flight.
constexpr BankLaunch kBankLaunch[8] = {
    launch_bank_step<bank_sample::kStatic, false>,
    launch_bank_step<bank_sample::kStatic, true>,
    launch_bank_step<bank_sample::kFrames, false>,
    launch_bank_step<bank_sample::kFrames, true>,
    launch_bank_step<bank_sample::kOneFrame, false>,
    launch_bank_step<bank_sample::kOneFrame, true>,
    launch_bank_step<bank_sample::kTwoFrames, false>,
    launch_bank_step<bank_sample::kTwoFrames, true>};

// The sample's instantiation index of ``f``, or -1 (a Python error set)
// for modes the kernels do not take.
int sample_mode(const PlumeField& f) {
  if (f.num_sources < 1 || f.num_sources > kMaxSources) {
    PyErr_Format(PyExc_ValueError,
                 "the plume kernels take 1 to %d sources, got %d",
                 kMaxSources, f.num_sources);
    return -1;
  }
  if (f.pos_dim != 2 && f.pos_dim != 3) {
    PyErr_Format(PyExc_ValueError, "pos_dim must be 2 or 3, got %d",
                 f.pos_dim);
    return -1;
  }
  return (f.anisotropic ? 4 : 0) + (f.num_sources > 1 ? 2 : 0) +
         (f.pos_dim == 3 ? 1 : 0);
}

// --- Python entry points ----------------------------------------------------
//
// METH_FASTCALL functions: pointers and the stream arrive as Python ints (a
// null pointer as None), counts as ints.  Each reads its arguments in
// order, raises at the first bad one before anything is
// launched, launches on the stream and raises RuntimeError if the launch is
// refused (the cudaGetLastError() right after it); none synchronises.

bool parse(PyObject* o, void** out) {
  *out = o == Py_None ? nullptr : PyLong_AsVoidPtr(o);
  return !PyErr_Occurred();
}

bool parse(PyObject* o, int* out) {
  const long v = PyLong_AsLong(o);
  if (v == -1 && PyErr_Occurred()) return false;
  if (v < 0 || v > INT_MAX) {
    PyErr_Format(PyExc_OverflowError, "%ld is not in the kernel's int range",
                 v);
    return false;
  }
  *out = static_cast<int>(v);
  return true;
}

PyObject* launched(const char* what) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) {
    return PyErr_Format(PyExc_RuntimeError,
                        "%s launch failed: cudaError %d (%s)", what, err,
                        cudaGetErrorString(static_cast<cudaError_t>(err)));
  }
  Py_RETURN_NONE;
}

// plume_sample(field, pos, source, seed, wind, conc, tke, n, stream): the
// PlumeField at address ``field`` picks the instantiation; ``wind`` may be
// None (a field without wind: zero wind).
PyObject* py_plume_sample(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  if (nargs != 9) {
    PyErr_SetString(PyExc_TypeError,
                    "plume_sample takes (field, pos, source, seed, wind, "
                    "conc, tke, n, stream)");
    return nullptr;
  }
  void *field, *pos, *source, *seed, *wind, *conc, *tke, *stream;
  int n;
  if (!parse(a[0], &field) || !parse(a[1], &pos) || !parse(a[2], &source) ||
      !parse(a[3], &seed) || !parse(a[4], &wind) || !parse(a[5], &conc) ||
      !parse(a[6], &tke) || !parse(a[7], &n) || !parse(a[8], &stream)) {
    return nullptr;
  }
  if (field == nullptr) {
    PyErr_SetString(PyExc_ValueError, "plume_sample needs its PlumeField");
    return nullptr;
  }
  const PlumeField& f = *static_cast<const PlumeField*>(field);
  const int mode = sample_mode(f);
  if (mode < 0) return nullptr;
  if ((f.pos_dim == 2 && reinterpret_cast<uintptr_t>(pos) % 8 != 0) ||
      reinterpret_cast<uintptr_t>(source) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(wind) % 8 != 0) {
    PyErr_SetString(PyExc_ValueError,
                    "source, wind and 2-D pos must be 8-byte aligned (read "
                    "as float2)");
    return nullptr;
  }
  if (n == 0) Py_RETURN_NONE;
  kSampleLaunch[mode](
      f, static_cast<const float*>(pos), static_cast<const float2*>(source),
      static_cast<const int32_t*>(seed), static_cast<const float2*>(wind),
      static_cast<float*>(conc), static_cast<float*>(tke), n,
      static_cast<cudaStream_t>(stream));
  return launched("plume_sample");
}

// env_step(params, t, logits, value, exec_action, stream): step t of the
// chunk that the EnvStepParams at address ``params`` describes, after the
// policy's forward gave ``logits`` f32[N, A] and ``value`` f32[N];
// ``exec_action`` i64[N] (or None) is the action each env executes in place
// of the sampled one, in a chunk whose params record the override rows.
// The arguments of env_step and bank_step, read in order.
bool parse_step(PyObject* const* a, Py_ssize_t nargs, const char* name,
                void** params, int* step, void** logits, void** value,
                void** exec_action, void** stream) {
  if (nargs != 6) {
    PyErr_Format(PyExc_TypeError,
                 "%s takes (params, t, logits, value, exec_action, stream)",
                 name);
    return false;
  }
  if (!parse(a[0], params) || !parse(a[1], step) || !parse(a[2], logits) ||
      !parse(a[3], value) || !parse(a[4], exec_action) ||
      !parse(a[5], stream)) {
    return false;
  }
  if (*params == nullptr || *logits == nullptr || *value == nullptr) {
    PyErr_Format(PyExc_ValueError, "%s needs its params, logits and value",
                 name);
    return false;
  }
  return true;
}

// The checks env_step and bank_step share: an executed action only with
// the chunk's override rows, a step of the chunk, 1 to kMaxActions
// actions, elastic walls in 2-D flight alone.
bool check_step(const EnvStepParams& p, const char* name, int step,
                const void* exec_action) {
  if (exec_action != nullptr && p.override == nullptr) {
    PyErr_Format(PyExc_ValueError,
                 "%s: an executed action needs the chunk's override rows",
                 name);
    return false;
  }
  if (step >= p.length) {
    PyErr_Format(PyExc_IndexError, "%s: step %d of a chunk of %d steps", name,
                 step, p.length);
    return false;
  }
  if (p.num_actions < 1 || p.num_actions > kMaxActions) {
    PyErr_Format(PyExc_ValueError, "%s takes 1 to %d actions, got %d", name,
                 kMaxActions, p.num_actions);
    return false;
  }
  if (p.field.pos_dim == 3 && p.elastic) {
    PyErr_Format(PyExc_ValueError, "%s: elastic walls are 2-D only", name);
    return false;
  }
  return true;
}

PyObject* py_env_step(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  void *params, *logits, *value, *exec_action, *stream;
  int step;
  if (!parse_step(a, nargs, "env_step", &params, &step, &logits, &value,
                  &exec_action, &stream)) {
    return nullptr;
  }
  const EnvStepParams& p = *static_cast<const EnvStepParams*>(params);
  if (!check_step(p, "env_step", step, exec_action)) return nullptr;
  const int mode = sample_mode(p.field);
  if (mode < 0) return nullptr;
  if ((p.wind == nullptr) != (p.u_wind == nullptr)) {
    PyErr_SetString(PyExc_ValueError,
                    "env_step needs both the wind and its reset uniforms, "
                    "or neither");
    return nullptr;
  }
  const EnvLaunch launch = kEnvLaunch[2 * mode + (p.wind != nullptr)];
  if (launch == nullptr) {
    PyErr_SetString(PyExc_ValueError,
                    "env_step: only the anisotropic field has a wind");
    return nullptr;
  }
  if (p.n == 0) Py_RETURN_NONE;
  launch(p, step, static_cast<const float*>(logits),
         static_cast<const float*>(value),
         static_cast<const int64_t*>(exec_action),
         static_cast<cudaStream_t>(stream));
  return launched("env_step");
}

// bank_step(params, t, logits, value, exec_action, stream): env_step's
// call for the chunk over a bank that the BankStepParams at address
// ``params`` describes.
PyObject* py_bank_step(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  void *params, *logits, *value, *exec_action, *stream;
  int step;
  if (!parse_step(a, nargs, "bank_step", &params, &step, &logits, &value,
                  &exec_action, &stream)) {
    return nullptr;
  }
  const BankStepParams& b = *static_cast<const BankStepParams*>(params);
  const EnvStepParams& p = b.env;
  if (!check_step(p, "bank_step", step, exec_action)) return nullptr;
  if (sample_mode(p.field) < 0) return nullptr;
  if (b.bank.mode < bank_sample::kStatic ||
      b.bank.mode > bank_sample::kTwoFrames) {
    return PyErr_Format(PyExc_ValueError,
                        "bank_step: bank mode %d is no sample mode",
                        b.bank.mode);
  }
  if (b.bank.pos_dim != p.field.pos_dim) {
    PyErr_SetString(PyExc_ValueError,
                    "bank_step: the bank's pos_dim is not the env's");
    return nullptr;
  }
  if (p.wind != nullptr || p.u_wind != nullptr) {
    PyErr_SetString(PyExc_ValueError,
                    "bank_step: a bank's envs carry no wind of their own");
    return nullptr;
  }
  if (b.idx == nullptr || b.bank_source == nullptr || b.rows < 1 ||
      b.wind_frames < 0) {
    PyErr_SetString(PyExc_ValueError,
                    "bank_step needs the envs' rows, the bank's sources and "
                    "its row count");
    return nullptr;
  }
  if (p.n == 0) Py_RETURN_NONE;
  kBankLaunch[2 * (b.bank.mode - bank_sample::kStatic) +
              (p.field.pos_dim == 3)](
      b, step, static_cast<const float*>(logits),
      static_cast<const float*>(value),
      static_cast<const int64_t*>(exec_action),
      static_cast<cudaStream_t>(stream));
  return launched("bank_step");
}

using FastFn = PyObject* (*)(PyObject*, PyObject* const*, Py_ssize_t);

PyCFunction fastcall(FastFn f) {
  return reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(f));
}

PyMethodDef kMethods[] = {
    {"plume_sample", fastcall(py_plume_sample), METH_FASTCALL,
     "The analytic plume sample at N queries, one launch."},
    {"env_step", fastcall(py_env_step), METH_FASTCALL,
     "One analytic env step of every env, one launch."},
    {"bank_step", fastcall(py_bank_step), METH_FASTCALL,
     "One env step of every env over a bank, one launch."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "plume",
                       "The plume sample and env-step kernels of plume.cu.",
                       -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_plume(void) {
  PyObject* m = PyModule_Create(&kModule);
  if (m != nullptr &&
      (PyModule_AddIntConstant(m, "ENV_STEP_PARAMS_SIZE",
                               sizeof(EnvStepParams)) < 0 ||
       PyModule_AddIntConstant(m, "PLUME_FIELD_SIZE", sizeof(PlumeField)) <
           0 ||
       PyModule_AddIntConstant(m, "BANK_STEP_PARAMS_SIZE",
                               sizeof(BankStepParams)) < 0 ||
       PyModule_AddIntConstant(m, "MAX_SOURCES", kMaxSources) < 0 ||
       PyModule_AddIntConstant(m, "ENV_STEP_THREADS", kEnvThreads) < 0)) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
