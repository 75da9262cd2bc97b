// Analytic plume sample, and the whole analytic env step built around it.
//
// Replaces the Pallas kernel tpu_plume/ops/pallas_plume.py (_kernel,
// sample_plume_pallas).  The sample at a query: cell = clip(floor(pos), 0,
// g-1); the isotropic Gaussian base peak*exp(-d^2 / 2 sigma^2) at the cell;
// turbulence TI * (|N| or N + 0.3 sin(0.05x) cos(0.07y) + 0.2 U) with N and U
// from the two-round avalanche cell hash (tpu_plume/core/prng.py) and
// Box-Muller; conc = clip(base + turb, 0, peak); tke = turb, or 2|turb|
// (V1.0).  Two kernels compute it:
//
// - plume_sample_kernel: the sample alone, one thread per query (the TPU
//   kernel's own call; the env's fresh episodes of reset_from_draws).  28
//   bytes a query; at N = 4096 that is 115 KB, about 0.03 us at 3.35 TB/s,
//   so a call costs one launch whatever its work.
// - env_step_kernel: one analytic env step of every env, one thread per env
//   and one launch per step of the rollout (the JAX package's building block
//   "for future in-kernel rollout fusion", pallas_plume.py:6-7).  It computes
//   what env_step_plain (tpu_plume_torch/rollout/rollout.py) computes for
//   the isotropic plume in 2-D flight: the action from the logits (Gumbel-max
//   with the step's row of the chunk's Gumbel noise, or argmax) and its
//   log-prob; the move with the turbulence displacement, clipped or bounced
//   (v1_0's elastic walls); the sample at the new cell; the visit count; the
//   v1_1, v1_0 or delta reward terms, the terminal bonus with its depth and
//   gate terms, and done; the episode totals, row t of the trajectory and of
//   the episode record; and, where done, the fresh episode from the step's
//   reset draws with its sample at the origin and a cleared visit grid.  It
//   writes the next obs into the obs row the policy reads next.  The env
//   state and the totals are updated in place.
//
// Bound: about 290 bytes per env step for ppo_v2_0 (logits, Gumbel row,
// draws and state read; trajectory, record, state and obs written; a
// visit-grid clear adds D*D*4 bytes per finished env), about 1.2 MB and
// 0.35 us at N = 4096, bytes-bound.  The plain version takes about a
// hundred launches per step, each a fraction of that; one launch carries it
// all.  The work is per-env scalar code (two cell hashes, a few
// transcendentals), so no shared memory or tensor cores: each thread reads
// its env's fields, which lie apart in memory, and the loads of one warp
// are coalesced across envs.  Blocks of 64 threads: at N = 4096 that is 64
// blocks on 64 of the 132 SMs, two warps on each, each warp on its own
// scheduler, so the latency of one thread's dependent chain (hash,
// exp/log/sin/cos) is what a step costs on the device; larger blocks would
// pile four warps on fewer SMs for no gain, and at 2^20 envs 64-thread
// blocks still fill every SM.
//
// Numerics: the hash and the turbulence are those of cell_hash.cuh (shared
// with the bank sample kernels of gather.cu): native uint32_t with the JAX
// package's constants, salts and order of operations, so the hash bits are
// equal, and the accurate libm floats; build without --use_fast_math and with
// -fmad=false so no multiply-add is contracted.  The env step repeats the
// plain version's operations in its order, with its constants folded as
// Python and PyTorch fold them (the wrapper passes each as the f32 PyTorch
// uses): products of Python scalars in double, then one f32 multiply; a
// division of a tensor by a Python scalar as a multiply by the f32
// reciprocal, as PyTorch computes it on the card; a Python scalar divided by
// a tensor as reciprocal(tensor) * scalar.  So the position, the cells, the
// distance and done are bit-equal to the plain version's on the card for the
// same state.
//
// At N = 4096 a call's cost is the host's, so the entry points are a Python
// extension module (METH_FASTCALL functions of plain ints and floats), as
// gather.cu's are.  The env step's pointers and scalars arrive once per
// chunk in an EnvStepParams the wrapper fills; a launch takes its address,
// the step and the policy's two outputs.
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

#include "cell_hash.cuh"

namespace {

using cell_hash::cell_of;
using cell_hash::turbulence;

// The field scalars of the isotropic plume.
struct PlumeField {
  int grid;
  float peak;
  float two_sigma2;
  float ti;
  int signed_normal;
  int tke_abs_times_two;
};

// conc and tke at the cell of (px, py) of the field with source (sx, sy)
// and 32-bit seed.
__device__ __forceinline__ void sample_at(const PlumeField& f, float px,
                                          float py, float sx, float sy,
                                          uint32_t seed, float* conc,
                                          float* tke) {
  const int ix = cell_of(px, f.grid);
  const int iy = cell_of(py, f.grid);
  const float dx = static_cast<float>(ix) - sx;
  const float dy = static_cast<float>(iy) - sy;
  const float base = f.peak * expf(-(dx * dx + dy * dy) / f.two_sigma2);
  const float turb = turbulence(seed, ix, iy, f.ti, f.signed_normal);
  *conc = fminf(fmaxf(base + turb, 0.0f), f.peak);
  *tke = f.tke_abs_times_two ? fabsf(turb) * 2.0f : turb;
}

__global__ void plume_sample_kernel(const float2* __restrict__ pos,
                                    const float2* __restrict__ source,
                                    const int32_t* __restrict__ seed,
                                    float* __restrict__ conc,
                                    float* __restrict__ tke, int n,
                                    const PlumeField field) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float2 p = pos[i];
    const float2 s = source[i];
    sample_at(field, p.x, p.y, s.x, s.y, static_cast<uint32_t>(seed[i]),
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
// floats, so the layout has no padding to disagree on).
struct EnvStepParams {
  // The chunk's draws, [T', N, ...] with T' >= T; row t is read at step t.
  const float* turb;         // [T', N, 2] displacement normals
  const float* gumbel;       // [T', N, A] Gumbel noise; null: argmax
  const float* u_src;        // [T', N, 2] reset source uniforms
  const int32_t* bits;       // [T', N] reset field seeds
  // The env state, [N, ...], updated in place.
  float* pos;                // [N, 2]
  int32_t* t;
  int32_t* visited;          // [N, D, D]
  float* source;             // [N, 2]
  int32_t* seed;
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
  float* traj_pos;           // [T, N, 2], also the record's final x and y
  float* traj_conc;
  uint8_t* success;
  int32_t* steps;
  float* rec[6];             // the totals after the step, as acc
  float* final_conc;
  float* source_x;
  float* source_y;
  float* rec_radius;
  float* distance;
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
};

// x ** p as torch.pow(tensor, scalar) computes it on the card, which takes
// these exponents apart.
__device__ __forceinline__ float torch_pow(float x, float p) {
  if (p == 2.0f) return x * x;
  if (p == 3.0f) return x * x * x;
  if (p == 0.5f) return sqrtf(x);
  return powf(x, p);
}

// The displacement of an action: stay, +y, -y, +x, -x.
__device__ __forceinline__ float2 action_delta(int a, float m) {
  switch (a) {
    case 1: return make_float2(0.0f, m);
    case 2: return make_float2(0.0f, -m);
    case 3: return make_float2(m, 0.0f);
    case 4: return make_float2(-m, 0.0f);
    default: return make_float2(0.0f, 0.0f);
  }
}

__global__ void __launch_bounds__(kEnvThreads)
    env_step_kernel(const EnvStepParams p, int step,
                    const float* __restrict__ logits,
                    const float* __restrict__ value_in) {
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
  for (int j = 0; j < na; ++j) sum += expf(l[j] - lmax);
  const float log_prob = (l[action] - lmax) - logf(sum);

  // The move: delta, the turbulence displacement from the TKE at the old
  // cell, then the clip (or v1_0's bounce back).
  const float2 pos0 = reinterpret_cast<const float2*>(p.pos)[i];
  const float conc0 = p.conc[i];
  const float tke0 = p.tke[i];
  const int t_new = p.t[i] + 1;
  const float2 d = action_delta(action, p.move_step);
  const float delta_norm = sqrtf(d.x * d.x + d.y * d.y);
  const float2 nz = reinterpret_cast<const float2*>(p.turb)[row];
  const float rx = (pos0.x + d.x) + ((p.turb_scale * nz.x) * tke0) *
                                        p.inv_tke_norm;
  const float ry = (pos0.y + d.y) + ((p.turb_scale * nz.y) * tke0) *
                                        p.inv_tke_norm;
  float px, py;
  if (p.elastic) {
    const float cx = fminf(fmaxf(rx, p.wall_lo), p.wall_hi);
    const float cy = fminf(fmaxf(ry, p.wall_lo), p.wall_hi);
    const bool out = cx < 0.0f || cx > p.g || cy < 0.0f || cy > p.g;
    px = out ? pos0.x : cx;
    py = out ? pos0.y : cy;
  } else {
    px = fminf(fmaxf(rx, 0.0f), p.clip_hi);
    py = fminf(fmaxf(ry, 0.0f), p.clip_hi);
  }

  // The sample at the new cell.
  const float2 src = reinterpret_cast<const float2*>(p.source)[i];
  float cur_conc, cur_tke;
  sample_at(p.field, px, py, src.x, src.y, static_cast<uint32_t>(p.seed[i]),
            &cur_conc, &cur_tke);
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

  // The move, concentration and TKE terms.
  float move = p.variant == kV10
                   ? p.v10_move
                   : p.neg_move_coef * (1.0f - delta_norm * p.inv_move_step);
  float conc_r;
  if (p.variant == kDelta) {
    conc_r = p.conc_coef * (cur_n - prev_n);
    if (p.inplume_bonus > 0.0f) {
      conc_r = conc_r +
               p.inplume_bonus * (cur_n >= p.inplume_floor ? 1.0f : 0.0f);
    }
    const float2 dp = action_delta(static_cast<int>(p.prev_action[i]),
                                   p.move_step);
    const float dot = dp.x * d.x + dp.y * d.y;
    const float norms = sqrtf(dp.x * dp.x + dp.y * dp.y) * delta_norm;
    const float cosv = norms > 0.0f ? dot / fmaxf(norms, 1e-6f) : 1.0f;
    move = move - p.turn_half * (1.0f - cosv);
  } else {
    conc_r = p.conc_coef * cur_n;
  }
  const float tke_r = p.neg_tke_factor * (cur_tke * p.inv_tke_norm);
  float total = (((conc_r + explore) + move) + tke_r) + boundary;

  // The terminal bonus within the curriculum radius, and done.
  const float dxs = px - src.x;
  const float dys = py - src.y;
  const float distance = sqrtf(dxs * dxs + dys * dys);
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
  p.value[row] = value;
  p.reward[row] = total;
  p.done[row] = done;
  reinterpret_cast<float2*>(p.traj_pos)[row] = make_float2(px, py);
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
  float ox, oy, oc, ok, ot, ol, odc;
  int oa;
  if (done) {
    const float sx = p.src_span * u.x + p.src_lo;
    const float sy = p.src_span * u.y + p.src_lo;
    float c0, k0;
    sample_at(p.field, 0.0f, 0.0f, sx, sy, static_cast<uint32_t>(nseed), &c0,
              &k0);
    reinterpret_cast<float2*>(p.pos)[i] = make_float2(0.0f, 0.0f);
    p.t[i] = 0;
    for (int c = 0; c < nd * nd; ++c) grid[c] = 0;
    reinterpret_cast<float2*>(p.source)[i] = make_float2(sx, sy);
    p.seed[i] = nseed;
    p.conc[i] = c0;
    p.tke[i] = k0;
    p.prev_conc[i] = c0;
    p.prev_action[i] = 0;
    ox = oy = ot = ol = 0.0f;
    oc = c0 * p.inv_peak;
    ok = k0 * p.inv_tke_norm;
    odc = (c0 - c0) * p.inv_peak;
    oa = 0;
  } else {
    reinterpret_cast<float2*>(p.pos)[i] = make_float2(px, py);
    p.t[i] = t_new;
    grid[ex * nd + ey] = visits_i;
    p.conc[i] = cur_conc;
    p.tke[i] = cur_tke;
    p.prev_conc[i] = conc0;
    p.prev_action[i] = action;
    ox = px * p.inv_g;
    oy = py * p.inv_g;
    oc = cur_n;
    ok = cur_tke * p.inv_tke_norm;
    ot = static_cast<float>(t_new) * p.inv_max_steps;
    ol = level;
    odc = (cur_conc - conc0) * p.inv_peak;
    oa = action;
  }
  obs[0] = ox;
  obs[1] = oy;
  obs[2] = oc;
  obs[3] = ok;
  obs[4] = ot;
  obs[5] = ol;
  if (p.obs_memory) {
    obs[6] = odc;
    for (int j = 0; j < na; ++j) obs[7 + j] = j == oa ? 1.0f : 0.0f;
  }
}

// --- Python entry points ----------------------------------------------------
//
// METH_FASTCALL functions: pointers and the stream arrive as Python ints (a
// null pointer as None), counts as ints, field scalars as floats.  Each reads
// its arguments in order, raises at the first bad one before anything is
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

bool parse(PyObject* o, float* out) {
  const double v = PyFloat_AsDouble(o);
  if (v == -1.0 && PyErr_Occurred()) return false;
  *out = static_cast<float>(v);
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

// plume_sample(pos, source, seed, conc, tke, n, grid, peak, two_sigma2, ti,
//              signed_normal, tke_abs_times_two, stream)
PyObject* py_plume_sample(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  if (nargs != 13) {
    PyErr_SetString(PyExc_TypeError,
                    "plume_sample takes (pos, source, seed, conc, tke, n, "
                    "grid, peak, two_sigma2, ti, signed_normal, "
                    "tke_abs_times_two, stream)");
    return nullptr;
  }
  void *pos, *source, *seed, *conc, *tke, *stream;
  int n;
  PlumeField f{};
  if (!parse(a[0], &pos) || !parse(a[1], &source) || !parse(a[2], &seed) ||
      !parse(a[3], &conc) || !parse(a[4], &tke) || !parse(a[5], &n) ||
      !parse(a[6], &f.grid) || !parse(a[7], &f.peak) ||
      !parse(a[8], &f.two_sigma2) || !parse(a[9], &f.ti) ||
      !parse(a[10], &f.signed_normal) || !parse(a[11], &f.tke_abs_times_two) ||
      !parse(a[12], &stream)) {
    return nullptr;
  }
  if (reinterpret_cast<uintptr_t>(pos) % 8 != 0 ||
      reinterpret_cast<uintptr_t>(source) % 8 != 0) {
    PyErr_SetString(PyExc_ValueError,
                    "pos and source must be 8-byte aligned (read as float2)");
    return nullptr;
  }
  if (n == 0) Py_RETURN_NONE;
  constexpr int kThreads = 256;
  const int blocks = min((n + kThreads - 1) / kThreads, 132 * 16);
  plume_sample_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(source),
      static_cast<const int32_t*>(seed), static_cast<float*>(conc),
      static_cast<float*>(tke), n, f);
  return launched("plume_sample");
}

// env_step(params, t, logits, value, stream): step t of the chunk that the
// EnvStepParams at address ``params`` describes, after the policy's forward
// gave ``logits`` f32[N, A] and ``value`` f32[N].
PyObject* py_env_step(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  if (nargs != 5) {
    PyErr_SetString(PyExc_TypeError,
                    "env_step takes (params, t, logits, value, stream)");
    return nullptr;
  }
  void *params, *logits, *value, *stream;
  int step;
  if (!parse(a[0], &params) || !parse(a[1], &step) || !parse(a[2], &logits) ||
      !parse(a[3], &value) || !parse(a[4], &stream)) {
    return nullptr;
  }
  if (params == nullptr || logits == nullptr || value == nullptr) {
    PyErr_SetString(PyExc_ValueError,
                    "env_step needs its EnvStepParams, logits and value");
    return nullptr;
  }
  const EnvStepParams& p = *static_cast<const EnvStepParams*>(params);
  if (step >= p.length) {
    return PyErr_Format(PyExc_IndexError,
                        "env_step: step %d of a chunk of %d steps", step,
                        p.length);
  }
  if (p.num_actions < 1 || p.num_actions > kMaxActions) {
    return PyErr_Format(PyExc_ValueError,
                        "env_step takes 1 to %d actions, got %d", kMaxActions,
                        p.num_actions);
  }
  if (p.n == 0) Py_RETURN_NONE;
  const int blocks = (p.n + kEnvThreads - 1) / kEnvThreads;
  env_step_kernel<<<blocks, kEnvThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      p, step, static_cast<const float*>(logits),
      static_cast<const float*>(value));
  return launched("env_step");
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
       PyModule_AddIntConstant(m, "ENV_STEP_THREADS", kEnvThreads) < 0)) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
