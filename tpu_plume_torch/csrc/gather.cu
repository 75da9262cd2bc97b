// Bilinear and trilinear field gathers, and the env's sub-cell bank sample
// that is built on them: one launch per sample.
//
// Replaces the Pallas kernels tpu_plume/ops/pallas_gather.py (_kernel,
// bilinear_pallas) and tpu_plume/ops/pallas_trilinear.py (_kernel,
// trilinear_pallas).  Each samples one [H, W] field or one [Z, H, W] volume
// at N points, clamped to the grid:
//
//   bilinear:      x = clip(x, 0, H-1), x0 = clip(floor(x), 0, H-2), fx = x - x0
//                  (y likewise with W); four corner loads;
//                  v00 (1-fx)(1-fy) + v01 (1-fx) fy + v10 fx (1-fy) + v11 fx fy
//   trilinear_zyx: the same in each of the planes z0 and z1, where
//                  z0 = clip(floor(z), 0, max(Z-2, 0)) and z1 = min(z0+1, Z-1),
//                  then plane(z0) (1-fz) + plane(z1) fz
//
// This is the function and the order of operations of bilinear_xla and
// trilinear_zyx_xla (tpu_plume/ops/gather.py:34-102).  The TPU kernels
// compute it as one-hot matmuls over a VMEM-resident field (and a z-slab
// grid that accumulates in place), because the TPU has no fast scattered
// load; on this card a corner is one load through the read-only cache, so
// none of that is carried over.
//
// Two forms of each kernel, chosen at compile time (the Mode parameter):
//
// - The gather alone, the TPU kernels' own call generalised to a stack:
//   every query names its row of a stack [R, H, W] or [R, Z, H, W] and its
//   point (x, y) or (z, x, y) in index units; the TPU kernels' call is the
//   stack of one.
// - The sub-cell bank sample of the env step (sample_conc_tke's gridded
//   sub-cell branch, tpu_plume/fields/analytic.py:245-266): per query its
//   bank row idx, position (x, y[, z]), env step t and field seed.  Around
//   the gather it computes the frame coordinate t / steps_per_frame and the
//   level coordinate z * level_scale with the clamps of
//   tpu_plume_torch/ops/gather.py (frame_weights, level_coord), reads one
//   frame and level pair of the bank (a static bank: 4 corners; a
//   time-varying [K, T, H, W] bank, frames as z: 8; a one-frame 3-D bank: 8;
//   a 3-D [K, T, Z, H, W] bank: 16, frames t0 and t0+1, lerped by the frame
//   weight), adds the cell-hashed turbulence of cell_hash.cuh at the query's
//   grid cell, clips to [0, peak] and writes conc and tke.  The frame
//   coordinate is a true division, as the plain version's and the JAX
//   package's (not the multiply by a reciprocal PyTorch uses for a tensor on
//   the card divided by a Python scalar); the level scale arrives as the f32
//   the plain version multiplies by.
//
// Bound: at the env step's N = 4096 a call moves 0.1-0.3 MB and does about
// 0.5 MFLOP, well under 0.1 us at 3.35 TB/s and 67 TFLOP/s, so it costs one
// launch whatever its work; the design's answer is one launch per sample,
// where the plain version takes about 140.  At N = 2^20 over an L2-resident
// field or volume the random corners are L2 latency- and sector-bound: each
// thread issues every corner load of its queries before the first product
// (4, 8 or 16 a query), and above kTwoQueries queries each thread takes two
// queries whose loads are all in flight together.  Shared memory, TMA and
// wgmma have nothing to act on here: the main path's 4096 queries each read a
// different bank row, so no tile of the bank is read twice by one block.
//
// Offsets are 64-bit: a bank of 64 rows x 16 frames x 16 levels at 500 x 500
// holds 4.1e9 cells.  Build without --use_fast_math and with -fmad=false, so
// that no product and sum are contracted and the gathers agree with their
// plain PyTorch versions (tpu_plume_torch/ops/gather.py) to the bit.
//
// At N = 4096 a call's cost is the host's, so the entry points are a Python
// extension module (METH_FASTCALL functions of plain ints), not C functions
// for ctypes, whose argument conversion costs more per call than the
// wrapper's checks (PERF.md).  Python.h is the only header beyond CUDA's.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -I<Python include> -o libgather.so gather.cu
// (done by tpu_plume_torch/ops/build.py at first use, and imported as the
// module ``gather``).

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "cell_hash.cuh"

// What a launch needs of a bank, validated and filled once by the wrapper
// (tpu_plume_torch/ops/gather.py _BankParams mirrors it field by field).
struct BankParams {
  const float* bank;      // contiguous f32
  int mode;               // Mode below
  int pos_dim;            // 2, or 3 in 3-D flight
  int nt, nz, h, w;       // frames, levels, rows, columns (1 where absent)
  int grid;               // env grid: turbulence cells are clip(floor(p), 0, grid-1)
  float steps_per_frame;
  float level_scale;      // (Z-1) / max(z_extent, 1e-9), rounded once to f32
  float peak;             // conc_peak
  float ti;               // turbulence intensity
  int signed_normal;
  int tke_abs_times_two;
};
static_assert(sizeof(BankParams) == 64, "BankParams layout");

namespace {

using cell_hash::cell_of;
using cell_hash::turbulence;

enum Mode : int {
  kGather2d = 0,   // bilinear over a stack [R, H, W], points (x, y)
  kGather3d = 1,   // trilinear over a stack [R, Z, H, W], points (z, x, y)
  kStatic = 2,     // sample of a static bank [K, H, W]
  kFrames = 3,     // sample of a time-varying bank [K, T, H, W], frames as z
  kOneFrame = 4,   // sample of a one-frame 3-D bank [K, 1, Z, H, W]
  kTwoFrames = 5,  // sample of a 3-D bank [K, T, Z, H, W], T >= 2
};

struct Queries {
  const int32_t* rows;   // bank row (sample) or stack row (gather)
  const float* pos;      // [N, pos_dim] (sample) or [N, 2 or 3] points
  const int32_t* t;      // env step, or null for step 0 (sample only)
  const int32_t* seed;   // field seed's uint32 bits (sample only)
  float* conc;           // the gather's output, or the sample's conc
  float* tke;            // sample only
  int n;
};

// Clamped lower corner and weight along one axis of ``size`` cells; ``hi``
// is the largest lower corner (size - 2, or 0 for a single-level volume).
__device__ __forceinline__ void axis(float coord, int size, int hi, int* c0,
                                     float* f) {
  const float c = fminf(fmaxf(coord, 0.0f), static_cast<float>(size - 1));
  int i = static_cast<int>(floorf(c));
  i = min(max(i, 0), hi);
  *c0 = i;
  *f = c - static_cast<float>(i);
}

__device__ __forceinline__ void corners(const float* __restrict__ c, int w,
                                        float* v) {
  v[0] = __ldg(c);
  v[1] = __ldg(c + 1);
  v[2] = __ldg(c + w);
  v[3] = __ldg(c + w + 1);
}

__device__ __forceinline__ float plane(const float* v, float fx, float fy) {
  return v[0] * (1.0f - fx) * (1.0f - fy) + v[1] * (1.0f - fx) * fy +
         v[2] * fx * (1.0f - fy) + v[3] * fx * fy;
}

template <int kMode>
struct Query {
  static constexpr bool kSample = kMode >= kStatic;
  // Planes of four corners: one (a field), two (a volume's levels z0, z1)
  // or four (levels z0, z1 of frames t0 and t0+1).
  static constexpr int kPlanes =
      (kMode == kGather2d || kMode == kStatic) ? 1
      : (kMode == kTwoFrames)                  ? 4
                                               : 2;
  float v[4 * kPlanes];
  float fx, fy, fz, ft;
  int ix, iy;
  uint32_t seed;

  // Everything up to the corner loads, which it issues.
  __device__ __forceinline__ void fetch(const BankParams& p, const Queries& q,
                                        int64_t i) {
    float x, y, zc = 0.0f;
    int64_t row = q.rows[i];
    if constexpr (kMode == kGather2d) {
      const float2 pt = reinterpret_cast<const float2*>(q.pos)[i];
      x = pt.x;
      y = pt.y;
    } else if constexpr (kMode == kGather3d) {
      const float* pt = q.pos + 3 * i;
      zc = pt[0];
      x = pt[1];
      y = pt[2];
    } else {
      const float* pt = q.pos + p.pos_dim * i;
      x = pt[0];
      y = pt[1];
      seed = static_cast<uint32_t>(q.seed[i]);
      ix = cell_of(x, p.grid);
      iy = cell_of(y, p.grid);
      if constexpr (kMode == kOneFrame || kMode == kTwoFrames) {
        if (p.pos_dim > 2 && p.nz > 1) zc = pt[2] * p.level_scale;
      }
      if constexpr (kMode == kFrames || kMode == kTwoFrames) {
        // A true division, as the plain version's.
        const float tf =
            q.t ? static_cast<float>(q.t[i]) / p.steps_per_frame : 0.0f;
        if constexpr (kMode == kFrames) {
          zc = tf;
        } else {
          const int t0 = min(max(static_cast<int>(floorf(tf)), 0), p.nt - 2);
          ft = fminf(fmaxf(tf - static_cast<float>(t0), 0.0f), 1.0f);
          row = row * p.nt + t0;
        }
      }
    }
    int x0, y0;
    axis(x, p.h, p.h - 2, &x0, &fx);
    axis(y, p.w, p.w - 2, &y0, &fy);
    const int64_t hw = static_cast<int64_t>(p.h) * p.w;
    const int64_t cell = static_cast<int64_t>(x0) * p.w + y0;
    if constexpr (kPlanes == 1) {
      corners(p.bank + row * hw + cell, p.w, v);
    } else {
      // A volume's levels: the bank's z, or its frames for a 4-D bank.
      const int zd = kMode == kFrames ? p.nt : p.nz;
      int z0;
      axis(zc, zd, max(zd - 2, 0), &z0, &fz);
      const int z1 = min(z0 + 1, zd - 1);
      const int64_t vol = row * zd;
      corners(p.bank + (vol + z0) * hw + cell, p.w, v);
      corners(p.bank + (vol + z1) * hw + cell, p.w, v + 4);
      if constexpr (kPlanes == 4) {   // the next frame's volume, row + 1
        corners(p.bank + (vol + zd + z0) * hw + cell, p.w, v + 8);
        corners(p.bank + (vol + zd + z1) * hw + cell, p.w, v + 12);
      }
    }
  }

  // The products, lerps and epilogue, in the plain version's order.
  __device__ __forceinline__ void finish(const BankParams& p,
                                         const Queries& q, int64_t i) const {
    float turb = 0.0f;
    if constexpr (kSample) {   // pure arithmetic: runs under the loads
      turb = turbulence(seed, ix, iy, p.ti, p.signed_normal);
    }
    float base = plane(v, fx, fy);
    if constexpr (kPlanes >= 2) {
      base = base * (1.0f - fz) + plane(v + 4, fx, fy) * fz;
    }
    if constexpr (kPlanes == 4) {
      const float hi =
          plane(v + 8, fx, fy) * (1.0f - fz) + plane(v + 12, fx, fy) * fz;
      base = (1.0f - ft) * base + ft * hi;
    }
    if constexpr (kSample) {
      q.conc[i] = fminf(fmaxf(base + turb, 0.0f), p.peak);
      q.tke[i] = p.tke_abs_times_two ? fabsf(turb) * 2.0f : turb;
    } else {
      q.conc[i] = base;
    }
  }
};

constexpr int kThreads = 256;
// From this many queries on, each thread takes two (a 2^20 call); below it
// one, which spreads N = 4096 over 16 blocks.
constexpr int kTwoQueries = 1 << 16;

// Each thread takes kQ queries kThreads apart, fetches all of them, then
// finishes them; a grid-stride loop covers the rest.
template <int kMode, int kQ>
__device__ __forceinline__ void run(const BankParams& p, const Queries& q) {
  const int64_t tile = static_cast<int64_t>(kThreads) * kQ;
  for (int64_t first = blockIdx.x * tile + threadIdx.x; first < q.n;
       first += static_cast<int64_t>(gridDim.x) * tile) {
    Query<kMode> s[kQ];
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (first + j * kThreads < q.n) s[j].fetch(p, q, first + j * kThreads);
    }
#pragma unroll
    for (int j = 0; j < kQ; ++j) {
      if (first + j * kThreads < q.n) s[j].finish(p, q, first + j * kThreads);
    }
  }
}

template <int kMode, int kQ>
__global__ void __launch_bounds__(kThreads)
    bilinear_kernel(const BankParams p, const Queries q) {
  run<kMode, kQ>(p, q);
}

template <int kMode, int kQ>
__global__ void __launch_bounds__(kThreads)
    trilinear_zyx_kernel(const BankParams p, const Queries q) {
  run<kMode, kQ>(p, q);
}

template <int kMode>
int launch(const BankParams& p, const Queries& q, void* stream) {
  if (q.n <= 0) return 0;
  const bool two = q.n >= kTwoQueries;
  const int per_block = kThreads * (two ? 2 : 1);
  const int blocks = min((q.n + per_block - 1) / per_block, 132 * 16);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (kMode == kGather2d || kMode == kStatic) {
    if (two) {
      bilinear_kernel<kMode, 2><<<blocks, kThreads, 0, s>>>(p, q);
    } else {
      bilinear_kernel<kMode, 1><<<blocks, kThreads, 0, s>>>(p, q);
    }
  } else if (two) {
    trilinear_zyx_kernel<kMode, 2><<<blocks, kThreads, 0, s>>>(p, q);
  } else {
    trilinear_zyx_kernel<kMode, 1><<<blocks, kThreads, 0, s>>>(p, q);
  }
  return static_cast<int>(cudaGetLastError());
}

BankParams stack_params(const void* stack, int mode, int zd, int h, int w) {
  BankParams p{};
  p.bank = static_cast<const float*>(stack);
  p.mode = mode;
  p.nt = 1;
  p.nz = zd;
  p.h = h;
  p.w = w;
  return p;
}

Queries gather_queries(const void* rows, const void* pts, void* out, int n) {
  Queries q{};
  q.rows = static_cast<const int32_t*>(rows);
  q.pos = static_cast<const float*>(pts);
  q.conc = static_cast<float*>(out);
  q.n = n;
  return q;
}

int sample(const BankParams& p, const Queries& q, void* stream) {
  switch (p.mode) {
    case kStatic:
      return launch<kStatic>(p, q, stream);
    case kFrames:
      return launch<kFrames>(p, q, stream);
    case kOneFrame:
      return launch<kOneFrame>(p, q, stream);
    case kTwoFrames:
      return launch<kTwoFrames>(p, q, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// --- Python entry points ----------------------------------------------------
//
// METH_FASTCALL functions: pointers and the stream arrive as Python ints (a
// null pointer as None), counts and dims as ints.  Each reads its arguments
// in order, raises at the first bad one before anything is launched, launches
// on the stream and raises RuntimeError if the launch is refused (the
// cudaGetLastError() right after it); none synchronises.

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

PyObject* launched(int err, const char* what) {
  if (err != 0) {
    return PyErr_Format(PyExc_RuntimeError, "%s launch failed: cudaError %d (%s)",
                        what, err,
                        cudaGetErrorString(static_cast<cudaError_t>(err)));
  }
  Py_RETURN_NONE;
}

// gather(stack, rows, pts, out, n, stack.shape, stream): the stack's shape is
// its torch.Size, [R, H, W] or [R, Z, H, W].
template <int kMode>
PyObject* py_gather(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  constexpr int kDims = kMode == kGather2d ? 3 : 4;
  const char* name = kMode == kGather2d ? "bilinear" : "trilinear_zyx";
  if (nargs != 7 || !PyTuple_Check(a[5]) || PyTuple_GET_SIZE(a[5]) != kDims) {
    return PyErr_Format(PyExc_TypeError,
                        "%s takes (stack, rows, pts, out, n, stack.shape of %d "
                        "dims, stream)", name, kDims);
  }
  void *stack, *rows, *pts, *out, *stream;
  int n, zd = 1, h, w;
  if (!parse(a[0], &stack) || !parse(a[1], &rows) || !parse(a[2], &pts) ||
      !parse(a[3], &out) || !parse(a[4], &n) ||
      (kDims == 4 && !parse(PyTuple_GET_ITEM(a[5], 1), &zd)) ||
      !parse(PyTuple_GET_ITEM(a[5], kDims - 2), &h) ||
      !parse(PyTuple_GET_ITEM(a[5], kDims - 1), &w) || !parse(a[6], &stream)) {
    return nullptr;
  }
  if (kMode == kGather2d && reinterpret_cast<uintptr_t>(pts) % 8 != 0) {
    PyErr_SetString(PyExc_ValueError,
                    "pts must be 8-byte aligned (read as float2)");
    return nullptr;
  }
  return launched(launch<kMode>(stack_params(stack, kMode, zd, h, w),
                                gather_queries(rows, pts, out, n), stream),
                  name);
}

// bank_sample(params, idx, pos, t, seed, conc, tke, n, stream): the sub-cell
// sample of the bank that the BankParams at address ``params`` describes; per
// query its row ``idx``, position ``pos`` [N, pos_dim], env step ``t`` (None:
// step 0) and seed; writes ``conc`` and ``tke``.
PyObject* py_bank_sample(PyObject*, PyObject* const* a, Py_ssize_t nargs) {
  if (nargs != 9) {
    PyErr_SetString(PyExc_TypeError,
                    "bank_sample takes (params, idx, pos, t, seed, conc, tke, "
                    "n, stream)");
    return nullptr;
  }
  void *params, *idx, *pos, *t, *seed, *conc, *tke, *stream;
  int n;
  if (!parse(a[0], &params) || !parse(a[1], &idx) || !parse(a[2], &pos) ||
      !parse(a[3], &t) || !parse(a[4], &seed) || !parse(a[5], &conc) ||
      !parse(a[6], &tke) || !parse(a[7], &n) || !parse(a[8], &stream)) {
    return nullptr;
  }
  if (params == nullptr) {
    PyErr_SetString(PyExc_ValueError, "bank_sample needs its BankParams");
    return nullptr;
  }
  Queries q{};
  q.rows = static_cast<const int32_t*>(idx);
  q.pos = static_cast<const float*>(pos);
  q.t = static_cast<const int32_t*>(t);
  q.seed = static_cast<const int32_t*>(seed);
  q.conc = static_cast<float*>(conc);
  q.tke = static_cast<float*>(tke);
  q.n = n;
  return launched(sample(*static_cast<const BankParams*>(params), q, stream),
                  "bank_sample");
}

using FastFn = PyObject* (*)(PyObject*, PyObject* const*, Py_ssize_t);

PyCFunction fastcall(FastFn f) {
  return reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(f));
}

PyMethodDef kMethods[] = {
    {"bilinear_gather", fastcall(py_gather<kGather2d>), METH_FASTCALL,
     "The bilinear gather over a stack of fields."},
    {"trilinear_zyx_gather", fastcall(py_gather<kGather3d>), METH_FASTCALL,
     "The trilinear gather over a stack of volumes."},
    {"bank_sample", fastcall(py_bank_sample), METH_FASTCALL,
     "The sub-cell sample of a bank, one launch."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "gather",
                       "The gather and bank sample kernels of gather.cu.", -1,
                       kMethods};

}  // namespace

PyMODINIT_FUNC PyInit_gather(void) {
  PyObject* m = PyModule_Create(&kModule);
  if (m != nullptr &&
      PyModule_AddIntConstant(m, "BANK_PARAMS_SIZE", sizeof(BankParams)) < 0) {
    Py_DECREF(m);
    return nullptr;
  }
  return m;
}
