// The sub-cell bank sample of one query, shared by the bank sample and gather
// kernels of gather.cu and the bank step kernel of plume.cu.
//
// Per query: the bank row, the position (x, y[, z]), the env step t and the
// field seed.  Around the corner loads it computes the frame coordinate
// t / steps_per_frame and the level coordinate z * level_scale with the
// clamps of tpu_plume_torch/ops/gather.py (frame_weights, level_coord),
// reads one frame and level pair of the bank (a static bank: 4 corners; a
// time-varying [K, T, H, W] bank, frames as z: 8; a one-frame 3-D bank: 8;
// a 3-D [K, T, Z, H, W] bank: 16, frames t0 and t0+1, lerped by the frame
// weight), adds the cell-hashed turbulence of cell_hash.cuh at the query's
// grid cell, clips to [0, peak] and gives conc and tke.  The frame
// coordinate is a true division, as the plain version's and the JAX
// package's (not the multiply by a reciprocal PyTorch uses for a tensor on
// the card divided by a Python scalar); the level scale arrives as the f32
// the plain version multiplies by.  The gathers alone (a stack's row at a
// point in index units) are the same corner loads and lerps without the
// sample's prologue and epilogue.
//
// A query is two calls: fetch (everything up to the corner loads, which it
// issues) and finish (the products, lerps and epilogue, in the plain
// version's order), so that a caller can put several queries' loads in
// flight before the first product.  Build without --use_fast_math and with
// -fmad=false, so that no product and sum are contracted.

#pragma once

#include <cstdint>

#include "cell_hash.cuh"

// What a launch needs of a bank, validated and filled once by the wrapper
// (tpu_plume_torch/ops/gather.py _BankParams mirrors it field by field).
struct BankParams {
  const float* bank;      // contiguous f32
  int mode;               // bank_sample::Mode
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

namespace bank_sample {

enum Mode : int {
  kGather2d = 0,   // bilinear over a stack [R, H, W], points (x, y)
  kGather3d = 1,   // trilinear over a stack [R, Z, H, W], points (z, x, y)
  kStatic = 2,     // sample of a static bank [K, H, W]
  kFrames = 3,     // sample of a time-varying bank [K, T, H, W], frames as z
  kOneFrame = 4,   // sample of a one-frame 3-D bank [K, 1, Z, H, W]
  kTwoFrames = 5,  // sample of a 3-D bank [K, T, Z, H, W], T >= 2
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

  // Row ``row`` at (x, y): a gather's level coordinate ``z`` (kGather3d),
  // or a sample's height ``z`` in grid units (read where pos_dim > 2 and
  // the bank has levels), env step ``*t`` (null: step 0) and field seed
  // ``s``.  Everything up to the corner loads, which it issues.
  __device__ __forceinline__ void fetch(const BankParams& p, int64_t row,
                                        float x, float y, float z,
                                        const int32_t* t, uint32_t s) {
    float zc = 0.0f;
    if constexpr (kMode == kGather3d) {
      zc = z;
    } else if constexpr (kSample) {
      seed = s;
      ix = cell_hash::cell_of(x, p.grid);
      iy = cell_hash::cell_of(y, p.grid);
      if constexpr (kMode == kOneFrame || kMode == kTwoFrames) {
        if (p.pos_dim > 2 && p.nz > 1) zc = z * p.level_scale;
      }
      if constexpr (kMode == kFrames || kMode == kTwoFrames) {
        // A true division, as the plain version's.
        const float tf =
            t ? static_cast<float>(*t) / p.steps_per_frame : 0.0f;
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

  // The products, lerps and epilogue, in the plain version's order: the
  // gather's value into ``*conc``, or the sample's conc and tke.
  __device__ __forceinline__ void finish(const BankParams& p, float* conc,
                                         float* tke) const {
    float turb = 0.0f;
    if constexpr (kSample) {   // pure arithmetic: runs under the loads
      turb = cell_hash::turbulence(seed, ix, iy, p.ti, p.signed_normal);
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
      *conc = fminf(fmaxf(base + turb, 0.0f), p.peak);
      *tke = p.tke_abs_times_two ? fabsf(turb) * 2.0f : turb;
    } else {
      *conc = base;
    }
  }
};

}  // namespace bank_sample
