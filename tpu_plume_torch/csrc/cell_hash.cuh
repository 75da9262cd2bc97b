// Cell-hashed turbulence, shared by the plume kernel (plume.cu) and the bank
// sample kernels (gather.cu).
//
// turb(ix, iy) = TI * (N or |N|  +  0.3 sin(0.05 ix) cos(0.07 iy)  +  0.2 U)
//
// with N (Box-Muller) and U drawn from the two-round avalanche hash of
// (seed, ix, iy, salt) of tpu_plume/core/prng.py, whose constants, salts and
// order of operations these are: the hash is native uint32_t and its bits are
// equal to the JAX package's.  Floats use the accurate logf/sqrtf/sinf/cosf
// (the argument of sin(0.05 x) reaches 25 rad, where the fast intrinsics lose
// digits); build without --use_fast_math and with -fmad=false so no
// multiply-add is contracted.

#pragma once

#include <cstdint>

namespace cell_hash {

constexpr uint32_t kM1 = 0x7FEB352Du;
constexpr uint32_t kM2 = 0x846CA68Bu;
constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;
// Salts of tpu_plume/fields/analytic.py: the normal uses 0 and 1.
constexpr uint32_t kSaltNormal = 0u;
constexpr uint32_t kSaltUniform = 2u;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInv2Pow24 = 1.0f / 16777216.0f;

__device__ __forceinline__ uint32_t avalanche(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 15;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_cell(uint32_t seed, uint32_t ix,
                                              uint32_t iy, uint32_t salt) {
  uint32_t h = seed ^ (ix * kC1) ^ (iy * kC2);
  h ^= salt * kC3;
  h = avalanche(h);
  return avalanche(h + seed);
}

__device__ __forceinline__ float bits_to_uniform(uint32_t bits) {
  return static_cast<float>(bits >> 8) * kInv2Pow24;
}

// Grid cell of a float coordinate: clip(floor(p), 0, grid - 1).
__device__ __forceinline__ int cell_of(float p, int grid) {
  return min(max(static_cast<int>(floorf(p)), 0), grid - 1);
}

// The turbulence at cell (ix, iy) of the field with 32-bit ``seed``: the
// normal is signed, or its magnitude where ``signed_normal`` is 0.
__device__ __forceinline__ float turbulence(uint32_t seed, int ix, int iy,
                                            float ti, int signed_normal) {
  const float fx = static_cast<float>(ix);
  const float fy = static_cast<float>(iy);
  const uint32_t ux = static_cast<uint32_t>(ix);
  const uint32_t uy = static_cast<uint32_t>(iy);
  float u1 = bits_to_uniform(hash_cell(seed, ux, uy, kSaltNormal));
  const float u2 = bits_to_uniform(hash_cell(seed, ux, uy, kSaltNormal + 1u));
  u1 = fmaxf(u1, 1e-7f);
  const float r = sqrtf(-2.0f * logf(u1));
  float normal = r * cosf(kTwoPi * u2);
  if (!signed_normal) normal = fabsf(normal);
  const float u = bits_to_uniform(hash_cell(seed, ux, uy, kSaltUniform));
  const float wave = 0.3f * sinf(0.05f * fx) * cosf(0.07f * fy);
  return ti * (normal + wave + 0.2f * u);
}

}  // namespace cell_hash
