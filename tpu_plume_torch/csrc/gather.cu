// Bilinear and trilinear field gathers at N float points.
//
// Replaces the Pallas kernels tpu_plume/ops/pallas_gather.py (_kernel,
// bilinear_pallas) and tpu_plume/ops/pallas_trilinear.py (_kernel,
// trilinear_pallas).  Each samples one [H, W] field or one [Z, H, W] volume
// at N points, clamped to the grid; here every query also names its row of a
// stack of such fields or volumes, which is how a bank's per-episode row and
// frame reach the kernel.  The TPU kernels' own call is the stack of one with
// every row 0.
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
// Bound: bytes.  Per query the function reads its point (8 B, or 12 B), its
// row (4 B) and 4 (or 8) corners of 4 B, and writes 4 B: 32 B bilinear, 52 B
// trilinear.  At the env step's N = 4096 that is 0.13 or 0.21 MB, well under
// 0.1 us at 3.35 TB/s, so a call costs one launch whatever its bytes.  The
// design does nothing about that yet: one thread per query, a grid-stride
// loop over N.  Shared-memory staging, sorting queries by row and fusing the
// two frames of a time-varying bank into one launch are later work.
//
// Offsets are 64-bit: a bank of 64 rows x 16 frames x 16 levels at 500 x 500
// holds 4.1e9 cells.  Build without --use_fast_math and with -fmad=false, so
// that no product and sum are contracted and the kernel agrees with its
// plain PyTorch version (tpu_plume_torch/ops/gather.py) to the bit.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -o libgather.so gather.cu
// (done by tpu_plume_torch/ops/build.py at first use).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

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

__device__ __forceinline__ float plane(const float* __restrict__ base,
                                       int w, float fx, float fy) {
  const float v00 = __ldg(base);
  const float v01 = __ldg(base + 1);
  const float v10 = __ldg(base + w);
  const float v11 = __ldg(base + w + 1);
  return v00 * (1.0f - fx) * (1.0f - fy) + v01 * (1.0f - fx) * fy +
         v10 * fx * (1.0f - fy) + v11 * fx * fy;
}

__global__ void bilinear_kernel(const float* __restrict__ stack,
                                const int32_t* __restrict__ rows,
                                const float2* __restrict__ pts,
                                float* __restrict__ out, int n, int h, int w) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float2 p = pts[i];
    int x0, y0;
    float fx, fy;
    axis(p.x, h, h - 2, &x0, &fx);
    axis(p.y, w, w - 2, &y0, &fy);
    const int64_t cell =
        (static_cast<int64_t>(rows[i]) * h + x0) * static_cast<int64_t>(w) +
        y0;
    out[i] = plane(stack + cell, w, fx, fy);
  }
}

__global__ void trilinear_zyx_kernel(const float* __restrict__ stack,
                                     const int32_t* __restrict__ rows,
                                     const float* __restrict__ pts,
                                     float* __restrict__ out, int n, int zd,
                                     int h, int w) {
  const int stride = gridDim.x * blockDim.x;
  const int64_t hw = static_cast<int64_t>(h) * w;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float* p = pts + 3 * static_cast<int64_t>(i);
    int z0, x0, y0;
    float fz, fx, fy;
    axis(p[0], zd, max(zd - 2, 0), &z0, &fz);
    axis(p[1], h, h - 2, &x0, &fx);
    axis(p[2], w, w - 2, &y0, &fy);
    const int z1 = min(z0 + 1, zd - 1);
    const int64_t vol = static_cast<int64_t>(rows[i]) * zd;
    const int64_t cell = static_cast<int64_t>(x0) * w + y0;
    const float p0 = plane(stack + (vol + z0) * hw + cell, w, fx, fy);
    const float p1 = plane(stack + (vol + z1) * hw + cell, w, fx, fy);
    out[i] = p0 * (1.0f - fz) + p1 * fz;
  }
}

constexpr int kThreads = 256;

int blocks_for(int n) { return min((n + kThreads - 1) / kThreads, 132 * 16); }

}  // namespace

// Plain C entry points for ctypes.  Each launches on ``stream`` and returns
// cudaGetLastError() (0 on success); neither synchronises.

extern "C" int bilinear_gather(const void* stack, const void* rows,
                               const void* pts, void* out, int n, int h, int w,
                               void* stream) {
  if (n <= 0) return 0;
  bilinear_kernel<<<blocks_for(n), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stack), static_cast<const int32_t*>(rows),
      static_cast<const float2*>(pts), static_cast<float*>(out), n, h, w);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trilinear_zyx_gather(const void* stack, const void* rows,
                                    const void* pts, void* out, int n, int zd,
                                    int h, int w, void* stream) {
  if (n <= 0) return 0;
  trilinear_zyx_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(stack), static_cast<const int32_t*>(rows),
      static_cast<const float*>(pts), static_cast<float*>(out), n, zd, h, w);
  return static_cast<int>(cudaGetLastError());
}
