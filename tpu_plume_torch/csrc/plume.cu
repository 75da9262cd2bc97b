// Analytic plume sample: concentration and TKE at each query's grid cell.
//
// Replaces the Pallas kernel tpu_plume/ops/pallas_plume.py (_kernel,
// sample_plume_pallas).  Per query: cell = clip(floor(pos), 0, g-1); the
// isotropic Gaussian base peak*exp(-d^2 / 2 sigma^2) at the cell; turbulence
// TI * (|N| or N + 0.3 sin(0.05x) cos(0.07y) + 0.2 U) with N and U from the
// two-round avalanche cell hash (tpu_plume/core/prng.py) and Box-Muller;
// conc = clip(base + turb, 0, peak); tke = turb, or 2|turb| (V1.0).
//
// Bound: 28 bytes per query (pos 8, source 8, seed 4 read; conc 4, tke 4
// written).  At the main path's N = 4096 that is 115 KB, about 0.03 us at
// 3.35 TB/s, so the kernel is bound by launch latency and not by bytes.  The
// design does nothing about it yet: one thread per query, a grid-stride loop
// over N, no padding.  Fusing this stage into a whole-env-step kernel, or
// capturing the env step in a CUDA graph, is later work.
//
// Numerics: the hash and the turbulence are those of cell_hash.cuh (shared
// with the bank sample kernels of gather.cu): native uint32_t with the JAX
// package's constants, salts and order of operations, so the hash bits are
// equal, and the accurate libm floats; build without --use_fast_math and with
// -fmad=false so no multiply-add is contracted.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared
//        -Xcompiler -fPIC -o libplume.so plume.cu
// (done by tpu_plume_torch/ops/build.py at first use).

#include <cstdint>
#include <cuda_runtime.h>

#include "cell_hash.cuh"

namespace {

using cell_hash::cell_of;
using cell_hash::turbulence;

__global__ void plume_sample_kernel(const float2* __restrict__ pos,
                                    const float2* __restrict__ source,
                                    const int32_t* __restrict__ seed,
                                    float* __restrict__ conc,
                                    float* __restrict__ tke, int n, int grid,
                                    float peak, float two_sigma2, float ti,
                                    int signed_normal, int tke_abs_times_two) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    const float2 p = pos[i];
    const int ix = cell_of(p.x, grid);
    const int iy = cell_of(p.y, grid);
    const float fx = static_cast<float>(ix);
    const float fy = static_cast<float>(iy);

    const float2 s = source[i];
    const float dx = fx - s.x;
    const float dy = fy - s.y;
    const float base = peak * expf(-(dx * dx + dy * dy) / two_sigma2);
    const float turb = turbulence(static_cast<uint32_t>(seed[i]), ix, iy, ti,
                                  signed_normal);

    conc[i] = fminf(fmaxf(base + turb, 0.0f), peak);
    tke[i] = tke_abs_times_two ? fabsf(turb) * 2.0f : turb;
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on ``stream`` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int plume_sample(const void* pos, const void* source,
                            const void* seed, void* conc, void* tke, int n,
                            int grid, float peak, float two_sigma2, float ti,
                            int signed_normal, int tke_abs_times_two,
                            void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 256;
  const int blocks = min((n + kThreads - 1) / kThreads, 132 * 16);
  plume_sample_kernel<<<blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(pos), static_cast<const float2*>(source),
      static_cast<const int32_t*>(seed), static_cast<float*>(conc),
      static_cast<float*>(tke), n, grid, peak, two_sigma2, ti, signed_normal,
      tke_abs_times_two);
  return static_cast<int>(cudaGetLastError());
}
