// Shared helpers of the port's kernels: f32 math on f32 or bf16 storage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// Blocks for a grid-stride elementwise pass: enough to fill the 132 SMs
// several times over, no more than the data needs.
inline int elementwise_blocks(int64_t p, int threads) {
  int64_t b = (p + threads - 1) / threads;
  const int64_t cap = 132 * 8;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace repro
