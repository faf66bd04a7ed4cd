// Shared helpers of the port's kernels: f32 math on f32 or bf16 storage.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

// dtype codes passed from Python (kernels/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// The leave-r-out update of one element (paper eq. (2)/(S7)):
//   w - lr * (n * (g + bv) - sign * dB * gc) / max(n - sign * dB, 1).
// fused_update.cu and dequant_update.cu both call these two functions, so
// the two kernels compile the update to the same arithmetic (contractions
// included) and dequant_update(q) equals fused_update(decode(q)) bitwise.
struct UpdateCoef {
  float lr, n, sdb, denom;
};

__device__ __forceinline__ UpdateCoef update_coef(float lr, float n, float dB,
                                                  float sign) {
  return UpdateCoef{lr, n, sign * dB, fmaxf(n - sign * dB, 1.0f)};
}

__device__ __forceinline__ float deltagrad_update(float w, float g, float bv,
                                                  float gc, UpdateCoef c) {
  const float num = c.n * (g + bv) - c.sdb * gc;
  return w - c.lr * num / c.denom;
}

// The online request's form: the estimate itself,
//   g_est = (n * (g + bv) - sign * dB * gc) / max(n - sign * dB, 1),
// which the request writes back into the history, and the step taken with
// it, w - lr * g_est.  Each operation is rounded on its own (no FMA
// contraction), as the plain version (torch eager) rounds them.
__device__ __forceinline__ float deltagrad_estimate(float g, float bv,
                                                    float gc, UpdateCoef c) {
  return __fdiv_rn(__fsub_rn(__fmul_rn(c.n, __fadd_rn(g, bv)),
                             __fmul_rn(c.sdb, gc)),
                   c.denom);
}

__device__ __forceinline__ float sgd_step(float w, float g, UpdateCoef c) {
  return __fsub_rn(w, __fmul_rn(c.lr, g));
}

// Blocks for a grid-stride elementwise pass: enough to fill the 132 SMs
// several times over, no more than the data needs.
inline int elementwise_blocks(int64_t p, int threads) {
  int64_t b = (p + threads - 1) / threads;
  const int64_t cap = 132 * 8;
  return (int)(b < 1 ? 1 : (b > cap ? cap : b));
}

}  // namespace repro
