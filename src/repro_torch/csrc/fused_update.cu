// DeltaGrad leave-r-out parameter update (paper eq. (2)/(S7)) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fused_update/kernel.py
// (deltagrad_update, body _upd_kernel):
//
//   out = w - lr * (n * (g_cached + bv) - sign * dB * g_changed) / max(n - sign * dB, 1)
//
// f32 math at f32 or bf16 storage.  Bound on an H100 by bytes: it reads
// four p-length vectors and writes one, ~7 flops per element.  The design
// reads each operand once in a grid-stride pass (neighbouring threads on
// neighbouring elements, so every load is coalesced) and takes lr, n, dB
// and sign as kernel arguments instead of a scalar operand; the ragged
// edge is masked by the loop bound, so no padding to a tile.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_update_kernel(const T* __restrict__ w, const T* __restrict__ g,
                    const T* __restrict__ bv, const T* __restrict__ gc,
                    T* __restrict__ out, int64_t p, float lr, float n,
                    float dB, float sign) {
  const float denom = fmaxf(n - sign * dB, 1.0f);
  const float sdb = sign * dB;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < p;
       j += stride) {
    const float num = n * (repro::to_f32(g[j]) + repro::to_f32(bv[j])) -
                      sdb * repro::to_f32(gc[j]);
    out[j] = repro::from_f32<T>(repro::to_f32(w[j]) - lr * num / denom);
  }
}

template <typename T>
cudaError_t launch(const void* w, const void* g, const void* bv,
                   const void* gc, void* out, int64_t p, float lr, float n,
                   float dB, float sign, cudaStream_t stream) {
  fused_update_kernel<T><<<repro::elementwise_blocks(p, kThreads), kThreads,
                           0, stream>>>(
      (const T*)w, (const T*)g, (const T*)bv, (const T*)gc, (T*)out, p, lr, n,
      dB, sign);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_update(const void* w, const void* g, const void* bv,
                            const void* gc, void* out, int64_t p, float lr,
                            float n, float dB, float sign, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case repro::kF32:
      return launch<float>(w, g, bv, gc, out, p, lr, n, dB, sign, s);
    case repro::kBF16:
      return launch<__nv_bfloat16>(w, g, bv, gc, out, p, lr, n, dB, sign, s);
    default:
      return cudaErrorInvalidValue;
  }
}
