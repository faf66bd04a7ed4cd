// The two parameter-length passes of the compact L-BFGS product B v, for
// Hopper.  dW, dG are (m, p) row-major with 1 <= m <= 8, v is (p,), all of
// one storage type (f32 or bf16); the math is f32.
//
// multidot replaces the Pallas TPU kernel src/repro/kernels/lbfgs/kernel.py
// (multidot, body _multidot_kernel): sw = dW dW^T, sy = dW dG^T, wv = dW v,
// gv = dG v in ONE read of dW, dG and v.  Bound on an H100 by bytes
// ((2m+1) p elements read; 2m^2+2m fused multiply-adds per element is far
// below the f32 peak).  The TPU kernel carries its sums across a sequential
// grid; here the blocks run in parallel, so pass 1 gives each block a
// contiguous range of p and writes its per-block partial sums to a scratch
// buffer, and pass 2 adds them up, one warp per term.  Every reduction is
// a fixed shuffle tree or a fixed walk (over warps, over blocks).  No float
// atomics: the result is bitwise the same from run to run.  Only the upper
// triangle of the symmetric sw is accumulated.
//
// rank_update replaces src/repro/kernels/lbfgs/kernel.py (rank_update, body
// _rank_update_kernel): out = sigma v - a^T dW - b^T dG, one read of dW, dG
// and v and one write.  Bound by bytes.  The coefficients stay on the
// device (they come from the 2m x 2m solve, so reading them on the host
// would cost a sync per step): the kernel takes a pointer to the packed
// f32 vector [a (m), b (m), sigma] and holds it in shared memory.
//
// Both kernels are templated on m, so every per-element loop over the
// history rows unrolls and the accumulators live in registers.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int M>
struct Terms {
  static constexpr int kSw = M * (M + 1) / 2;  // upper triangle of sw
  static constexpr int kAll = kSw + M * M + 2 * M;
};

template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
multidot_partials(const T* __restrict__ dW, const T* __restrict__ dG,
                  const T* __restrict__ v, float* __restrict__ partials,
                  int64_t p, int64_t chunk) {
  constexpr int K = Terms<M>::kAll;
  float acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = 0.0f;

  const int64_t start = (int64_t)blockIdx.x * chunk;
  const int64_t end = start + chunk < p ? start + chunk : p;
  for (int64_t j = start + threadIdx.x; j < end; j += kThreads) {
    float w[M], g[M];
#pragma unroll
    for (int i = 0; i < M; ++i) {
      w[i] = repro::to_f32(dW[i * p + j]);
      g[i] = repro::to_f32(dG[i * p + j]);
    }
    const float x = repro::to_f32(v[j]);
    int k = 0;
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int l = i; l < M; ++l) acc[k++] += w[i] * w[l];
#pragma unroll
    for (int i = 0; i < M; ++i)
#pragma unroll
      for (int l = 0; l < M; ++l) acc[k++] += w[i] * g[l];
#pragma unroll
    for (int i = 0; i < M; ++i) acc[k++] += w[i] * x;
#pragma unroll
    for (int i = 0; i < M; ++i) acc[k++] += g[i] * x;
  }

  __shared__ float warp_sums[kWarps][K];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float s = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) warp_sums[warp][k] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < K; k += kThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += warp_sums[w][k];
    partials[(int64_t)blockIdx.x * K + k] = s;
  }
}

// out = [sw (M*M) | sy (M*M) | wv (M) | gv (M)], f32.  One warp per term:
// lane l adds the partials of blocks l, l+32, ... in order, then a fixed
// shuffle tree adds the lanes, so the order of every addition is fixed.
template <int M>
__global__ void multidot_finish(const float* __restrict__ partials,
                                float* __restrict__ out, int nblocks) {
  constexpr int K = Terms<M>::kAll;
  constexpr int kSw = Terms<M>::kSw;
  const int k = blockIdx.x;
  float s = 0.0f;
  for (int b = threadIdx.x; b < nblocks; b += 32) s += partials[(int64_t)b * K + k];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  if (threadIdx.x != 0) return;
  if (k < kSw) {
    int i = 0, r = k;
    while (r >= M - i) {
      r -= M - i;
      ++i;
    }
    const int l = i + r;
    out[i * M + l] = s;
    out[l * M + i] = s;
  } else {
    out[M * M + (k - kSw)] = s;
  }
}

template <int M, typename T>
__global__ void __launch_bounds__(kThreads)
rank_update_kernel(const T* __restrict__ dW, const T* __restrict__ dG,
                   const T* __restrict__ v, const float* __restrict__ coefs,
                   T* __restrict__ out, int64_t p) {
  __shared__ float c[2 * M + 1];
  if (threadIdx.x < 2 * M + 1) c[threadIdx.x] = coefs[threadIdx.x];
  __syncthreads();
  const float sigma = c[2 * M];
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < p;
       j += stride) {
    float sa = 0.0f, sb = 0.0f;
#pragma unroll
    for (int i = 0; i < M; ++i) sa += c[i] * repro::to_f32(dW[i * p + j]);
#pragma unroll
    for (int i = 0; i < M; ++i) sb += c[M + i] * repro::to_f32(dG[i * p + j]);
    out[j] = repro::from_f32<T>(sigma * repro::to_f32(v[j]) - sa - sb);
  }
}

template <int M, typename T>
cudaError_t multidot_m(const void* dW, const void* dG, const void* v,
                       float* partials, float* out, int64_t p, int nblocks,
                       cudaStream_t s) {
  const int64_t chunk = (p + nblocks - 1) / nblocks;
  multidot_partials<M, T><<<nblocks, kThreads, 0, s>>>(
      (const T*)dW, (const T*)dG, (const T*)v, partials, p, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  constexpr int kTerms = Terms<M>::kAll;
  multidot_finish<M><<<kTerms, 32, 0, s>>>(partials, out, nblocks);
  return cudaGetLastError();
}

template <int M, typename T>
cudaError_t rank_update_m(const void* dW, const void* dG, const void* v,
                          const float* coefs, void* out, int64_t p,
                          cudaStream_t s) {
  rank_update_kernel<M, T><<<repro::elementwise_blocks(p, kThreads), kThreads,
                             0, s>>>((const T*)dW, (const T*)dG, (const T*)v,
                                     coefs, (T*)out, p);
  return cudaGetLastError();
}

// m is a template argument of the kernels: pick the instance at run time.
#define REPRO_FOR_M(m, CALL)     \
  switch (m) {                   \
    case 1: return CALL(1);      \
    case 2: return CALL(2);      \
    case 3: return CALL(3);      \
    case 4: return CALL(4);      \
    case 5: return CALL(5);      \
    case 6: return CALL(6);      \
    case 7: return CALL(7);      \
    case 8: return CALL(8);      \
    default: return cudaErrorInvalidValue; \
  }

template <typename T>
cudaError_t multidot_t(const void* dW, const void* dG, const void* v,
                       float* partials, float* out, int m, int64_t p,
                       int nblocks, cudaStream_t s) {
#define CALL(M) multidot_m<M, T>(dW, dG, v, partials, out, p, nblocks, s)
  REPRO_FOR_M(m, CALL)
#undef CALL
}

template <typename T>
cudaError_t rank_update_t(const void* dW, const void* dG, const void* v,
                          const float* coefs, void* out, int m, int64_t p,
                          cudaStream_t s) {
#define CALL(M) rank_update_m<M, T>(dW, dG, v, coefs, out, p, s)
  REPRO_FOR_M(m, CALL)
#undef CALL
}

}  // namespace

extern "C" int multidot(const void* dW, const void* dG, const void* v,
                        void* partials, void* out, int m, int64_t p,
                        int nblocks, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nblocks < 1 || p < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case repro::kF32:
      return multidot_t<float>(dW, dG, v, (float*)partials, (float*)out, m, p,
                               nblocks, s);
    case repro::kBF16:
      return multidot_t<__nv_bfloat16>(dW, dG, v, (float*)partials,
                                       (float*)out, m, p, nblocks, s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" int rank_update(const void* dW, const void* dG, const void* v,
                           const void* coefs, void* out, int m, int64_t p,
                           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p < 1) return cudaErrorInvalidValue;
  switch (dtype) {
    case repro::kF32:
      return rank_update_t<float>(dW, dG, v, (const float*)coefs, out, m, p, s);
    case repro::kBF16:
      return rank_update_t<__nv_bfloat16>(dW, dG, v, (const float*)coefs, out,
                                          m, p, s);
    default:
      return cudaErrorInvalidValue;
  }
}
