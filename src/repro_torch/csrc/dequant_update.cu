// Fused dequantize + DeltaGrad update, and dequantize + subtract, for Hopper.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/dequant_update/
// kernel.py: dequant_deltagrad_update (bodies _dq_upd_kernel,
// _dq_upd_base_kernel) and dequant_sub (bodies _dq_sub_kernel,
// _dq_sub_base_kernel).  A streamed history keeps its windows ENCODED on
// the device (q int8 with a per-leaf scale, or q bf16, each optionally a
// residual against an f32 keyframe base); the replay's approx step reads
// one encoded row and decodes it in registers:
//
//   g_cached = q * scale[leaf] (+ base)                    (the decode)
//   dequant_update: out = w - lr * (n * (g_cached + bv) - sign * dB * gc)
//                             / max(n - sign * dB, 1)
//   dequant_sub:    out = w - (q * scale[leaf] (+ base))   (v = w - w_t)
//
// dequant_update with g_out given (the online request) also writes the
// estimate g_out = (n * (g_cached + bv) - sign * dB * gc) / max(n - sign * dB, 1)
// and steps with it, out = w - lr * g_out (common.cuh deltagrad_estimate,
// as fused_update.cu's g_out form).
//
// Each call covers the whole flat parameter vector (all leaves) in one
// launch: the TPU kernels run once per leaf because the scale is per
// (leaf, step), which here would multiply the replay's host launches.
// The kernel takes the step's scale row (n_leaves floats) and the leaves'
// end offsets, both device pointers chosen by the host, loads them into
// shared memory, and each thread walks its grid-stride elements with a
// leaf index that only moves forward.  So there is no sync and no padding.
//
// The decode is written with __fmul_rn / __fadd_rn: nvcc would otherwise
// contract q * s + b into one FMA, while the fetch path (torch eager, one
// op per step of the expression) rounds the product and the sum apart.
// The update after it is common.cuh's deltagrad_update, the same inline
// function fused_update.cu calls, so dequant_update(q) equals
// fused_update(decode(q)) bitwise and kernel-mode replays equal
// fetch-mode replays bitwise.
//
// Bound on an H100 by bytes: dequant_update reads w, bv, gc (f32), q (1 or
// 2 B) and the base (f32, delta codecs) and writes out (and g_out): 17 to
// 26 B per element for ~9 flops.  dequant_sub moves 9 to 14 B per element.  Loads
// are coalesced (neighbouring threads on neighbouring elements); vectorized
// loads are later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One step's per-leaf scales and leaf ends, copied into shared memory.
struct Leaves {
  const int64_t* end;  // end offset of each leaf; the last is p
  const float* scale;  // the step's scale of each leaf
  int n;
};

__device__ __forceinline__ Leaves load_leaves(const int64_t* end,
                                              const float* scale, int n) {
  extern __shared__ int64_t smem[];
  int64_t* s_end = smem;
  float* s_scale = reinterpret_cast<float*>(smem + n);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    s_end[i] = end[i];
    s_scale[i] = scale[i];
  }
  __syncthreads();
  return Leaves{s_end, s_scale, n};
}

// q * scale[leaf] (+ base[j]), each operation rounded on its own.  `leaf`
// is the thread's running leaf index: j only grows along a thread's loop.
template <typename Q, bool kScale, bool kBase>
__device__ __forceinline__ float decode(const Q* __restrict__ q,
                                        const float* __restrict__ base,
                                        const Leaves& lv, int& leaf,
                                        int64_t j) {
  float x = repro::to_f32(q[j]);
  if (kScale) {
    while (leaf < lv.n - 1 && j >= lv.end[leaf]) ++leaf;
    x = __fmul_rn(x, lv.scale[leaf]);
  }
  if (kBase) x = __fadd_rn(x, base[j]);
  return x;
}

// kG: the estimate form (g_out written), a template argument as in
// fused_update.cu, so the offline form's instances hold no trace of it.
template <typename Q, bool kScale, bool kBase, bool kG>
__global__ void __launch_bounds__(kThreads)
dequant_update_kernel(const float* __restrict__ w, const Q* __restrict__ q,
                      const float* __restrict__ bv,
                      const float* __restrict__ gc,
                      const float* __restrict__ base,
                      const float* __restrict__ scale,
                      const int64_t* __restrict__ ends, int n_leaves,
                      float* __restrict__ out, float* __restrict__ g_out,
                      int64_t p, float lr, float n, float dB, float sign) {
  Leaves lv{nullptr, nullptr, 0};
  if (kScale) lv = load_leaves(ends, scale, n_leaves);
  const repro::UpdateCoef c = repro::update_coef(lr, n, dB, sign);
  int leaf = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < p;
       j += stride) {
    const float g = decode<Q, kScale, kBase>(q, base, lv, leaf, j);
    if (kG) {
      const float est = repro::deltagrad_estimate(g, bv[j], gc[j], c);
      g_out[j] = est;
      out[j] = repro::sgd_step(w[j], est, c);
    } else {
      out[j] = repro::deltagrad_update(w[j], g, bv[j], gc[j], c);
    }
  }
}

template <typename Q, bool kScale, bool kBase>
__global__ void __launch_bounds__(kThreads)
dequant_sub_kernel(const float* __restrict__ w, const Q* __restrict__ q,
                   const float* __restrict__ base,
                   const float* __restrict__ scale,
                   const int64_t* __restrict__ ends, int n_leaves,
                   float* __restrict__ out, int64_t p) {
  Leaves lv{nullptr, nullptr, 0};
  if (kScale) lv = load_leaves(ends, scale, n_leaves);
  int leaf = 0;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; j < p;
       j += stride) {
    out[j] = __fsub_rn(w[j], decode<Q, kScale, kBase>(q, base, lv, leaf, j));
  }
}

struct Args {
  const void *w, *q, *bv, *gc, *base, *scale, *ends;
  int n_leaves;
  void *out, *g_out;
  int64_t p;
  float lr, n, dB, sign;
  cudaStream_t stream;
};

template <typename Q, bool kScale, bool kBase, bool kG>
void launch_update_form(const Args& a) {
  const size_t smem = kScale ? a.n_leaves * (sizeof(int64_t) + sizeof(float)) : 0;
  dequant_update_kernel<Q, kScale, kBase, kG>
      <<<repro::elementwise_blocks(a.p, kThreads), kThreads, smem, a.stream>>>(
          (const float*)a.w, (const Q*)a.q, (const float*)a.bv,
          (const float*)a.gc, (const float*)a.base, (const float*)a.scale,
          (const int64_t*)a.ends, a.n_leaves, (float*)a.out, (float*)a.g_out,
          a.p, a.lr, a.n, a.dB, a.sign);
}

template <typename Q, bool kScale, bool kBase>
cudaError_t launch_update(const Args& a) {
  if (a.g_out != nullptr) {
    launch_update_form<Q, kScale, kBase, true>(a);
  } else {
    launch_update_form<Q, kScale, kBase, false>(a);
  }
  return cudaGetLastError();
}

template <typename Q, bool kScale, bool kBase>
cudaError_t launch_sub(const Args& a) {
  const size_t smem = kScale ? a.n_leaves * (sizeof(int64_t) + sizeof(float)) : 0;
  dequant_sub_kernel<Q, kScale, kBase>
      <<<repro::elementwise_blocks(a.p, kThreads), kThreads, smem, a.stream>>>(
          (const float*)a.w, (const Q*)a.q, (const float*)a.base,
          (const float*)a.scale, (const int64_t*)a.ends, a.n_leaves,
          (float*)a.out, a.p);
  return cudaGetLastError();
}

// The eight instances of one kernel: q int8 or bf16, scale or not, base or
// not (dequant_update: each in both forms).
template <template <typename, bool, bool> class L, typename Q>
cudaError_t by_flags(const Args& a) {
  const bool s = a.scale != nullptr, b = a.base != nullptr;
  if (s && b) return L<Q, true, true>::run(a);
  if (s) return L<Q, true, false>::run(a);
  if (b) return L<Q, false, true>::run(a);
  return L<Q, false, false>::run(a);
}

template <typename Q, bool S, bool B>
struct Update {
  static cudaError_t run(const Args& a) { return launch_update<Q, S, B>(a); }
};
template <typename Q, bool S, bool B>
struct Sub {
  static cudaError_t run(const Args& a) { return launch_sub<Q, S, B>(a); }
};

template <template <typename, bool, bool> class L>
cudaError_t by_dtype(const Args& a, int q_dtype) {
  if (a.scale != nullptr && (a.ends == nullptr || a.n_leaves < 1))
    return cudaErrorInvalidValue;
  switch (q_dtype) {
    case repro::kI8:
      return by_flags<L, int8_t>(a);
    case repro::kBF16:
      return by_flags<L, __nv_bfloat16>(a);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// w, bv, gc, base, out, g_out: f32 (p,); q: (p,) int8 or bf16 (q_dtype);
// scale: (n_leaves,) f32 or null (no multiply); ends: (n_leaves,) int64 leaf
// end offsets, the last = p; base: null without a keyframe; g_out: null
// unless the estimate is wanted.
extern "C" int dequant_update(const void* w, const void* q, const void* bv,
                              const void* gc, const void* base,
                              const void* scale, const void* ends,
                              int n_leaves, void* out, void* g_out, int64_t p,
                              float lr, float n, float dB, float sign,
                              int q_dtype, void* stream) {
  const Args a{w, q, bv, gc, base, scale, ends, n_leaves, out, g_out, p,
               lr, n, dB, sign, (cudaStream_t)stream};
  return by_dtype<Update>(a, q_dtype);
}

extern "C" int dequant_sub(const void* w, const void* q, const void* base,
                           const void* scale, const void* ends, int n_leaves,
                           void* out, int64_t p, int q_dtype, void* stream) {
  const Args a{w, q, nullptr, nullptr, base, scale, ends, n_leaves, out,
               nullptr, p, 0.0f, 0.0f, 0.0f, 0.0f, (cudaStream_t)stream};
  return by_dtype<Sub>(a, q_dtype);
}
