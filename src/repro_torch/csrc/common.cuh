// Shared pieces of the hand-written kernels: the activation enum (the same
// codes as kernels/_build.py ACT_CODES), type conversions, the tile shape of
// the simple SIMT GEMM core, 16-byte cp.async, and the fused epilogue with
// the fixed-order split-K reductions of the matmul and conv schedules (the
// CW form's and the base variant's, which rounds between K slabs).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rt {

enum Act : int {
  kIdentity = 0,
  kGelu = 1,     // tanh approximation, as jax.nn.gelu(approximate=True)
  kSilu = 2,
  kRelu = 3,
  kRelu2 = 4,
  kSigmoid = 5,
  kTanh = 6,
};

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case kGelu: {
      const float u = 0.7978845608028654f * (v + 0.044715f * v * v * v);
      return 0.5f * v * (1.0f + tanhf(u));
    }
    case kSilu:
      return v / (1.0f + expf(-v));
    case kRelu:
      return fmaxf(v, 0.0f);
    case kRelu2: {
      const float r = fmaxf(v, 0.0f);
      return r * r;
    }
    case kSigmoid:
      return 1.0f / (1.0f + expf(-v));
    case kTanh:
      return tanhf(v);
    default:
      return v;
  }
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Round to T and widen back (the identity for fp32): a value of the base
// variant's running sum, which lives in the output dtype.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

// Block tile of the SIMT GEMM core: BM x BN outputs, BK deep per step,
// 256 threads as a 16 x 16 grid, each owning a 4 x 4 patch of outputs.
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int TM = 4;
constexpr int TN = 4;

// dtype codes of the C interface (kernels/_build.py DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

// One BK step of the register-tiled product: acc[i][j] += A[:, i] * B[:, j]
// over the staged tiles.  As is stored k-major (As[k][m]) so a thread reads
// its 4 rows with one 16-byte load; Bs likewise for its 4 columns.
template <int NACC>
__device__ __forceinline__ void mma_step(float (&As)[BK][BM + 4],
                                         float (&Bs)[NACC][BK][BN],
                                         float (&acc)[NACC][TM][TN], int ty,
                                         int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * TM]);
    const float av[TM] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int q = 0; q < NACC; ++q) {
      const float4 b = *reinterpret_cast<const float4*>(&Bs[q][kk][tx * TN]);
      const float bv[TN] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[q][i][j] = fmaf(av[i], bv[j], acc[q][i][j]);
    }
  }
}

// Component i of a float4 (i a constant once the loop is unrolled).
__device__ __forceinline__ float float4_at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 16 bytes global -> shared; src_bytes 0 fills the 16 bytes with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The fused epilogue on one fp32 sum v of output column c (v2: the GLU
// pair's second sum), in the JAX kernels' order: GLU act_glu(v) * v2, the
// inference batch-norm fold (v - mean) * (rsqrt(var + 1e-5) * scale), the
// bias, then act.  matmul_fused passes a bias and no batch norm; conv2d_fused
// the batch norm (its bias is the fold's shift) or nothing.
struct Epilogue {
  const float* bias;   // (N,) or null
  const float* scale;  // the four batch-norm vectors (N,), or all null
  const float* mean;
  const float* var;
  int act;
  int glu_act;

  __device__ __forceinline__ float fold(int c) const {
    return (1.0f / sqrtf(var[c] + 1e-5f)) * scale[c];
  }
  // the epilogue given column c's fold factor f, mean mu and bias b
  template <bool GLU>
  __device__ __forceinline__ float finish(float v, float v2, float f,
                                          float mu, float b) const {
    if (GLU) v = apply_act(v, glu_act) * v2;
    if (scale != nullptr) v = (v - mu) * f;
    if (bias != nullptr) v += b;
    return apply_act(v, act);
  }
  template <bool GLU>
  __device__ __forceinline__ float apply(float v, float v2, int c) const {
    return finish<GLU>(v, v2, scale != nullptr ? fold(c) : 0.0f,
                       scale != nullptr ? mean[c] : 0.0f,
                       bias != nullptr ? bias[c] : 0.0f);
  }
};

// A tile's per-column epilogue vectors in shared memory, staged once a
// block: the fold factor (its division and root once a column, not once an
// element), the mean and the bias of columns n0 .. n0 + BN - 1.  The same
// arithmetic as Epilogue::apply, so a split and an unsplit run agree.
template <int BN>
struct EpilogueCols {
  float f[BN], mean[BN], bias[BN];

  __device__ __forceinline__ void stage(const Epilogue& e, int n0, int N) {
    for (int c = threadIdx.x; c < BN; c += blockDim.x) {
      const int col = min(n0 + c, N - 1);
      f[c] = e.scale != nullptr ? e.fold(col) : 0.0f;
      mean[c] = e.scale != nullptr ? e.mean[col] : 0.0f;
      bias[c] = e.bias != nullptr ? e.bias[col] : 0.0f;
    }
  }
  // the epilogue of tile column cl (0 .. BN - 1)
  template <bool GLU>
  __device__ __forceinline__ float apply(const Epilogue& e, float v, float v2,
                                         int cl) const {
    return e.finish<GLU>(v, v2, f[cl], mean[cl], bias[cl]);
  }
};

// Sum the split-K partials ws[q][s][M][N] over s = 0 .. nsplit-1 in that
// order (no float atomics: the result repeats bit for bit), then the
// epilogue; one output element a thread.  q = 1 holds the GLU pair's second
// product.
template <typename TOut, bool GLU>
__global__ void __launch_bounds__(256)
splitk_reduce(const float* __restrict__ ws, Epilogue epi,
              TOut* __restrict__ out, int M, int N, int nsplit) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float v = 0.0f, v2 = 0.0f;
  for (int s = 0; s < nsplit; ++s) v += ws[s * MN + i];
  if (GLU) {
    const float* ws2 = ws + nsplit * MN;
    for (int s = 0; s < nsplit; ++s) v2 += ws2[s * MN + i];
  }
  out[i] = from_f32<TOut>(epi.apply<GLU>(v, v2, (int)(i % N)));
}

template <typename TOut>
int launch_splitk_reduce(const float* ws, const Epilogue& epi, void* out,
                         int M, int N, int nsplit, bool glu,
                         cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((size_t)M * N + 255) / 256);
  TOut* o = static_cast<TOut*>(out);
  if (glu)
    splitk_reduce<TOut, true><<<blocks, 256, 0, stream>>>(ws, epi, o, M, N,
                                                          nsplit);
  else
    splitk_reduce<TOut, false><<<blocks, 256, 0, stream>>>(ws, epi, o, M, N,
                                                           nsplit);
  return (int)cudaGetLastError();
}

// The base variant's reduction (matmul_fused vmem_accum=False): the split-K
// partials ws[s][M][N] walked in K order, the per_slab splits of one slab
// summed in fp32, each slab's sum rounded to TOut and added into the TOut
// running sum, rounded again (sum = round(sum + round(slab))), then bias
// and act on the widened sum and one write.  A split never straddles two
// slabs (the wrapper's _base_split); the last slab may have fewer splits.
template <typename TOut>
__global__ void __launch_bounds__(256)
splitk_reduce_slabs(const float* __restrict__ ws, Epilogue epi,
                    TOut* __restrict__ out, int M, int N, int nsplit,
                    int per_slab) {
  const size_t MN = (size_t)M * N;
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float sum = 0.0f, part = 0.0f;
  for (int s = 0, left = per_slab; s < nsplit; ++s) {
    part += ws[s * MN + i];
    if (--left == 0 || s == nsplit - 1) {
      sum = round_to<TOut>(sum + round_to<TOut>(part));
      part = 0.0f;
      left = per_slab;
    }
  }
  out[i] = from_f32<TOut>(epi.apply<false>(sum, 0.0f, (int)(i % N)));
}

template <typename TOut>
int launch_splitk_reduce_slabs(const float* ws, const Epilogue& epi,
                               void* out, int M, int N, int nsplit,
                               int per_slab, cudaStream_t stream) {
  if (per_slab < 1) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(((size_t)M * N + 255) / 256);
  splitk_reduce_slabs<TOut><<<blocks, 256, 0, stream>>>(
      ws, epi, static_cast<TOut*>(out), M, N, nsplit, per_slab);
  return (int)cudaGetLastError();
}

// The reduction for an out_dtype code of the C interface (0 fp32, 1 bf16).
inline int splitk_reduce_to(int out_dtype, const float* ws,
                            const Epilogue& epi, void* out, int M, int N,
                            int nsplit, bool glu, cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch_splitk_reduce<float>(ws, epi, out, M, N, nsplit, glu,
                                       stream);
  if (out_dtype == kBF16)
    return launch_splitk_reduce<__nv_bfloat16>(ws, epi, out, M, N, nsplit,
                                               glu, stream);
  return (int)cudaErrorInvalidValue;
}

// The base variant's reduction for an out_dtype code (0 fp32, 1 bf16).
inline int splitk_reduce_slabs_to(int out_dtype, const float* ws,
                                  const Epilogue& epi, void* out, int M,
                                  int N, int nsplit, int per_slab,
                                  cudaStream_t stream) {
  if (out_dtype == kF32)
    return launch_splitk_reduce_slabs<float>(ws, epi, out, M, N, nsplit,
                                             per_slab, stream);
  if (out_dtype == kBF16)
    return launch_splitk_reduce_slabs<__nv_bfloat16>(ws, epi, out, M, N,
                                                     nsplit, per_slab,
                                                     stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace rt
