// Shared pieces of the hand-written kernels: the activation enum (the same
// codes as kernels/_build.py ACT_CODES), type conversions, and the tile
// shape of the simple SIMT GEMM core both kernels use.
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

}  // namespace rt
