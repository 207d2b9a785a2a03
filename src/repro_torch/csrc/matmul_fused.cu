// matmul_fused: y = epilogue(x @ w [, x @ w2]) over the flattened
// (M, K) x (K, N) product.  Replaces the Pallas kernel matmul_fused of
// src/repro/kernels/matmul_fused.py; see src/repro_torch/kernels/matmul_fused.py
// for the design note and the plain PyTorch version it is held against.
//
// fp32 accumulation in registers (a second accumulator when w2 is given, the
// GLU form); the epilogue runs in the JAX kernel's order — GLU
// act_glu(acc) * acc2, then bias, then act — and the output is written once,
// in the output dtype.
#include "common.cuh"

namespace {

using namespace rt;

template <typename TIn, typename TOut, bool GLU>
__global__ void __launch_bounds__(THREADS)
matmul_fused_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                    const TIn* __restrict__ w2,
                    const float* __restrict__ bias, TOut* __restrict__ out,
                    int M, int K, int N, int act, int glu_act) {
  constexpr int NACC = GLU ? 2 : 1;
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[NACC][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // x tile: row ar, columns ak .. ak+3; w tile: row bkr, columns bc .. bc+3
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int am = m0 + ar;
  const int bkr = tid >> 4, bc = (tid & 15) * 4;

  float acc[NACC][TM][TN];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      As[ak + i][ar] =
          (am < M && k < K) ? to_f32(x[(size_t)am * K + k]) : 0.0f;
    }
    {
      const int k = k0 + bkr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + bc + j;
        const bool ok = k < K && c < N;
        Bs[0][bkr][bc + j] = ok ? to_f32(w[(size_t)k * N + c]) : 0.0f;
        if (GLU) Bs[NACC - 1][bkr][bc + j] = ok ? to_f32(w2[(size_t)k * N + c]) : 0.0f;
      }
    }
    __syncthreads();
    mma_step<NACC>(As, Bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= N) continue;
      float v = acc[0][i][j];
      if (GLU) v = apply_act(v, glu_act) * acc[NACC - 1][i][j];
      if (bias != nullptr) v += bias[c];
      out[(size_t)m * N + c] = from_f32<TOut>(apply_act(v, act));
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* w, const void* w2, const float* bias,
           void* out, int M, int K, int N, int act, int glu_act,
           cudaStream_t stream) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  const TIn* xp = static_cast<const TIn*>(x);
  const TIn* wp = static_cast<const TIn*>(w);
  TOut* op = static_cast<TOut*>(out);
  if (w2 != nullptr)
    matmul_fused_kernel<TIn, TOut, true><<<grid, THREADS, 0, stream>>>(
        xp, wp, static_cast<const TIn*>(w2), bias, op, M, K, N, act, glu_act);
  else
    matmul_fused_kernel<TIn, TOut, false><<<grid, THREADS, 0, stream>>>(
        xp, wp, nullptr, bias, op, M, K, N, act, glu_act);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  in_dtype is the
// dtype of x, w and w2; out_dtype that of out (0 fp32, 1 bf16).  w2 and
// bias may be null.  Returns cudaGetLastError() after the launch.
extern "C" int matmul_fused(int in_dtype, int out_dtype, const void* x,
                            const void* w, const void* w2, const float* bias,
                            void* out, int M, int K, int N, int act,
                            int glu_act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_dtype == rt::kF32 && out_dtype == rt::kF32)
    return launch<float, float>(x, w, w2, bias, out, M, K, N, act, glu_act, s);
  if (in_dtype == rt::kF32 && out_dtype == rt::kBF16)
    return launch<float, bf16>(x, w, w2, bias, out, M, K, N, act, glu_act, s);
  if (in_dtype == rt::kBF16 && out_dtype == rt::kF32)
    return launch<bf16, float>(x, w, w2, bias, out, M, K, N, act, glu_act, s);
  if (in_dtype == rt::kBF16 && out_dtype == rt::kBF16)
    return launch<bf16, bf16>(x, w, w2, bias, out, M, K, N, act, glu_act, s);
  return (int)cudaErrorInvalidValue;
}
