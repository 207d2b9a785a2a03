// matmul_fused: y = epilogue(x @ w [, x @ w2]) over the flattened
// (M, K) x (K, N) product.  Replaces the Pallas kernel matmul_fused of
// src/repro/kernels/matmul_fused.py; see src/repro_torch/kernels/matmul_fused.py
// for the design note and the plain PyTorch version it is held against.
//
// Three entries.  matmul_fused is the `simt` schedule: fp32 accumulation in
// registers (a second accumulator when w2 is given, the GLU form); the
// epilogue runs in the JAX kernel's order — GLU act_glu(acc) * acc2, then
// bias, then act — and the output is written once, in the output dtype.
// It takes the shapes no other schedule takes: K or N not a multiple of 4
// (8 in bf16), unaligned views.
//
// matmul_ffma is the `ffma` schedule: fp32 operands with K and N multiples
// of 4, 16-byte aligned, above the small-M cut (the fp32 prefills).  The
// mainloop is ffma_tile.cuh's (full fp32 FMAs, no TF32; 128 x bn tiles, bn
// the plan's tile, 128 by default and 64 in the base flow's minimal tile;
// 128 x 64 in the GLU form; a 4-slot cp.async ring) with dense rows of x as
// its A loader, the same epilogue in registers and one write; a grid under
// half a wave splits K (the wrapper's _wave_split) and sums the partials in
// a fixed order.
//
// matmul_base is the Pallas kernel's vmem_accum=False branch (the paper's
// base kernel, matmul_fused.py:70-80, pallas_call at :147) on the SIMT
// core: the sum goes through the output dtype one bk-deep K slab at a time
// — each slab's fp32 product is rounded to the output dtype and added to
// the running sum in that dtype (two round-to-nearest-even steps a slab) —
// and the epilogue (+ bias, act) works on the widened sum.  No GLU form.
// It is the base variant's `simt` route: K or N off the 4 / 8 grid,
// unaligned views, slabs off the cores' K stages.  The other routes run the
// CW cores (matmul_base_ffma below, matmul_base_small_m in
// matmul_small_m.cu, matmul_base_wgmma in matmul_wgmma.cu); nothing on the
// op layer calls any of them (the JAX op layer never passes vmem_accum).
#include "common.cuh"
#include "ffma_tile.cuh"

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

// The base variant: per bk-deep K slab an fp32 partial from the SIMT core,
// rounded to TOut and added into the TOut running sum (held widened in
// registers, every value representable in TOut).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
matmul_base_kernel(const TIn* __restrict__ x, const TIn* __restrict__ w,
                   const float* __restrict__ bias, TOut* __restrict__ out,
                   int M, int K, int N, int bk, int act) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[1][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int am = m0 + ar;
  const int bkr = tid >> 4, bc = (tid & 15) * 4;

  float sum[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) sum[i][j] = 0.0f;

  for (int s0 = 0; s0 < K; s0 += bk) {
    const int s1 = min(K, s0 + bk);
    float part[1][TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part[0][i][j] = 0.0f;
    for (int k0 = s0; k0 < s1; k0 += BK) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + ak + i;
        As[ak + i][ar] =
            (am < M && k < s1) ? to_f32(x[(size_t)am * K + k]) : 0.0f;
      }
      {
        const int k = k0 + bkr;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + bc + j;
          Bs[0][bkr][bc + j] =
              (k < s1 && c < N) ? to_f32(w[(size_t)k * N + c]) : 0.0f;
        }
      }
      __syncthreads();
      mma_step<1>(As, Bs, part, ty, tx);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j)
        sum[i][j] = round_to<TOut>(sum[i][j] + round_to<TOut>(part[0][i][j]));
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= N) continue;
      float v = sum[i][j];
      if (bias != nullptr) v += bias[c];
      out[(size_t)m * N + c] = from_f32<TOut>(apply_act(v, act));
    }
  }
}

template <typename TIn, typename TOut>
int launch_base(const void* x, const void* w, const float* bias, void* out,
                int M, int K, int N, int bk, int act, cudaStream_t stream) {
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  matmul_base_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(w), bias,
      static_cast<TOut*>(out), M, K, N, bk, act);
  return (int)cudaGetLastError();
}

// The A loader of the ffma schedule: dense rows of x (M, K), row-major.
struct DenseRows {
  struct Args {
    const float* x;
    int M, K;
  };
  const float* row[2];               // the thread's two rows, null past M

  __device__ DenseRows(const Args& a, int m0, int tid) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int m = m0 + (tid >> 2) + 64 * p;
      row[p] = m < a.M ? a.x + (size_t)m * a.K : nullptr;
    }
  }
  __device__ const float* src(int p, int k) const {
    return row[p] != nullptr ? row[p] + k : nullptr;
  }
};

template <typename TOut>
int launch_ffma(const float* x, const float* w, const float* w2,
                const rt::Epilogue& epi, float* ws, void* out, int M, int K,
                int N, int kc, int nsplit, int bn, cudaStream_t s) {
  const DenseRows::Args a{x, M, K};
  if (w2 != nullptr)
    return fp32tile::launch<64, 2, TOut, DenseRows>(a, w, w2, epi, ws, out,
                                                    M, N, K, kc, nsplit, s);
  if (bn == 64)
    return fp32tile::launch<64, 1, TOut, DenseRows>(a, w, nullptr, epi, ws,
                                                    out, M, N, K, kc, nsplit,
                                                    s);
  return fp32tile::launch<128, 1, TOut, DenseRows>(a, w, nullptr, epi, ws,
                                                   out, M, N, K, kc, nsplit,
                                                   s);
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  x (M, K), w and w2
// (K, N) fp32, row-major, 16-byte aligned, K and N multiples of 4 (the
// wrapper checks them).  out_dtype 0 fp32, 1 bf16.  K is split in nsplit
// slabs of kc rows (kc a multiple of 16); with nsplit > 1, ws is an fp32
// workspace of (w2 ? 2 : 1) * nsplit * M * N floats.  w2 and bias may be
// null.  bn: the output columns a block, 64 or 128 in the plain form (the
// plan's tile), 64 in the GLU form.  Returns the first CUDA error of the
// launches.
extern "C" int matmul_ffma(int out_dtype, const void* x, const void* w,
                           const void* w2, const float* bias, float* ws,
                           void* out, int M, int K, int N, int kc, int nsplit,
                           int act, int glu_act, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kc % fp32tile::BK != 0 ||
      (w2 != nullptr ? bn != 64 : (bn != 64 && bn != 128)))
    return (int)cudaErrorInvalidValue;
  const rt::Epilogue epi{bias, nullptr, nullptr, nullptr, act, glu_act};
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* w2p = static_cast<const float*>(w2);
  if (out_dtype == rt::kF32)
    return launch_ffma<float>(xp, wp, w2p, epi, ws, out, M, K, N, kc, nsplit,
                              bn, s);
  if (out_dtype == rt::kBF16)
    return launch_ffma<__nv_bfloat16>(xp, wp, w2p, epi, ws, out, M, K, N, kc,
                                      nsplit, bn, s);
  return (int)cudaErrorInvalidValue;
}

// The base variant on the ffma core (C interface as matmul_ffma, without w2
// and the GLU act): the K splits are cut at slab boundaries (the wrapper's
// _base_split), per_slab of them a slab.  per_slab > 0: the partials
// always go to ws and rt::splitk_reduce_slabs rounds between slabs (a bf16
// output); per_slab 0 with nsplit 1: the CW core as it is, for an fp32
// output, where rounding a slab's sum to fp32 changes nothing.
extern "C" int matmul_base_ffma(int out_dtype, const void* x, const void* w,
                                const float* bias, float* ws, void* out,
                                int M, int K, int N, int kc, int nsplit,
                                int per_slab, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kc % fp32tile::BK != 0 || per_slab < 0 ||
      (per_slab == 0 && nsplit != 1))
    return (int)cudaErrorInvalidValue;
  const rt::Epilogue epi{bias, nullptr, nullptr, nullptr, act, 0};
  const DenseRows::Args a{static_cast<const float*>(x), M, K};
  const float* wp = static_cast<const float*>(w);
  if (out_dtype == rt::kF32)
    return fp32tile::launch<128, 1, float, DenseRows>(
        a, wp, nullptr, epi, ws, out, M, N, K, kc, nsplit, s, per_slab);
  if (out_dtype == rt::kBF16)
    return fp32tile::launch<128, 1, __nv_bfloat16, DenseRows>(
        a, wp, nullptr, epi, ws, out, M, N, K, kc, nsplit, s, per_slab);
  return (int)cudaErrorInvalidValue;
}

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

// The base variant (C interface as above, without w2 and the GLU act): bk
// is the slab depth, the plan tile's K extent cut to rup(K, 128).
extern "C" int matmul_base(int in_dtype, int out_dtype, const void* x,
                           const void* w, const float* bias, void* out, int M,
                           int K, int N, int bk, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (bk < 1) return (int)cudaErrorInvalidValue;
  if (in_dtype == rt::kF32 && out_dtype == rt::kF32)
    return launch_base<float, float>(x, w, bias, out, M, K, N, bk, act, s);
  if (in_dtype == rt::kF32 && out_dtype == rt::kBF16)
    return launch_base<float, bf16>(x, w, bias, out, M, K, N, bk, act, s);
  if (in_dtype == rt::kBF16 && out_dtype == rt::kF32)
    return launch_base<bf16, float>(x, w, bias, out, M, K, N, bk, act, s);
  if (in_dtype == rt::kBF16 && out_dtype == rt::kBF16)
    return launch_base<bf16, bf16>(x, w, bias, out, M, K, N, bk, act, s);
  return (int)cudaErrorInvalidValue;
}

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// glu 1: the w / w2 pair; bn the output columns a block.  The simt
// kernel's are its static arrays, read off the compiled kernel.
extern "C" int matmul_ffma_smem(int glu, int bn) {
  if (glu) return bn == 64 ? fp32tile::Tile<64, 2>::SMEM_BYTES : -1;
  return bn == 64    ? fp32tile::Tile<64, 1>::SMEM_BYTES
         : bn == 128 ? fp32tile::Tile<128, 1>::SMEM_BYTES
                     : -1;
}

extern "C" int matmul_simt_smem(int glu) {
  cudaFuncAttributes a{};
  const cudaError_t e =
      glu ? cudaFuncGetAttributes(&a, matmul_fused_kernel<float, float, true>)
          : cudaFuncGetAttributes(&a,
                                  matmul_fused_kernel<float, float, false>);
  return e == cudaSuccess ? (int)a.sharedSizeBytes : -1;
}
