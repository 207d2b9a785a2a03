// The fp32 FFMA tile: the mainloop of the `ffma` schedules of matmul_fused
// (matmul_fused.cu, dense rows of x) and conv2d_fused (conv2d_fused.cu, the
// im2col gather of x).  Full fp32 FMAs on the CUDA cores: no TF32 and no
// 3xTF32, so the fp32 checks and the fp32 greedy-token identity hold.
//
// What bounds it: the operations.  At the LM prefill's 4096 rows and at
// ResNet-34's convs an fp32 product does hundreds of flops a byte, far above
// the ridge of fp32 outside the tensor cores (67 TFLOP/s over 3.35 TB/s,
// ~20), so the FMA pipes have to stay busy: enough FMAs a shared-memory load,
// and the loads of the next stages in flight during the FMAs.
//
// The design: a block of 256 threads owns a 128 x BN output tile (BN 128;
// 64 for the GLU pair's two accumulators or a 64-channel conv), each thread
// 8 rows x BN / 16 columns a weight, 64 fp32 accumulators in every form.  K
// walks 16-deep stages through a 4-slot ring of 16-byte cp.async.cg loads,
// three stages in flight while the fourth is multiplied (no register
// staging).  A's stage (128 rows x 16) lies row-major as it is loaded, rows
// padded to 20 floats: a thread reads its 8 rows as float4s along K (the two
// row groups of a warp fall in different banks); w's stage (16 x BN) lies as
// in memory and a thread reads its columns as float4s.  Every 4-deep step
// of the 128 x 128 form: 16 shared loads of 16 bytes for 256 FMAs.  The A
// loader is a policy: where row p of the thread's two rows reads 4 floats
// at K index k, or nothing (zeros: a row past M, a tap in the padding).
// With a K split (grid z) each block writes its fp32 partials to a
// workspace that rt::splitk_reduce sums in a fixed order; without, the
// epilogue runs in registers and writes the output once.  The base variant
// of matmul_fused (per_slab > 0) always writes partials, its splits cut at
// K slab boundaries, and rt::splitk_reduce_slabs sums them slab by slab,
// rounding to the output dtype between slabs.
#pragma once

#include "common.cuh"

namespace fp32tile {

constexpr int BM = 128;            // rows a block
constexpr int BK = 16;             // K a stage
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int ALD = BK + 4;        // padded A row (floats)
constexpr int A_FLOATS = BM * ALD;

template <int BN, int NACC>
struct Tile {
  static constexpr int TN = BN / 16;                  // columns a thread
  static constexpr int STAGE = A_FLOATS + NACC * BK * BN;
  static constexpr int SMEM_BYTES = STAGES * STAGE * 4;
};

// Row ii (0-7) and column j of a thread's patch within the tile: rows
// 4 ty .. 4 ty + 3 and 64 + the same, columns 4 tx .. 4 tx + 3 of each
// 64-column group (ty = tid / 16, tx = tid % 16).
__device__ __forceinline__ int tile_row(int ii) {
  return (ii >> 2) * 64 + (threadIdx.x >> 4) * 4 + (ii & 3);
}
__device__ __forceinline__ int tile_col(int j) {
  return (j >> 2) * 64 + (threadIdx.x & 15) * 4 + (j & 3);
}

// The products of K rows [kbeg, kend) into acc: w and w2 (K, N) row-major,
// N a multiple of 4 and every row 16-byte aligned; the loader gives A.
template <int BN, int NACC, class Loader>
__device__ __forceinline__ void mainloop(const Loader& ld,
                                         const float* __restrict__ w,
                                         const float* __restrict__ w2, int N,
                                         int kbeg, int kend, int n0,
                                         float* smem,
                                         float (&acc)[NACC][8][BN / 16]) {
  using T = Tile<BN, NACC>;
  const int tid = threadIdx.x;
  const int nst = (kend - kbeg + BK - 1) / BK;

  auto load = [&](int st, int slot) {
    const int k0 = kbeg + st * BK;
    float* As = smem + slot * T::STAGE;
    float* Bs = As + A_FLOATS;
    // A: chunk tid % 4 (K offset 4 (tid % 4)) of rows tid / 4 and + 64
    const int k = k0 + 4 * (tid & 3), r = tid >> 2;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const float* src = k < kend ? ld.src(p, k) : nullptr;
      rt::cp_async16(As + (r + 64 * p) * ALD + 4 * (tid & 3),
                     src != nullptr ? src : w, src != nullptr ? 16 : 0);
    }
    // w (and w2): BK rows of BN / 4 chunks
    constexpr int CH = BN / 4;
    static_assert(BK * CH % THREADS == 0, "whole chunks a thread");
#pragma unroll
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int rr = i / CH, c = 4 * (i % CH);
      const int kk = k0 + rr, n = n0 + c;
      const bool ok = kk < kend && n < N;
      const size_t off = ok ? (size_t)kk * N + n : 0;
#pragma unroll
      for (int q = 0; q < NACC; ++q)
        rt::cp_async16(Bs + (q * BK + rr) * BN + c, (q == 0 ? w : w2) + off,
                       ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s, s);
    rt::cp_async_commit();
  }
  const int tx4 = (tid & 15) * 4;
  for (int st = 0; st < nst; ++st) {
    rt::cp_async_wait<STAGES - 2>();   // stage st has landed
    __syncthreads();                   // ... for every thread; slot st-1 free
    const int nx = st + STAGES - 1;
    if (nx < nst) load(nx, nx % STAGES);
    rt::cp_async_commit();

    const float* As = smem + (st % STAGES) * T::STAGE;
    const float* Bs = As + A_FLOATS;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a[8];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
        a[ii] = *reinterpret_cast<const float4*>(As + tile_row(ii) * ALD + kq);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          float b[T::TN];
#pragma unroll
          for (int g = 0; g < BN / 64; ++g) {
            const float4 t = *reinterpret_cast<const float4*>(
                Bs + (q * BK + kq + kk) * BN + g * 64 + tx4);
            b[4 * g] = t.x;
            b[4 * g + 1] = t.y;
            b[4 * g + 2] = t.z;
            b[4 * g + 3] = t.w;
          }
#pragma unroll
          for (int ii = 0; ii < 8; ++ii) {
            const float av = rt::float4_at(a[ii], kk);
#pragma unroll
            for (int j = 0; j < T::TN; ++j)
              acc[q][ii][j] = fmaf(av, b[j], acc[q][ii][j]);
          }
        }
      }
    }
  }
  rt::cp_async_wait<0>();
}

__device__ __forceinline__ void store4(float* o, const float (&v)[4]) {
  *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, const float (&v)[4]) {
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(o);
  p[0] = __floats2bfloat162_rn(v[0], v[1]);
  p[1] = __floats2bfloat162_rn(v[2], v[3]);
}

// One output tile of the (M, N) product: the loader's rows times w (and
// w2), K split kc a block along grid z.  direct: the epilogue and one
// write in TOut.  Otherwise fp32 partials to ws[q][split][M][N].
template <int BN, int NACC, typename TOut, class Loader>
__global__ void __launch_bounds__(THREADS)
ffma_gemm(typename Loader::Args la, const float* __restrict__ w,
          const float* __restrict__ w2, rt::Epilogue epi,
          float* __restrict__ ws, TOut* __restrict__ out, int M, int N, int K,
          int kc, bool direct) {
  constexpr bool GLU = NACC == 2;
  constexpr int TN = BN / 16;
  extern __shared__ __align__(16) float smem[];
  __shared__ rt::EpilogueCols<BN> cols;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int kbeg = blockIdx.z * kc, kend = min(K, kbeg + kc);
  const Loader ld(la, m0, threadIdx.x);
  if (direct) cols.stage(epi, n0, N);
  float acc[NACC][8][TN];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int ii = 0; ii < 8; ++ii)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[q][ii][j] = 0.0f;
  mainloop<BN, NACC>(ld, w, w2, N, kbeg, kend, n0, smem, acc);
  __syncthreads();                     // the staged columns

  const size_t MN = (size_t)M * N;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int m = m0 + tile_row(ii);
    if (m >= M) continue;
#pragma unroll
    for (int g = 0; g < BN / 64; ++g) {
      const int c = n0 + tile_col(4 * g);
      if (c >= N) continue;            // N % 4 == 0: c + 3 < N as well
      if (direct) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = cols.template apply<GLU>(epi, acc[0][ii][4 * g + e],
                                          acc[NACC - 1][ii][4 * g + e],
                                          c - n0 + e);
        store4(out + (size_t)m * N + c, v);
      } else {
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          const float v[4] = {acc[q][ii][4 * g], acc[q][ii][4 * g + 1],
                              acc[q][ii][4 * g + 2], acc[q][ii][4 * g + 3]};
          store4(ws + (q * gridDim.z + blockIdx.z) * MN + (size_t)m * N + c,
                 v);
        }
      }
    }
  }
}

// Launch the tile kernel on grid (M / 128, N / BN, nsplit), then, with a K
// split, the fixed-order reduction with the epilogue; with per_slab > 0
// (the base variant: per_slab splits a K slab) the partials always go
// through the workspace and the slab-rounding reduction.  Returns the first
// CUDA error.
template <int BN, int NACC, typename TOut, class Loader>
int launch(const typename Loader::Args& la, const float* w, const float* w2,
           const rt::Epilogue& epi, float* ws, void* out, int M, int N, int K,
           int kc, int nsplit, cudaStream_t stream, int per_slab = 0) {
  auto kern = ffma_gemm<BN, NACC, TOut, Loader>;
  constexpr int smem = Tile<BN, NACC>::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const bool direct = nsplit == 1 && per_slab == 0;
  if (nsplit < 1 || (!direct && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
            (unsigned)nsplit);
  kern<<<grid, THREADS, smem, stream>>>(la, w, w2, epi, ws,
                                        static_cast<TOut*>(out), M, N, K, kc,
                                        direct);
  e = cudaGetLastError();
  if (e != cudaSuccess || direct) return (int)e;
  if (per_slab > 0)
    return rt::launch_splitk_reduce_slabs<TOut>(ws, epi, out, M, N, nsplit,
                                                per_slab, stream);
  return rt::launch_splitk_reduce<TOut>(ws, epi, out, M, N, nsplit, NACC == 2,
                                        stream);
}

}  // namespace fp32tile
