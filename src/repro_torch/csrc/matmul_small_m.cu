// matmul_small_m: the small-M schedules of matmul_fused, `small_m` (bf16
// operands, below) and `ffma_small_m` (fp32 operands, at the end),
// y = epilogue(x @ w [, x @ w2]) for M at or below the wrapper's crossover:
// decode steps and serving ticks (8 rows), speculative verify (40), the CNN
// heads at batch 8.  Replaces the Pallas kernel matmul_fused of
// src/repro/kernels/matmul_fused.py (its CW branch) there.  The schedule
// choice, the plain version and the design note are in
// src/repro_torch/kernels/matmul_fused.py.
//
// What bounds it: the weight bytes.  At 8 rows a projection does 16 flops
// per weight element of 2 bytes: K * N * 2 bytes (8.4 MB, 2.5 us at 3.35
// TB/s for a 2048 x 2048 projection) against a few hundred ns of tensor-core
// work.  The card has to stream w at its full rate, which takes many
// loads in flight on every SM.
//
// The design: split K.  The grid is (N / 128 strips) x (K splits), sized by
// the wrapper to 4 blocks an SM or more; a block of 4 warps streams its
// (K split x 128 columns) slab of w (and w2) through a 4-deep ring of
// 32-row stages with 16-byte cp.async loads, x's rows of the same K range
// beside it (zero rows up to the next 16).  mma.sync m16n8k16 multiplies:
// x's rows are the A operand (loaded from shared memory as 32-bit pairs),
// w's stage the B operand (ldmatrix.trans from a padded, conflict-free
// layout); fp32 accumulators in registers, 32 columns a warp.  Each block
// writes its fp32 partial sums to a workspace [split][M][N]; a second
// kernel sums the splits in a fixed order (no float atomics: the result
// repeats bit for bit) and applies the epilogue: GLU act(acc) * acc2, then
// bias, then act, one write in the output dtype.
//
// ffma_small_m is the same split-K structure for fp32 operands (K and N
// multiples of 4, 16-byte aligned), full fp32 FMAs (mma.sync takes no fp32
// inputs, and TF32 would break the fp32 checks): bound by the weight bytes
// as well (K * N * 4: 16.8 MB, 5.0 us at 3.35 TB/s for 2048 x 2048).  A
// block of 8 warps streams a (K split x 128 columns) slab of w through a
// 3-deep ring of 32-row stages with 16-byte cp.async loads, x's rows of the
// same K range beside it; lane l owns columns 4 l .. 4 l + 3, and the warps
// divide the rows into 8-row groups and each stage's 32 K rows among
// themselves (8 rows: 8 K groups of 4; 64 rows: 8 row groups), so every w
// element is read from shared memory once a row group, as a float4, and x
// as broadcast float4s along K.  The K groups' sums meet in shared memory
// in a fixed order, then the block's partial goes to the workspace and
// rt::splitk_reduce sums the splits in a fixed order with the epilogue.
//
// matmul_base_small_m runs the base variant of matmul_fused
// (vmem_accum=False) on either partial kernel: the wrapper cuts the K split
// at the slab boundaries, and rt::splitk_reduce_slabs rounds each slab's
// sum to the output dtype before adding it into the running sum.
#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace rt;

constexpr int SBN = 128;           // columns a block (32 a warp)
constexpr int SBK = 32;            // K a stage
constexpr int SSTAGES = 4;
constexpr int STHREADS = 128;
constexpr int WLD = SBN + 8;       // padded shared row of a w stage
constexpr int XLD = SBK + 8;       // padded shared row of an x stage

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 bf16 matrices, transposed: B fragments of two n8 tiles.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The partial products of one (K split, 128-column strip): MT 16-row tiles
// of x (M <= 16 MT), NW weights (2 with the GLU pair).
template <int MT, int NW>
__global__ void __launch_bounds__(STHREADS)
small_m_partial(const bf16* __restrict__ x, const bf16* __restrict__ w,
                const bf16* __restrict__ w2, float* __restrict__ ws, int M,
                int K, int N, int kc) {
  constexpr int ROWS = 16 * MT;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);           // [S][NW][SBK][WLD]
  bf16* Xs = Ws + SSTAGES * NW * SBK * WLD;           // [S][ROWS][XLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n0 = blockIdx.x * SBN;
  const int kbeg = blockIdx.y * kc, kend = min(K, kbeg + kc);
  const int nst = (kend - kbeg + SBK - 1) / SBK;

  // K and N are multiples of 8: a 16-byte chunk is all in range or all out
  auto load_stage = [&](int st, int slot) {
    const int k0 = kbeg + st * SBK;
    for (int i = tid; i < SBK * (SBN / 8); i += STHREADS) {
      const int r = i / (SBN / 8), c = (i % (SBN / 8)) * 8;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < kend && n < N;
      const size_t off = ok ? (size_t)k * N + n : 0;
#pragma unroll
      for (int q = 0; q < NW; ++q)
        cp_async16(Ws + ((slot * NW + q) * SBK + r) * WLD + c,
                   (q == 0 ? w : w2) + off, ok ? 16 : 0);
    }
    for (int i = tid; i < ROWS * (SBK / 8); i += STHREADS) {
      const int r = i / (SBK / 8), c = (i % (SBK / 8)) * 8;
      const int k = k0 + c;
      const bool ok = r < M && k < kend;
      cp_async16(Xs + (slot * ROWS + r) * XLD + c,
                 x + (ok ? (size_t)r * K + k : 0), ok ? 16 : 0);
    }
  };

  float acc[NW][MT][4][4];
#pragma unroll
  for (int q = 0; q < NW; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[q][mt][j][e] = 0.0f;

#pragma unroll
  for (int s = 0; s < SSTAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  const int g = lane / 4, tig = lane % 4;
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<SSTAGES - 2>();    // stage st has landed
    __syncthreads();                 // ... for every thread; slot st-1 free
    const int nx = st + SSTAGES - 1;
    if (nx < nst) load_stage(nx, nx % SSTAGES);
    cp_async_commit();

    const int slot = st % SSTAGES;
    const bf16* xs = Xs + slot * ROWS * XLD;
#pragma unroll
    for (int kk = 0; kk < SBK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const bf16* p = xs + (mt * 16 + g) * XLD + kk + 2 * tig;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * XLD);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * XLD + 8);
      }
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const bf16* wsl = Ws + (slot * NW + q) * SBK * WLD;
#pragma unroll
        for (int jp = 0; jp < 4; jp += 2) {
          // matrix lane/8: k rows kk + 8 (its bit 0), n tile jp + its bit 1
          const int mi = lane / 8;
          const bf16* p = wsl + (kk + (mi & 1) * 8 + lane % 8) * WLD +
                          warp * 32 + (jp + (mi >> 1)) * 8;
          uint32_t b[4];
          ldmatrix_x4_trans(b, p);
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            mma_16816(acc[q][mt][jp], a[mt], b[0], b[1]);
            mma_16816(acc[q][mt][jp + 1], a[mt], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // partials: fragment e of n8 tile j in row tile mt holds row
  // 16 mt + lane/4 (+8 for e >= 2), column 8 j + 2 (lane % 4) + e % 2
  const size_t MN = (size_t)M * N;
  float* part = ws + (size_t)blockIdx.y * MN;
#pragma unroll
  for (int q = 0; q < NW; ++q)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + warp * 32 + j * 8 + 2 * tig;
        if (c >= N) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = mt * 16 + g + 8 * h;
          if (r >= M) continue;
          *reinterpret_cast<float2*>(part + q * gridDim.y * MN +
                                     (size_t)r * N + c) =
              make_float2(acc[q][mt][j][2 * h], acc[q][mt][j][2 * h + 1]);
        }
      }
}

template <int MT, int NW>
constexpr int partial_smem() {
  return SSTAGES * (NW * SBK * WLD + 16 * MT * XLD) * (int)sizeof(bf16);
}

template <int MT, int NW>
int launch_partial(const void* x, const void* w, const void* w2, float* ws,
                   int M, int K, int N, int kc, int nsplit,
                   cudaStream_t stream) {
  constexpr int smem = partial_smem<MT, NW>();
  auto kern = small_m_partial<MT, NW>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((unsigned)((N + SBN - 1) / SBN), (unsigned)nsplit);
  kern<<<grid, STHREADS, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const bf16*>(w2), ws, M, K, N, kc);
  return (int)cudaGetLastError();
}

template <int NW>
int partial_by_rows(const void* x, const void* w, const void* w2, float* ws,
                    int M, int K, int N, int kc, int nsplit, cudaStream_t s) {
  switch ((M + 15) / 16) {
    case 1: return launch_partial<1, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
    case 2: return launch_partial<2, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
    case 3: return launch_partial<3, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
    case 4: return launch_partial<4, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---- ffma_small_m: fp32 operands ----
constexpr int FBN = 128;           // columns a block (4 a lane)
constexpr int FBK = 32;            // K a stage (the wrapper's SMALL_M_BK)
constexpr int FSTAGES = 3;
constexpr int FTHREADS = 256;
constexpr int FXLD = FBK + 4;      // padded shared row of an x stage

template <int MT, int NW>
struct FSmall {
  static constexpr int ROWS = 8 * MT;          // M <= ROWS
  static constexpr int WK = 8 / MT;            // warps along K
  static constexpr int KG = FBK / WK;          // K rows a warp a stage
  static constexpr int W_FLOATS = NW * FBK * FBN;
  static constexpr int STAGE = W_FLOATS + ROWS * FXLD;
  static constexpr int RED = WK * NW * ROWS * FBN;   // the K groups' sums
  static constexpr int SMEM_BYTES =
      4 * (FSTAGES * STAGE > RED ? FSTAGES * STAGE : RED);
};

// The fp32 partial products of one (K split, 128-column strip): MT 8-row
// groups of x (M <= 8 MT), NW weights (2 with the GLU pair).
template <int MT, int NW>
__global__ void __launch_bounds__(FTHREADS)
ffma_small_m_partial(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ w2, float* __restrict__ ws,
                     int M, int K, int N, int kc) {
  using F = FSmall<MT, NW>;
  extern __shared__ __align__(16) float fsm[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = warp % MT, wk = warp / MT;    // row group, K group
  const int n0 = blockIdx.x * FBN;
  const int kbeg = blockIdx.y * kc, kend = min(K, kbeg + kc);
  const int nst = (kend - kbeg + FBK - 1) / FBK;

  // K and N are multiples of 4: a 16-byte chunk is all in range or all out
  auto load_stage = [&](int st, int slot) {
    const int k0 = kbeg + st * FBK;
    float* Ws = fsm + slot * F::STAGE;
    float* Xs = Ws + F::W_FLOATS;
#pragma unroll
    for (int it = 0; it < FBK * (FBN / 4) / FTHREADS; ++it) {
      const int i = tid + it * FTHREADS;
      const int r = i / (FBN / 4), c = (i % (FBN / 4)) * 4;
      const int k = k0 + r, n = n0 + c;
      const bool ok = k < kend && n < N;
      const size_t off = ok ? (size_t)k * N + n : 0;
#pragma unroll
      for (int q = 0; q < NW; ++q)
        cp_async16(Ws + (q * FBK + r) * FBN + c, (q == 0 ? w : w2) + off,
                   ok ? 16 : 0);
    }
    for (int i = tid; i < F::ROWS * (FBK / 4); i += FTHREADS) {
      const int r = i / (FBK / 4), c = (i % (FBK / 4)) * 4;
      const int k = k0 + c;
      const bool ok = r < M && k < kend;
      cp_async16(Xs + r * FXLD + c, x + (ok ? (size_t)r * K + k : 0),
                 ok ? 16 : 0);
    }
  };

  float acc[NW][8][4];
#pragma unroll
  for (int q = 0; q < NW; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[q][i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < FSTAGES - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<FSTAGES - 2>();    // stage st has landed
    __syncthreads();                 // ... for every thread; slot st-1 free
    const int nx = st + FSTAGES - 1;
    if (nx < nst) load_stage(nx, nx % FSTAGES);
    cp_async_commit();

    const float* Ws = fsm + (st % FSTAGES) * F::STAGE;
    const float* Xs = Ws + F::W_FLOATS + wr * 8 * FXLD;
#pragma unroll
    for (int kq = 0; kq < F::KG; kq += 4) {
      const int k = wk * F::KG + kq;
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(Xs + i * FXLD + k);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int q = 0; q < NW; ++q) {
          const float4 b = *reinterpret_cast<const float4*>(
              Ws + (q * FBK + k + kk) * FBN + 4 * lane);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float av = float4_at(a[i], kk);
            acc[q][i][0] = fmaf(av, b.x, acc[q][i][0]);
            acc[q][i][1] = fmaf(av, b.y, acc[q][i][1]);
            acc[q][i][2] = fmaf(av, b.z, acc[q][i][2]);
            acc[q][i][3] = fmaf(av, b.w, acc[q][i][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: reuse it

  // the K groups' sums, red[wk][q][row][col], added in order wk = 0, 1, ..
  float* red = fsm;
#pragma unroll
  for (int q = 0; q < NW; ++q)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      *reinterpret_cast<float4*>(
          red + ((wk * NW + q) * F::ROWS + wr * 8 + i) * FBN + 4 * lane) =
          make_float4(acc[q][i][0], acc[q][i][1], acc[q][i][2], acc[q][i][3]);
  __syncthreads();
  const size_t MN = (size_t)M * N;
  for (int e = tid; e < NW * F::ROWS * (FBN / 4); e += FTHREADS) {
    const int q = e / (F::ROWS * (FBN / 4));
    const int r = (e / (FBN / 4)) % F::ROWS, c = (e % (FBN / 4)) * 4;
    if (r >= M || n0 + c >= N) continue;
    float4 v = *reinterpret_cast<const float4*>(red + (q * F::ROWS + r) * FBN
                                                + c);
#pragma unroll
    for (int g = 1; g < F::WK; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(
          red + ((g * NW + q) * F::ROWS + r) * FBN + c);
      v.x += t.x;
      v.y += t.y;
      v.z += t.z;
      v.w += t.w;
    }
    *reinterpret_cast<float4*>(ws + (q * gridDim.y + blockIdx.y) * MN +
                               (size_t)r * N + n0 + c) = v;
  }
}

template <int MT, int NW>
int launch_ffma_partial(const void* x, const void* w, const void* w2,
                        float* ws, int M, int K, int N, int kc, int nsplit,
                        cudaStream_t stream) {
  constexpr int smem = FSmall<MT, NW>::SMEM_BYTES;
  auto kern = ffma_small_m_partial<MT, NW>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((N + FBN - 1) / FBN), (unsigned)nsplit);
  kern<<<grid, FTHREADS, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(w2), ws, M, K, N, kc);
  return (int)cudaGetLastError();
}

template <int NW>
int ffma_partial_by_rows(const void* x, const void* w, const void* w2,
                         float* ws, int M, int K, int N, int kc, int nsplit,
                         cudaStream_t s) {
  if (M <= 8)
    return launch_ffma_partial<1, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
  if (M <= 16)
    return launch_ffma_partial<2, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
  if (M <= 32)
    return launch_ffma_partial<4, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
  if (M <= 64)
    return launch_ffma_partial<8, NW>(x, w, w2, ws, M, K, N, kc, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// C interface of ffma_small_m (bound with ctypes in kernels/_build.py): as
// matmul_small_m below, with x, w and w2 fp32, K and N multiples of 4.
extern "C" int matmul_ffma_small_m(int out_dtype, const void* x,
                                   const void* w, const void* w2,
                                   const float* bias, float* ws, void* out,
                                   int M, int K, int N, int kc, int nsplit,
                                   int act, int glu_act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool glu = w2 != nullptr;
  if (kc % FBK != 0 || nsplit < 1) return (int)cudaErrorInvalidValue;
  int err = glu ? ffma_partial_by_rows<2>(x, w, w2, ws, M, K, N, kc, nsplit, s)
                : ffma_partial_by_rows<1>(x, w, w2, ws, M, K, N, kc, nsplit,
                                          s);
  if (err != 0) return err;
  const rt::Epilogue epi{bias, nullptr, nullptr, nullptr, act, glu_act};
  return rt::splitk_reduce_to(out_dtype, ws, epi, out, M, N, nsplit, glu, s);
}

// The base variant of matmul_fused (vmem_accum=False) on the small_m
// (in_dtype bf16) or ffma_small_m (fp32) partials, without w2: the wrapper
// cuts the K splits at slab boundaries (_base_split), per_slab splits a
// slab, and rt::splitk_reduce_slabs sums each slab's splits in K order in
// fp32, rounds the slab to the output dtype and adds it into the running
// sum in that dtype, then bias and act.  The bits repeat.
extern "C" int matmul_base_small_m(int in_dtype, int out_dtype,
                                   const void* x, const void* w,
                                   const float* bias, float* ws, void* out,
                                   int M, int K, int N, int kc, int nsplit,
                                   int per_slab, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kc % SBK != 0 || nsplit < 1 || per_slab < 1)
    return (int)cudaErrorInvalidValue;
  int err = (int)cudaErrorInvalidValue;
  if (in_dtype == rt::kBF16)
    err = partial_by_rows<1>(x, w, nullptr, ws, M, K, N, kc, nsplit, s);
  else if (in_dtype == rt::kF32)
    err = ffma_partial_by_rows<1>(x, w, nullptr, ws, M, K, N, kc, nsplit, s);
  if (err != 0) return err;
  const rt::Epilogue epi{bias, nullptr, nullptr, nullptr, act, 0};
  return rt::splitk_reduce_slabs_to(out_dtype, ws, epi, out, M, N, nsplit,
                                    per_slab, s);
}

// C interface (bound with ctypes in kernels/_build.py).  x (M, K), w and w2
// (K, N) are bf16, row-major, 16-byte aligned, K and N multiples of 8,
// 1 <= M <= 64 (the wrapper checks them).  ws is an fp32 workspace of
// (w2 ? 2 : 1) * nsplit * M * N floats; split s covers K rows
// [s kc, min(K, (s + 1) kc)), kc a multiple of 32.  out_dtype 0 fp32,
// 1 bf16.  w2 and bias may be null.  Returns cudaGetLastError() after the
// two launches.
extern "C" int matmul_small_m(int out_dtype, const void* x, const void* w,
                              const void* w2, const float* bias, float* ws,
                              void* out, int M, int K, int N, int kc,
                              int nsplit, int act, int glu_act,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool glu = w2 != nullptr;
  if (kc % SBK != 0 || nsplit < 1) return (int)cudaErrorInvalidValue;
  int err = glu ? partial_by_rows<2>(x, w, w2, ws, M, K, N, kc, nsplit, s)
                : partial_by_rows<1>(x, w, w2, ws, M, K, N, kc, nsplit, s);
  if (err != 0) return err;
  const rt::Epilogue epi{bias, nullptr, nullptr, nullptr, act, glu_act};
  return rt::splitk_reduce_to(out_dtype, ws, epi, out, M, N, nsplit, glu, s);
}

namespace {
template <int NW>
int partial_smem_by_rows(int M) {               // as partial_by_rows
  switch ((M + 15) / 16) {
    case 1: return partial_smem<1, NW>();
    case 2: return partial_smem<2, NW>();
    case 3: return partial_smem<3, NW>();
    case 4: return partial_smem<4, NW>();
    default: return -1;
  }
}

template <int NW>
int ffma_smem_by_rows(int M) {                  // as ffma_partial_by_rows
  if (M <= 8) return FSmall<1, NW>::SMEM_BYTES;
  if (M <= 16) return FSmall<2, NW>::SMEM_BYTES;
  if (M <= 32) return FSmall<4, NW>::SMEM_BYTES;
  if (M <= 64) return FSmall<8, NW>::SMEM_BYTES;
  return -1;
}
}  // namespace

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// M rows; glu 1: the w / w2 pair.
extern "C" int matmul_small_m_smem(int M, int glu) {
  if (M < 1) return -1;
  return glu ? partial_smem_by_rows<2>(M) : partial_smem_by_rows<1>(M);
}

extern "C" int matmul_ffma_small_m_smem(int M, int glu) {
  if (M < 1) return -1;
  return glu ? ffma_smem_by_rows<2>(M) : ffma_smem_by_rows<1>(M);
}
