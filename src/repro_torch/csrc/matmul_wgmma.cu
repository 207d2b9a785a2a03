// matmul_wgmma: the large-M schedule of matmul_fused (bf16 operands),
// y = epilogue(x @ w [, x @ w2]) on Hopper's tensor cores.  Replaces the
// Pallas kernel matmul_fused of src/repro/kernels/matmul_fused.py (its CW
// branch) where M is above the wrapper's crossover: the LM prefills (8 x 512
// rows), serving prefill batches and chunked catch-up.  The schedule choice,
// the plain version and the design note are in
// src/repro_torch/kernels/matmul_fused.py.
//
// What bounds it: the operations.  A 4096-row projection does
// 2 * 4096 * K * N flops against (4096 + N) * K * 2 bytes, some 1,000-3,000
// flops a byte, far above the H100's ridge of ~295 (989 TFLOP/s bf16 over
// 3.35 TB/s).  Only wgmma reaches the tensor cores' full rate.
//
// The design: one block computes a 128 x 128 output tile (128 x 64 per
// accumulator in the GLU form, two accumulators), two blocks an SM. Its K
// loop walks 64-deep stages through a ring of 3 shared-memory slots. One
// producer thread (warp 8) issues TMA loads of the x tile (128 x 64,
// K-major) and the w tile (64 x 128 as two 64 x 64 boxes; w2's box beside
// w's in the GLU form) into a free slot, with a "full" mbarrier counting the
// bytes in; two consumer warpgroups (warps 0-7, 64 rows each) wait on it,
// issue four wgmma.mma_async m64nNk16 over the slot (B is MN-major: the
// transpose bit), and release the slot on its "empty" mbarrier only once
// those wgmmas have retired (wgmma.wait_group 0). The 128-byte swizzle of
// the TMA boxes is the one the wgmma descriptors name. The fp32 accumulators
// stay in registers; the epilogue (GLU act * acc2, + bias, act) runs there
// and writes the output once, masked at the ragged edge; TMA zero-fills the
// loads past M, N and K. The GLU form takes N = 64 tiles so that its two
// accumulators fit the same 64 registers a thread as the plain form's one,
// with no setmaxnreg; grid (M / 128, N / BN), not persistent.
//
// matmul_base_wgmma is the base variant of matmul_fused (vmem_accum=False,
// the Pallas kernel's base branch) on the same mainloop, for a bf16 output:
// the slab of bk = 64 * slab K rows is a whole number of stages, so at a
// slab's last stage, once its wgmma group has retired (the mainloop waits
// for it every stage), the consumers fold the fp32 accumulator into a
// second register set, sum = round(sum + round(acc)), and zero the
// accumulator; the epilogue (+ bias, act) reads the widened sum.  The sum
// is held as 32 packed bf16x2 registers a thread (every value of it is a
// bf16), not 64 fp32 ones.  Two blocks an SM still fit, but only at the 96
// registers a thread that ptxas allows two 288-thread blocks, so the fold
// spills 112 bytes a thread (chip_smoke.py's build phase prints the ptxas
// report).  On the H100 this ran faster than one block an SM of 4 or 5
// stages (no spill) and than folding through the output in memory.  An
// fp32 output runs the CW kernel as it is: rounding a slab's sum to fp32
// changes nothing.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::apply_act;
using namespace hopper;

constexpr int BM = 128;            // rows a block: two consumer warpgroups
constexpr int BK = 64;             // K a stage: one 128-byte swizzle row
constexpr int THREADS = 288;       // 2 consumer warpgroups + 1 producer warp
constexpr int A_BYTES = BM * BK * 2;                 // 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;               // one 64 x 64 w box, 8 KB

// The tile's N extent per accumulator, the ring's depth and the blocks an
// SM of each form: one accumulator of BN / 2 fp32 registers a thread in the
// plain form, two in the GLU form.  Chosen on the H100 at the LM prefill
// shapes: two blocks an SM of 3 stages (2 x 97 KB of shared memory, at
// most 112 registers a thread) ran faster than one block of 4-6 stages, the
// second block's loads and epilogue filling the first one's waits, and
// faster than 128 x 256 tiles (128 accumulator registers a thread).
constexpr int PLAIN_BN = 128, PLAIN_STAGES = 3, PLAIN_MINB = 2;
constexpr int GLU_BN = 64, GLU_STAGES = 3, GLU_MINB = 2;

template <int BN, int NACC>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + NACC * (BN / 64) * BOX_BYTES;
}
template <int BN, int NACC, int STAGES>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<BN, NACC>() + 1024 + 2 * STAGES * 8;
}

// One 128 x BN output tile: NACC = 1 (w) or 2 (the GLU pair w, w2), each
// weight's stage tile BN / 64 boxes of 64 x 64.  SLAB (the base variant,
// bf16 out, NACC 1): the sum of each slab of `slab` stages is rounded to
// bf16 and added into the bf16 running sum.
template <int BN, int NACC, int STAGES, int MINB, typename TOut,
          bool SLAB = false>
__global__ void __launch_bounds__(THREADS, MINB)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                    const __grid_constant__ CUtensorMap tw,
                    const __grid_constant__ CUtensorMap tw2,
                    const float* __restrict__ bias, TOut* __restrict__ out,
                    int M, int K, int N, int act, int glu_act, int slab) {
  constexpr bool GLU = NACC == 2;
  static_assert(!SLAB || (NACC == 1 && sizeof(TOut) == 2),
                "the slab fold is the base variant's: one weight, bf16 out");
  constexpr int NBOX = BN / 64;
  constexpr int STAGE = stage_bytes<BN, NACC>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled boxes need 1024-byte aligned slots
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (STAGES + s); };

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int nk = (K + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 8);        // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {                  // the producer warp: one thread loads
    if (tid == 256) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        if (kt >= STAGES) mbar_wait(empty(s), ((kt / STAGES) - 1) & 1);
        mbar_expect_tx(full(s), STAGE);
        const uint32_t a = base + s * STAGE, b = a + A_BYTES;
        tma_load_2d(a, &tx, kt * BK, m0, full(s));
#pragma unroll
        for (int q = 0; q < NACC; ++q)
#pragma unroll
          for (int i = 0; i < NBOX; ++i)
            tma_load_2d(b + (q * NBOX + i) * BOX_BYTES, q == 0 ? &tw : &tw2,
                        n0 + 64 * i, kt * BK, full(s));
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns rows m0 + 64 wg .. + 63
  const int wg = tid / 128;
  float acc[NACC][BN / 2];
#pragma unroll
  for (int q = 0; q < NACC; ++q)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[q][i] = 0.0f;

  // the base variant's running sum, bf16 pairs (columns 2i, 2i + 1 of acc)
  __nv_bfloat162 sum[SLAB ? BN / 4 : 1];
#pragma unroll
  for (int i = 0; i < (SLAB ? BN / 4 : 1); ++i)
    sum[i] = __floats2bfloat162_rn(0.0f, 0.0f);
  int left = slab;                   // stages to the end of the slab

  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % STAGES;
    mbar_wait(full(s), (kt / STAGES) & 1);
    const uint32_t a = base + s * STAGE + wg * (A_BYTES / 2);
    const uint32_t b = base + s * STAGE + A_BYTES;
    wgmma_fence();
#pragma unroll
    for (int q = 0; q < NACC; ++q)
      stage_mma<BN>(acc[q], a, b + q * NBOX * BOX_BYTES);
    wgmma_commit();
    // release the slot once its products retired: one slot held, the rest
    // free for loads; the SM's other block keeps the tensor cores busy
    // meanwhile (faster on the H100 than keeping one group in flight)
    wgmma_wait<0>();
    if ((tid & 31) == 0) mbar_arrive(empty(s));
    if constexpr (SLAB) {
      if (--left == 0 || kt == nk - 1) {   // the slab's last stage
        // read acc only after the wait that retired its wgmma
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) fence_operand(acc[0][i]);
#pragma unroll
        for (int i = 0; i < BN / 4; ++i) {
          const float2 v = __bfloat1622float2(sum[i]);
          sum[i] = __floats2bfloat162_rn(
              v.x + rt::round_to<bf16>(acc[0][2 * i]),
              v.y + rt::round_to<bf16>(acc[0][2 * i + 1]));
          acc[0][2 * i] = 0.0f;
          acc[0][2 * i + 1] = 0.0f;
        }
        left = slab;
      }
    }
  }

  // epilogue: fragment i of a thread holds row 16 warp + lane/4 (+8 for
  // i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + j * 8 + (lane % 4) * 2;
    if (c >= N) continue;            // N % 8 == 0: c + 1 < N as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if (r >= M) continue;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = acc[0][4 * j + 2 * h + e];
        if constexpr (SLAB) {
          const float2 sv = __bfloat1622float2(sum[2 * j + h]);
          x = e == 0 ? sv.x : sv.y;
        }
        if (GLU) x = apply_act(x, glu_act) * acc[NACC - 1][4 * j + 2 * h + e];
        if (bias != nullptr) x += bias[c + e];
        v[e] = apply_act(x, act);
      }
      TOut* o = out + (size_t)r * N + c;
      if constexpr (sizeof(TOut) == 4) {
        *reinterpret_cast<float2*>(o) = make_float2(v[0], v[1]);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(o) =
            __floats2bfloat162_rn(v[0], v[1]);
      }
    }
  }
}

template <int BN, int NACC, int STAGES, int MINB, typename TOut,
          bool SLAB = false>
int launch(const CUtensorMap& tx, const CUtensorMap& tw,
           const CUtensorMap& tw2, const float* bias, void* out, int M,
           int K, int N, int act, int glu_act, cudaStream_t stream,
           int slab = 0) {
  auto kern = matmul_wgmma_kernel<BN, NACC, STAGES, MINB, TOut, SLAB>;
  constexpr int smem = smem_bytes<BN, NACC, STAGES>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  kern<<<grid, THREADS, smem, stream>>>(tx, tw, tw2, bias,
                                        static_cast<TOut*>(out), M, K, N,
                                        act, glu_act, slab);
  return (int)cudaGetLastError();
}

template <typename TOut>
int launch_form(bool glu, const CUtensorMap& tx, const CUtensorMap& tw,
                const CUtensorMap& tw2, const float* bias, void* out, int M,
                int K, int N, int act, int glu_act, cudaStream_t s) {
  if (glu)
    return launch<GLU_BN, 2, GLU_STAGES, GLU_MINB, TOut>(
        tx, tw, tw2, bias, out, M, K, N, act, glu_act, s);
  return launch<PLAIN_BN, 1, PLAIN_STAGES, PLAIN_MINB, TOut>(
      tx, tw, tw2, bias, out, M, K, N, act, glu_act, s);
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  x (M, K), w and w2
// (K, N) are bf16, row-major, 16-byte aligned, K and N multiples of 8 (the
// TMA rules; the wrapper checks them).  out_dtype 0 fp32, 1 bf16.  w2 and
// bias may be null.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue when a tensor map cannot be encoded.
extern "C" int matmul_wgmma(int out_dtype, const void* x, const void* w,
                            const void* w2, const float* bias, void* out,
                            int M, int K, int N, int act, int glu_act,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool glu = w2 != nullptr;
  CUtensorMap tx, tw, tw2;
  if (!encode(&tx, x, M, K, BM) || !encode(&tw, w, K, N, BK) ||
      !encode(&tw2, glu ? w2 : w, K, N, BK))
    return (int)cudaErrorInvalidValue;
  if (out_dtype == rt::kF32)
    return launch_form<float>(glu, tx, tw, tw2, bias, out, M, K, N, act,
                              glu_act, s);
  if (out_dtype == rt::kBF16)
    return launch_form<bf16>(glu, tx, tw, tw2, bias, out, M, K, N, act,
                             glu_act, s);
  return (int)cudaErrorInvalidValue;
}

// The base variant (C interface as matmul_wgmma, without w2): x (M, K) and
// w (K, N) bf16, the same TMA rules; slab = bk / 64 stages a K slab (the
// wrapper's _slab_depth, a multiple of 64).  out_dtype 1 (bf16) folds the
// slabs in registers; 0 (fp32) runs the CW kernel, whose fp32 sum is the
// base variant's up to the order of its additions.
extern "C" int matmul_base_wgmma(int out_dtype, const void* x, const void* w,
                                 const float* bias, void* out, int M, int K,
                                 int N, int slab, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap tx, tw;
  if (slab < 1 || !encode(&tx, x, M, K, BM) || !encode(&tw, w, K, N, BK))
    return (int)cudaErrorInvalidValue;
  if (out_dtype == rt::kF32)
    return launch<PLAIN_BN, 1, PLAIN_STAGES, PLAIN_MINB, float>(
        tx, tw, tw, bias, out, M, K, N, act, 0, s);
  if (out_dtype == rt::kBF16)
    return launch<PLAIN_BN, 1, PLAIN_STAGES, PLAIN_MINB, bf16, true>(
        tx, tw, tw, bias, out, M, K, N, act, 0, s, slab);
  return (int)cudaErrorInvalidValue;
}

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// glu 1: the w / w2 pair.
extern "C" int matmul_wgmma_smem(int glu) {
  return glu ? smem_bytes<GLU_BN, 2, GLU_STAGES>()
             : smem_bytes<PLAIN_BN, 1, PLAIN_STAGES>();
}
