// flash_attention_wgmma: the bf16 schedule of flash_attention at head widths
// 64, 128 and 256 on Hopper's tensor cores.  Replaces the Pallas kernel
// flash_attention of src/repro/kernels/attention.py:93 for bf16 operands;
// the wrapper, the schedule choice and the plain version it is held against
// are in src/repro_torch/kernels/attention.py (fp32 and head widths 16 and
// 32 stay on the SIMT kernel of flash_attention.cu).
//
// What bounds it on the H100: at the llama3.2-1b prefill (B 8 x S 512, 32
// heads over 8 KV heads of 64, causal) a call does ~8.6 GFLOP of products
// against ~42 MB of q, k, v and out, ~200 operations a byte: below the bf16
// ridge of ~295 (989 TFLOP/s over 3.35 TB/s), so the bytes bound it.  The
// design keeps the (Sq, Skv) scores and probabilities in registers, reads q
// once and each K/V tile once a block (shared by the block's 128 query rows
// and, through L2, by the G heads of a KV head), and runs both products on
// wgmma so that the exponentials, not the products, are the arithmetic.
//
// The design: one block per (BQ query rows, head, batch row): BQ / 64
// consumer warpgroups of 64 query rows each and one producer warp, as in
// matmul_wgmma.cu (at D = 256 and BQ = 128 a producer warpgroup, for
// setmaxnreg: Cfg).  BQ is the plan's tile (plan.tiles["attention"][0],
// 64 or 128, which kernels/attention.py hands down): 128 by default, two
// consumer warpgroups sharing each K/V tile; 64 in the base flow's
// minimal tile.  q is viewed as the 2-D row-major (B * Sq, H * D) and k, v
// as (B * Skv, KV * D); a block's Q tile is D / 64 TMA boxes of BQ rows x
// 64 columns (128 bytes, the 128-byte swizzle) at (b * Sq + q0, h * D +
// 64 c), a K or V tile D / 64 boxes of 64 keys at (b * Skv + k0, kvh * D +
// 64 c).  Rows of that view past Sq or Skv belong to the next batch row
// (TMA zero-fills only past the whole tensor), so keys at or past Skv are
// masked (their position is -1) and query rows at or past Sq are never
// written.  The producer loads Q once, then K and V tiles of 64 keys through
// a ring of STAGES slots with full and empty mbarriers; beside each slot it
// stages the tile's key positions and whether any of them is padding.  Each consumer warpgroup, per tile:
//   S = Q K^T   wgmma m64n64k16, both operands K-major in shared memory (d
//               contiguous in q and k), fp32 accumulators;
//   in registers: S * D^-1/2 in log2 units (the exponentials are ex2 on
//               the SFU), the softcap, the positional mask (key pos >= 0,
//               <= query pos under causal, > query pos - window) on the
//               tiles that need one (padding or keys past Skv, the causal
//               diagonal, the window's edge: 8 of 36 tiles at llama's),
//               the online max and sum, each row's max reduced across the
//               four lanes of a quad (a thread holds rows r and r + 8 of
//               its warp's 16; the sum stays a per-thread partial until the
//               end); the output rescaled;
//   O += P V    P rounded to bf16 into A-operand registers (the m64n64
//               accumulator layout is the m64k16 A-register layout), V in
//               shared memory as an MN-major B (d contiguous: the transpose
//               bit, leading byte offset the next 64-column box), wgmma
//               m64nDk16;
// then releases the slot.  Tiles dead in index space (above the causal
// diagonal or wholly outside the window) are never loaded for the block, and
// a warpgroup skips those dead for its own 64 rows; this is exact under the
// positions contract (per-row shifted aranges), as in the Pallas kernel.  The
// epilogue divides by max(l, 1e-30) in fp32 and writes bf16 rows < Sq.
//
// Numerics: P is rounded to bf16 before P V (the Pallas kernel keeps it in
// fp32), about 2^-9 relative on each probability, far inside the bf16
// tolerance of 2e-2; l sums the unrounded p.  p is ex2 of (x - m) with both
// in log2 units, never of fma(x, f, -m f): for a tile wholly masked so far
// (x = m = -1e30) the fma leaves the rounding error of a ~1e29 product, and
// ex2 of it is inf.  No atomics: the same inputs give the same bits on
// every run.
#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BK = 64;           // keys a K/V tile
constexpr int WGQ = 64 * 128;    // a warpgroup's 64 rows of a Q box, 8 KB
constexpr int KBOX = BK * 128;   // one 64-key x 64-column K or V box, 8 KB
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

// Per head width and query rows: the ring's depth, the blocks an SM, the
// threads (BQ / 64 consumer warpgroups and a producer warp, or a producer
// warpgroup where setmaxnreg moves registers to the consumers: it acts on
// whole warpgroups) and the consumers' registers after setmaxnreg (0:
// none).  A block's warps share the SM's four 16K-register quarters, so 9
// warps get at most 168 registers a thread (3 warps in one quarter).  At
// BQ 128: D = 64: a Q tile of 16 KB and 16 KB a stage, 4 stages, two blocks
// an SM (at most 96 registers: 32 output and 32 score accumulators fit).
// D = 128: 32 KB and 32 KB, 3 stages, one block (64 output accumulators fit
// in 168).  D = 256: 64 KB and 64 KB, 2 stages (192 KB), one block of 384
// threads, the producer warpgroup down to 40 registers and the consumers up
// to 232 (128 output accumulators; at 168 they spilled).  At BQ 64 the same
// rings under half the Q tile, 160 threads (one consumer warpgroup and the
// producer warp) and no setmaxnreg: 5 warps may take 255 registers a
// thread, enough for D = 256's 128 output accumulators.
template <int D> struct Ring;
template <> struct Ring<64> { static constexpr int STAGES = 4, MINB = 2; };
template <> struct Ring<128> { static constexpr int STAGES = 3, MINB = 1; };
template <> struct Ring<256> { static constexpr int STAGES = 2, MINB = 1; };
template <int D, int BQ> struct Cfg {
  static_assert(BQ == 64 || BQ == 128, "one or two consumer warpgroups");
  static constexpr int STAGES = Ring<D>::STAGES, MINB = Ring<D>::MINB;
  static constexpr int NWG = BQ / 64;            // consumer warpgroups
  static constexpr int CONSUMERS = 128 * NWG;    // their threads
  static constexpr bool WIDE = D == 256 && BQ == 128;   // setmaxnreg
  static constexpr int THREADS = CONSUMERS + (WIDE ? 128 : 32);
  static constexpr int REGS = WIDE ? 232 : 0;
};

template <int D, int BQ>
__host__ __device__ constexpr int q_bytes() { return (D / 64) * BQ * 128; }
template <int D>
__host__ __device__ constexpr int stage_bytes() {   // K's boxes, then V's
  return 2 * (D / 64) * KBOX;
}
template <int D, int BQ>
__host__ __device__ constexpr int smem_bytes() {
  // alignment slack, Q, the stages, their key positions, the mbarriers,
  // the stages' pad flags
  return 1024 + q_bytes<D, BQ>() +
         Cfg<D, BQ>::STAGES * (stage_bytes<D>() + BK * 4) +
         (1 + 2 * Cfg<D, BQ>::STAGES) * 8 + Cfg<D, BQ>::STAGES * 4;
}

// D (64 x 64 fp32, 32 registers a thread) = or += A (64 x 16, K-major)
// * B (16 x 64, K-major), both in shared memory behind descriptors.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64 fp32, 32 registers a thread) += A (64 x 16 bf16, four
// registers a thread) * B (16 x 64, MN-major: the transpose bit) in shared
// memory.  A is "+r": the registers stay the wgmma's until it retires.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(1));
}

// D (64 x 128 fp32, 64 registers a thread) += A (64 x 16 bf16, four
// registers a thread) * B (16 x 128, MN-major: the transpose bit) in shared
// memory.  A is "+r": the registers stay the wgmma's until it retires.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(1));
}

// D (64 x 256 fp32, 128 registers a thread) += A (64 x 16 bf16, four
// registers a thread) * B (16 x 256, MN-major: the transpose bit) in shared
// memory.  A is "+r": the registers stay the wgmma's until it retires.
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                            uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127]),
        "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "l"(db), "r"(1));
}

// 2^x on the SFU (flushes denormals; 2^-1e30 is 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2], uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 64)
    wgmma_rs_n64(o, a, db);
  else if constexpr (D == 128)
    wgmma_rs_n128(o, a, db);
  else
    wgmma_rs_n256(o, a, db);
}

// The key tiles [kb, ke) that hold a live key for some query row in
// [q_lo, q_lo + rows) (absolute positions in index space): under causal none
// past the last row's position; under the window none wholly at or below
// q_lo - window.
__device__ __forceinline__ void tile_range(int q_lo, int rows, int nk,
                                           int causal, int window, int& kb,
                                           int& ke) {
  ke = causal ? min(nk, (q_lo + rows - 1) / BK + 1) : nk;
  kb = 0;
  if (window > 0) {
    const int lo = q_lo - window + 2 - BK;   // the first k0 with a live key
    kb = lo > 0 ? (lo + BK - 1) / BK : 0;
  }
}

template <int D, int BQ>
__global__ void __launch_bounds__(Cfg<D, BQ>::THREADS, Cfg<D, BQ>::MINB)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const int* __restrict__ qpos, const int* __restrict__ kpos,
                   bf16* __restrict__ out, int Sq, int Skv, int H, int KV,
                   int causal, int window, float softcap, int q_offset,
                   float scale) {
  using C = Cfg<D, BQ>;
  constexpr int STAGES = C::STAGES;
  constexpr int NB = D / 64;                 // 64-column boxes across a head
  constexpr int QBOX = BQ * 128;             // one BQ-row x 64-column Q box
  constexpr int STAGE = stage_bytes<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled boxes need 1024-byte aligned slots
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base, kv_s = base + q_bytes<D, BQ>();
  int* kpos_s = reinterpret_cast<int*>(smem_raw + (base - raw) +
                                       q_bytes<D, BQ>() + STAGES * STAGE);
  const uint32_t bars = smem_u32(kpos_s + STAGES * BK);
  const uint32_t full_q = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + STAGES + s); };
  // a stage's flag: some key of its tile is padding or past Skv
  int* kpad_s =
      reinterpret_cast<int*>(kpos_s + STAGES * BK + 2 * (1 + 2 * STAGES));

  const int tid = threadIdx.x;
  // the last query tiles, with the most keys under causal, go out first
  const int q0 = (int)(gridDim.x - 1 - blockIdx.x) * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int nk = (Skv + BK - 1) / BK;
  int kb, ke;                                // the block's live key tiles
  tile_range(q0 + q_offset, BQ, nk, causal, window, kb, ke);

  if (tid == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 4 * C::NWG);      // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= C::CONSUMERS) {                 // the producer warp
    if constexpr (C::REGS > 0) {
      setmaxnreg_dec<40>();
      if (tid >= C::CONSUMERS + 32) return;  // the rest of its warpgroup
    }
    const int lane = tid - C::CONSUMERS;
    if (lane == 0) {
      mbar_expect_tx(full_q, q_bytes<D, BQ>());
      for (int c = 0; c < NB; ++c)
        tma_load_2d(q_s + c * QBOX, &tq, h * D + 64 * c, b * Sq + q0, full_q);
    }
    for (int kt = kb; kt < ke; ++kt) {
      const int i = kt - kb, s = i % STAGES, k0 = kt * BK;
      if (i >= STAGES) mbar_wait(empty(s), ((i / STAGES) - 1) & 1);
      // the tile's key positions; keys past Skv (the next batch row's in
      // the 2-D view, or TMA's zero fill) are masked
      bool pad = false;
      for (int r = lane; r < BK; r += 32) {
        const int p = k0 + r >= Skv ? -1
                      : kpos != nullptr ? kpos[(size_t)b * Skv + k0 + r]
                                        : k0 + r;
        kpos_s[s * BK + r] = p;
        pad = pad || p < 0;
      }
      pad = __any_sync(0xffffffffu, pad);
      if (lane == 0) kpad_s[s] = pad;
      __syncwarp();
      if (lane == 0) {
        mbar_expect_tx(full(s), STAGE);
        const uint32_t ks = kv_s + s * STAGE, vs = ks + NB * KBOX;
        for (int c = 0; c < NB; ++c) {
          tma_load_2d(ks + c * KBOX, &tk, kvh * D + 64 * c, b * Skv + k0,
                      full(s));
          tma_load_2d(vs + c * KBOX, &tv, kvh * D + 64 * c, b * Skv + k0,
                      full(s));
        }
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63; a thread
  // holds rows r and r + 8 (accumulator fragment i: row r + 8 ((i % 4) / 2),
  // column 8 (i / 4) + 2 (lane % 4) + i % 2)
  if constexpr (C::REGS > 0) setmaxnreg_inc<C::REGS>();
  const int wg = tid / 128, t = tid % 128, warp = t / 32, lane = t % 32;
  const int r = q0 + wg * 64 + warp * 16 + lane / 4;
  int qp[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
    qp[hh] = r + 8 * hh >= Sq ? 0
             : qpos != nullptr ? qpos[(size_t)b * Sq + r + 8 * hh]
                               : r + 8 * hh + q_offset;
  const int q_lo = q0 + wg * 64 + q_offset;   // in index space
  int kbw, kew;                              // this warpgroup's live tiles
  tile_range(q_lo, 64, nk, causal, window, kbw, kew);
  // scores go to log2 units, so that the exponentials are ex2
  const float to_log2 = scale * LOG2E, cap_in = scale / softcap,
              cap_out = softcap * LOG2E;

  float o[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) o[e] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};
  const uint32_t qa = q_s + wg * WGQ;
  mbar_wait(full_q, 0);

  for (int kt = kb; kt < ke; ++kt) {
    const int i = kt - kb, s = i % STAGES;
    mbar_wait(full(s), (i / STAGES) & 1);
    if (kt >= kbw && kt < kew) {
      const uint32_t ks = kv_s + s * STAGE, vs = ks + NB * KBOX;
      // S = Q K^T: D / 16 steps of 16, 32 bytes a step inside a box's
      // swizzle row
      float sc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.0f;
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < D / 16; ++j) {
        const int off = (j % 4) * 32;
        wgmma_ss_n64(sc, make_desc(qa + (j / 4) * QBOX + off, 16, 1024),
                     make_desc(ks + (j / 4) * KBOX + off, 16, 1024), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < 32; ++e) fence_operand(sc[e]);

      // scale (and softcap) into log2 units; the mask only on tiles that
      // need it: padding or keys past Skv, the causal diagonal, the
      // window's edge (in index space, exact under the positions contract)
      if (softcap > 0.0f) {
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] = tanhf(sc[e] * cap_in) * cap_out;
      } else {
#pragma unroll
        for (int e = 0; e < 32; ++e) sc[e] *= to_log2;
      }
      const int k0 = kt * BK;
      if (kpad_s[s] || (causal && k0 + BK - 1 > q_lo) ||
          (window > 0 && k0 <= q_lo + 63 - window)) {
        const int* kp = kpos_s + s * BK + 2 * (lane % 4);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kq = *reinterpret_cast<const int2*>(kp + 8 * j);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kk = e % 2 ? kq.y : kq.x, qq = qp[e / 2];
            bool ok = kk >= 0;
            if (causal) ok = ok && kk <= qq;
            if (window > 0) ok = ok && kk > qq - window;
            if (!ok) sc[4 * j + e] = NEG;
          }
        }
      }
      float mt[2] = {NEG, NEG};
#pragma unroll
      for (int e = 0; e < 32; ++e)
        mt[(e % 4) / 2] = fmaxf(mt[(e % 4) / 2], sc[e]);
      float alpha[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 1));
        mt[hh] = fmaxf(mt[hh], __shfl_xor_sync(0xffffffffu, mt[hh], 2));
        const float m_new = fmaxf(m[hh], mt[hh]);
        alpha[hh] = ex2(m[hh] - m_new);
        m[hh] = m_new;
        l[hh] *= alpha[hh];
      }
      // P in bf16 A registers: k-step kk's register j packs fragments
      // 8 kk + 2 j and + 1 (keys 16 kk + 2 (lane % 4) (+ 8 for j >= 2))
      uint32_t pa[4][4];
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int hh = (e % 4) / 2;
        const float p0 = ex2(sc[e] - m[hh]);
        const float p1 = ex2(sc[e + 1] - m[hh]);
        l[hh] += p0 + p1;
        __nv_bfloat162 pr = __floats2bfloat162_rn(p0, p1);
        pa[e / 8][(e % 8) / 2] = *reinterpret_cast<uint32_t*>(&pr);
      }
#pragma unroll
      for (int e = 0; e < D / 2; ++e) o[e] *= alpha[(e % 4) / 2];

      // O += P V: four steps of 16 keys, 16 V rows (2048 bytes) a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_pv<D>(o, pa[kk], make_desc(vs + kk * 2048, KBOX, 1024));
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int e = 0; e < D / 2; ++e) fence_operand(o[e]);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) fence_operand(pa[kk][j]);
    }
    if (lane == 0) mbar_arrive(empty(s));
  }

  // epilogue: the row sums across the quad, O / max(l, 1e-30), rows < Sq
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r + 8 * hh;
    if (row >= Sq) continue;
    bf16* orow = out + ((size_t)(b * Sq + row) * H + h) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
          __floats2bfloat162_rn(o[4 * j + 2 * hh] / l[hh],
                                o[4 * j + 2 * hh + 1] / l[hh]);
  }
}

template <int D, int BQ>
int launch(const void* q, const CUtensorMap& tk, const CUtensorMap& tv,
           const int* qpos, const int* kpos, void* out, int B, int Sq,
           int Skv, int H, int KV, int causal, int window, float softcap,
           int q_offset, cudaStream_t stream) {
  CUtensorMap tq;
  if (!encode(&tq, q, B * Sq, H * D, BQ)) return (int)cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<D, BQ>;
  constexpr int smem = smem_bytes<D, BQ>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)H, (unsigned)B);
  kern<<<grid, Cfg<D, BQ>::THREADS, smem, stream>>>(
      tq, tk, tv, qpos, kpos, static_cast<bf16*>(out), Sq, Skv, H, KV,
      causal, window, softcap, q_offset,
      (float)(1.0 / std::sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <int D>
int launch_bq(int bq, const void* q, const CUtensorMap& tk,
              const CUtensorMap& tv, const int* qpos, const int* kpos,
              void* out, int B, int Sq, int Skv, int H, int KV, int causal,
              int window, float softcap, int q_offset, cudaStream_t s) {
  if (bq == 128)
    return launch<D, 128>(q, tk, tv, qpos, kpos, out, B, Sq, Skv, H, KV,
                          causal, window, softcap, q_offset, s);
  if (bq == 64)
    return launch<D, 64>(q, tk, tv, qpos, kpos, out, B, Sq, Skv, H, KV,
                         causal, window, softcap, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

template <int BQ>
int smem_of(int D) {
  switch (D) {
    case 64: return smem_bytes<64, BQ>();
    case 128: return smem_bytes<128, BQ>();
    case 256: return smem_bytes<256, BQ>();
    default: return -1;
  }
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  q (B, Sq, H, D),
// k and v (B, Skv, KV, D), out (B, Sq, H, D): bf16, contiguous, 16-byte
// aligned (the TMA rules; the wrapper sees to them), D in {64, 128, 256};
// qpos (B, Sq) and kpos (B, Skv) int32, -1 for padding, or both null for
// the positions of the indices (query i at q_offset + i, key j at j).
// window 0 means none, softcap 0 means none.  bq: the query rows a block,
// 64 or 128 (the plan's tile).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a shape or tile it does not take or
// a tensor map it cannot encode.
extern "C" int flash_attention_wgmma(const void* q, const void* k,
                                     const void* v, const int* qpos,
                                     const int* kpos, void* out, int B,
                                     int Sq, int Skv, int H, int KV, int D,
                                     int causal, int window, float softcap,
                                     int q_offset, int bq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap tk, tv;
  if (!encode(&tk, k, B * Skv, KV * D, BK) ||
      !encode(&tv, v, B * Skv, KV * D, BK))
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return launch_bq<64>(bq, q, tk, tv, qpos, kpos, out, B, Sq, Skv, H, KV,
                           causal, window, softcap, q_offset, s);
    case 128:
      return launch_bq<128>(bq, q, tk, tv, qpos, kpos, out, B, Sq, Skv, H,
                            KV, causal, window, softcap, q_offset, s);
    case 256:
      return launch_bq<256>(bq, q, tk, tv, qpos, kpos, out, B, Sq, Skv, H,
                            KV, causal, window, softcap, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// Head width D, bq query rows a block.
extern "C" int flash_attention_wgmma_smem(int D, int bq) {
  return bq == 128 ? smem_of<128>(D) : bq == 64 ? smem_of<64>(D) : -1;
}
