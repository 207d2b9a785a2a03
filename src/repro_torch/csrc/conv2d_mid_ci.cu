// conv2d_mid_ci: the `mid_ci` schedule of conv2d_fused, for bf16 convs of
// 8 to 63 input channels (CI and CO multiples of 8, K = kh kw CI at most
// K_MAX, x, w and out 16-byte aligned): MobileNetV1's 32 -> 64 pointwise
// conv at 112 px.  Replaces the Pallas kernel conv2d_fused of
// src/repro/kernels/conv2d.py for those convs; see
// src/repro_torch/kernels/conv2d.py for the schedule rule, the chunk map
// (mid_ci_chunks), the tile walk (mid_ci_grid, mid_ci_walk) and the plain
// PyTorch version it is held against.
//
// Same function as the other schedules: NHWC x HWIO, stride, XLA's SAME split
// (the odd row high) or VALID, fp32 sums, the batch-norm fold and the act,
// one write in bf16.
//
// What bounds it on the H100.  At the path's shape (batch 8, 112 x 112, CI
// 32 -> CO 64, 1x1) M = 100,352 pixels and K = 32: 0.41 GFLOP against 6.4 MB
// of x and 12.8 MB of output, about 21 flops a byte, far under the bf16
// ridge (~295).  The bytes bound it (0.0058 ms at 3.35 TB/s), two thirds of
// them the output.  What it needs is loads and stores kept in flight, not
// the tensor cores' peak; the `simt` kernel it replaces staged every element
// as fp32 one 2-byte load at a time behind runtime divisions, with a root a
// output element, and reached 14% of the bound.  So:
//
// - A persistent grid of three blocks an SM (53 KB of shared memory each at
//   the path's K), rounded to a multiple of the 64-channel strips, so that a
//   block keeps one strip: its w (K rows padded to the 32-deep stage by zero
//   rows, 144-byte rows, conflict-free for ldmatrix.trans) and the strip's
//   batch-norm fold (EpilogueCols, one root a channel) are loaded once and
//   stay resident; K_MAX (576 = 3x3 x 64) keeps the strip within 81 KB.
//   The block walks 128-pixel M tiles, about two a block at the path's 784.
//   (On the H100 at the path's shape two or three blocks an SM ran faster
//   than four, as many as fit, or one; a ring of 2-6 slots moved it by less
//   than the run's spread.)
// - The gather: a 32-deep K stage of a tile is 128 pixel rows of four
//   16-byte chunks, each chunk 8 channels of one tap (CI % 8 == 0: a chunk
//   never straddles two taps), copied by cp.async into a 3-slot ring (rows
//   padded to 80 bytes: conflict-free for ldmatrix); src-size 0 zero-fills a
//   tap in the padding, a pixel past M and the K padding.  The chunk ->
//   (dh, dw, offset) map is a per-block table in shared memory and a
//   thread's two pixels are decoded once a tile, so the gather has no
//   division.  Four threads a pixel row: at the path's 1x1 a warp's copy is
//   8 pixels' contiguous 512 bytes.  The ring runs across tiles, and w's
//   strip, the first two tiles and the fold's columns are all in flight
//   together at the start.
// - The product: mma.sync m16n8k16 (bf16 in, fp32 sums in registers), 8
//   warps, warp w pixel rows 16 w .. 16 w + 15 by the strip's 64 channels; A
//   by ldmatrix, B by ldmatrix.trans.  Not wgmma: at the path's K of 32 a
//   tile is two k16 steps, and the tensor cores are nowhere near the limit.
// - The epilogue: the fold from the staged columns, the act a template
//   constant for the path's ReLU and none (read at run time otherwise),
//   into the warp's 16 staging rows in shared memory; the warp then writes
//   them as whole 128-byte rows of NHWC (16-byte stores, 8 lanes a pixel),
//   with no block barrier.
// - The stages of K are a template constant for the path's one (K = 32) and
//   a loop otherwise.
//
// What is left: chip_smoke.py times the conv at batch 4 to 32 beside
// cuDNN's; the time grows with the batch at about cuDNN's rate but starts
// higher (PERF.md).
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace rt;
using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix .x4 (A fragments: a 16 x 16 tile of the ring) and .x4 .trans (B
// fragments of two n8 tiles from w's rows), and mma.sync m16n8k16 with bf16
// inputs and fp32 sums.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

constexpr int TILE_M = 128;        // output pixels a tile (conv2d.py)
constexpr int STRIP = 64;          // output channels a strip
constexpr int KS = 32;             // K a stage: four 8-channel chunks
constexpr int ALD = KS + 8;        // ring row (80 bytes)
constexpr int WLD = STRIP + 8;     // w / staging row (144 bytes)
constexpr int SLOTS = 3;           // ring depth
constexpr int NTHREADS = 256;      // 8 warps
constexpr int MIN_BLOCKS = 3;      // blocks an SM (<= 85 registers)
constexpr int GRID_BLOCKS = 3;     // blocks an SM in the grid at most
constexpr int K_MAX = 576;         // conv2d.py MID_CI_K_MAX
constexpr int ANY_ACT = -1;        // the act read at run time

struct Params {
  const bf16* x;
  const bf16* w;
  Epilogue epi;
  bf16* out;
  int N, H, W, CI, CO, KH, KW, stride, pad_t, pad_l, Ho, Wo;
  int K, KP, nst;        // taps; padded to the stage; stages
  int M, mtiles, nstrips;
};

// A thread's pixel of the tile being loaded: its input corner and the
// element offset of that corner in x (outside x for a corner in the
// padding; only valid taps are read).
struct Pix {
  long long base;
  int ih0, iw0;
  bool ok;
};

__device__ __forceinline__ Pix pixel_of(const Params& p, int m) {
  Pix r;
  r.ok = m < p.M;
  const int mm = r.ok ? m : 0;
  const int hw = p.Ho * p.Wo;
  const int n = mm / hw, rem = mm - n * hw;
  const int oh = rem / p.Wo, ow = rem - oh * p.Wo;
  r.ih0 = oh * p.stride - p.pad_t;
  r.iw0 = ow * p.stride - p.pad_l;
  r.base = ((long long)(n * p.H + r.ih0) * p.W + r.iw0) * p.CI;
  return r;
}

// Stage st of a tile into a ring slot [TILE_M][ALD]: thread t copies chunk
// t % 4 of pixel rows t / 4 and t / 4 + 64 (a warp 8 rows' whole 64-byte
// stage rows a copy); kmap[j] = (dh, dw, offset, in K) of chunk j.
__device__ __forceinline__ void load_stage(const Params& p, const int4* kmap,
                                           const Pix (&px)[2], int st,
                                           bf16* slot) {
  const int c = threadIdx.x & 3;
  const int4 ch = kmap[st * (KS / 8) + c];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int row = (threadIdx.x >> 2) + 64 * u;
    const int ih = px[u].ih0 + ch.x, iw = px[u].iw0 + ch.y;
    const bool ok = px[u].ok && ch.w != 0 && (unsigned)ih < (unsigned)p.H &&
                    (unsigned)iw < (unsigned)p.W;
    cp_async16(slot + row * ALD + c * 8,
               ok ? p.x + (px[u].base + ch.z) : p.x, ok ? 16 : 0);
  }
}

// The epilogue of one fp32 sum of strip channel c: Epilogue::finish's
// arithmetic on the block's staged fold, the act a template constant.
template <int ACT>
__device__ __forceinline__ float finish(const Params& p,
                                        const EpilogueCols<STRIP>* cols,
                                        float v, int c) {
  if (p.epi.scale != nullptr) v = (v - cols->mean[c]) * cols->f[c];
  if (p.epi.bias != nullptr) v += cols->bias[c];
  return apply_act(v, ACT == ANY_ACT ? p.epi.act : ACT);
}

// NST > 0: K is NST 32-deep stages (the path's 1); 0: p.nst, a loop.
template <int NST, int ACT>
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
conv_mid_ci(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ws = reinterpret_cast<bf16*>(smem);             // [KP][WLD]
  bf16* as = ws + p.KP * WLD;                           // [SLOTS][TILE_M][ALD]
  bf16* os = as + SLOTS * TILE_M * ALD;                 // [TILE_M][WLD]
  int4* kmap = reinterpret_cast<int4*>(os + TILE_M * WLD);  // [KP / 8]
  auto* cols = reinterpret_cast<EpilogueCols<STRIP>*>(kmap + p.KP / 8);

  const int nst = NST > 0 ? NST : p.nst;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // the grid is a multiple of the strips: a block keeps one strip and walks
  // M tiles mt0, mt0 + groups, ...
  const int n0 = (blockIdx.x % p.nstrips) * STRIP;
  const int groups = gridDim.x / p.nstrips;
  const int mt0 = blockIdx.x / p.nstrips;
  const int ntiles = mt0 < p.mtiles ? (p.mtiles - mt0 + groups - 1) / groups
                                    : 0;
  const int jobs = ntiles * nst;            // (tile, stage) pairs in order

  for (int j = tid; j < p.KP / 8; j += NTHREADS) {
    int4 c = make_int4(0, 0, 0, 0);
    const int k = j * 8;
    if (k < p.K) {
      const int tap = k / p.CI, ci = k - tap * p.CI;
      const int dh = tap / p.KW, dw = tap - dh * p.KW;
      c = make_int4(dh, dw, (dh * p.W + dw) * p.CI + ci, 1);
    }
    kmap[j] = c;
  }
  __syncthreads();                          // the chunk map, for the loads

  // w's strip (the oldest cp.async group), then the first SLOTS - 1 jobs,
  // all in flight together; the fold's columns meanwhile
  for (int i = tid; i < p.KP * (STRIP / 8); i += NTHREADS) {
    const int k = i >> 3, c = (i & 7) * 8;
    const bool ok = k < p.K && n0 + c < p.CO;     // CO % 8 == 0
    cp_async16(ws + k * WLD + c, ok ? p.w + (size_t)k * p.CO + n0 + c : p.w,
               ok ? 16 : 0);
  }
  cp_async_commit();

  // the loads run SLOTS - 1 jobs ahead of the products
  int ld_q = 0, ld_st = 0, ld_t = 0;
  Pix px[2];
  auto issue = [&]() {
    if (ld_q < jobs) {
      if (ld_st == 0) {
        const int m = (mt0 + ld_t * groups) * TILE_M + (tid >> 2);
        px[0] = pixel_of(p, m);
        px[1] = pixel_of(p, m + 64);
      }
      load_stage(p, kmap, px, ld_st, as + (ld_q % SLOTS) * TILE_M * ALD);
      if (++ld_st == nst) {
        ld_st = 0;
        ++ld_t;
      }
    }
    ++ld_q;
    cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < SLOTS - 1; ++s) issue();
  cols->stage(p.epi, n0, p.CO);

  const int g = lane >> 2, q = lane & 3;
  // ldmatrix rows of this lane: A pixel row 16 warp + lane % 16, K column
  // (lane / 16) 8; B k row (lane / 8 % 2) 8 + lane % 8, channel (lane / 16) 8
  const int aoff = (warp * 16 + (lane & 15)) * ALD + (lane >> 4) * 8;
  const bf16* wl = ws + (((lane >> 3) & 1) * 8 + (lane & 7)) * WLD +
                   (lane >> 4) * 8;
  float acc[STRIP / 8][4];
#pragma unroll
  for (int j = 0; j < STRIP / 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;

  int st = 0, t = 0;
  for (int jq = 0; jq < jobs; ++jq) {
    cp_async_wait<SLOTS - 2>();             // w and job jq have landed
    __syncthreads();                        // ... for all; slot jq-1 free
    issue();
    const bf16* a_s = as + (jq % SLOTS) * TILE_M * ALD + aoff;
#pragma unroll
    for (int kk = 0; kk < KS; kk += 16) {
      uint32_t a[4];
      ldsm_x4(a, a_s + kk);
      const bf16* wk = wl + (st * KS + kk) * WLD;
#pragma unroll
      for (int j = 0; j < STRIP / 16; ++j) {
        uint32_t b[4];
        ldsm_x4_trans(b, wk + j * 16);
        mma_16816(acc[2 * j], a, b[0], b[1]);
        mma_16816(acc[2 * j + 1], a, b[2], b[3]);
      }
    }
    if (++st < nst) continue;

    // the tile's last stage: fold and act into the warp's 16 staging rows
    // (pixel 16 warp + g (+ 8), channels 8 j + 2 q, + 1), then the warp
    // writes them out as whole rows; the next write to them follows the
    // next job's barrier
    st = 0;
    const int m0 = (mt0 + t * groups) * TILE_M + warp * 16;
    ++t;
#pragma unroll
    for (int j = 0; j < STRIP / 8; ++j) {
      const int c = j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = warp * 16 + g + 8 * h;
        const float v0 = finish<ACT>(p, cols, acc[j][2 * h], c);
        const float v1 = finish<ACT>(p, cols, acc[j][2 * h + 1], c + 1);
        *reinterpret_cast<__nv_bfloat162*>(os + pix * WLD + c) =
            __floats2bfloat162_rn(v0, v1);
        acc[j][2 * h] = 0.0f;
        acc[j][2 * h + 1] = 0.0f;
      }
    }
    __syncwarp();
    const int cpp = min(STRIP, p.CO - n0) >> 3;     // 16-byte chunks a pixel
    for (int i = lane; i < 16 * cpp; i += 32) {
      const int r = cpp == STRIP / 8 ? i >> 3 : i / cpp;
      const int c = (i - r * cpp) * 8;
      if (m0 + r < p.M)
        *reinterpret_cast<uint4*>(p.out + (size_t)(m0 + r) * p.CO + n0 + c) =
            *reinterpret_cast<const uint4*>(os + (warp * 16 + r) * WLD + c);
    }
  }
  cp_async_wait<0>();
}

size_t smem_bytes(int KP) {
  return (size_t)KP * WLD * 2 + (size_t)SLOTS * TILE_M * ALD * 2 +
         (size_t)TILE_M * WLD * 2 + (size_t)(KP / 8) * 16 +
         sizeof(EpilogueCols<STRIP>);
}

// One launch: GRID_BLOCKS blocks an SM, or as many as fit if fewer, at most
// one a tile, rounded down to a multiple of the strips (conv2d.py
// mid_ci_grid).  The shared-memory opt-in is raised when a launch needs more
// than any before it; the occupancy is recomputed when the shared bytes
// change.
template <void (*KERN)(Params)>
int launch(const Params& p, cudaStream_t stream) {
  static size_t opted = 0, last = 0;
  static int per_sm = 0, sms = 0;
  const size_t smem = smem_bytes(p.KP);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem != last) {
    cudaError_t e = cudaSuccess;
    if (smem > opted) {
      e = cudaFuncSetAttribute(
          KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e == cudaSuccess) opted = smem;
    }
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERN,
                                                        NTHREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    last = smem;
  }
  int grid = min(min(GRID_BLOCKS, per_sm) * sms, p.mtiles * p.nstrips);
  grid = max(p.nstrips, grid / p.nstrips * p.nstrips);
  KERN<<<grid, NTHREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  x (N, H, W, CI), w
// (KH, KW, CI, CO) and out (N, Ho, Wo, CO) bf16, 16-byte aligned; the four
// batch-norm pointers all null when the conv has none.  The wrapper checks
// the rule (8 <= CI < 64, CI and CO multiples of 8, K <= K_MAX, aligned);
// this checks it again.  Returns the first CUDA error of the launch, or 0.
extern "C" int conv2d_mid_ci(const void* x, const void* w, const float* scale,
                             const float* bias, const float* mean,
                             const float* var, void* out, int N, int H, int W,
                             int CI, int CO, int KH, int KW, int stride,
                             int pad_t, int pad_l, int Ho, int Wo, int act,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(w),
           rt::Epilogue{bias, scale, mean, var, act, 0},
           static_cast<bf16*>(out), N, H, W, CI, CO, KH, KW, stride, pad_t,
           pad_l, Ho, Wo};
  p.K = KH * KW * CI;
  p.KP = (p.K + KS - 1) / KS * KS;
  p.nst = p.KP / KS;
  p.M = N * Ho * Wo;
  p.mtiles = (p.M + TILE_M - 1) / TILE_M;
  p.nstrips = (CO + STRIP - 1) / STRIP;
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(w) |
                          reinterpret_cast<uintptr_t>(out);
  if (CI < 8 || CI >= 64 || CI % 8 != 0 || CO % 8 != 0 || p.K > K_MAX ||
      (align & 15) != 0 || p.M <= 0)
    return (int)cudaErrorInvalidValue;
  if (p.nst == 1 && act == kRelu)
    return launch<conv_mid_ci<1, kRelu>>(p, s);
  if (p.nst == 1 && act == kIdentity)
    return launch<conv_mid_ci<1, kIdentity>>(p, s);
  return launch<conv_mid_ci<0, ANY_ACT>>(p, s);
}
