// conv2d_small_ci: the `small_ci` schedule of conv2d_fused, for convs with
// few input channels (CI < 8: ResNet-34's 7x7 stride-2 stem on CI 3,
// MobileNetV1's first 3x3 stride-2 conv, LeNet-5's CI 1 and 6).  Replaces the
// Pallas kernel conv2d_fused of src/repro/kernels/conv2d.py for those convs;
// see src/repro_torch/kernels/conv2d.py for the schedule rule, the halo
// geometry (small_ci_halo, small_ci_kmap) and the plain PyTorch version it is
// held against.
//
// Same function as the other schedules: NHWC x HWIO, stride, XLA's SAME split
// (the odd row high) or VALID, fp32 sums, the batch-norm fold and the act,
// one write in x's dtype.
//
// What bounds it on the H100.  At the stem (batch 8, 224 px) K = 147 and the
// output is 8 x 112 x 112 x 64: in bf16 the 12.8 MB output is ~85% of the
// bytes and the bound (0.0046 ms) is the bytes; in fp32 the 1.89 GFLOP on
// FFMA (0.028 ms) bound it.  An im2col gather at CI 3 is the trap: a K step
// is 3 channels of a pixel, every A element a scattered 2- or 4-byte load
// behind runtime divisions, and a 7x7 stride-2 window reads each input pixel
// ~12 times.  So:
//
// - One output tile of 8 x 16 pixels of one image by 64 channels a step of a
//   persistent loop (a grid of as many blocks as the card holds at once).
//   Its input halo, ((8-1) s + kh) x ((16-1) s + kw) x CI elements (21 x 37
//   x 3 at the stem), comes into shared memory once, zeros where it falls in
//   the padding, at any 2- or 4-byte alignment of x (no padded copy in
//   memory): in bf16 a batch of element loads into registers, then stores;
//   in fp32 4-byte cp.async into a second buffer while the tile before is
//   computed.
// - The weights (K rows of 64 channels, zero rows up to the product's step)
//   come in once a block by cp.async, with the K map: koff[k] = dh HC + dw
//   CI + ci, the offset of tap k = (dh, dw, ci) from a pixel's corner in the
//   halo (HC = halo row elements), -1 for the zero rows.  The gather is then
//   halo[pixel base + koff[k]]: no division in the inner loop.
// - bf16: mma.sync m16n8k16 on the tensor cores, 8 warps, warp w one output
//   row of the tile (16 pixels, one m16 fragment) by 64 channels (8 n8
//   tiles).  A fragments gathered element by element through the K map,
//   B fragments by ldmatrix.trans from the weights' rows padded to 144
//   bytes (conflict-free); fp32 accumulators in registers.  The K steps are
//   unrolled for the path's 10 (the stem, LeNet-5's second conv) and 2
//   (MobileNetV1's and LeNet-5's first), so the next step's gather is in
//   flight during this step's products; two blocks an SM.  Not wgmma: an A
//   operand gathered at a 3-channel pitch is no canonical swizzled tile, K is
//   10 steps, and the stem is bound by its output bytes, not its products.
//   The outputs go through shared memory so that each pixel's 64 channels
//   leave as whole 128-byte rows.
// - fp32: full FP32 FMAs (no TF32), 4 warps, a thread 8 pixels of one tile
//   row by 8 channels (4 + 4, 32 apart, so that each float4 store of a warp
//   covers 128 contiguous bytes) as ffma_tile.cuh's register tile; the K map
//   read 4 taps at a time, the pixels' step (stride x CI) a constant for the
//   path's 6.
// - The epilogue is the fold staged once per block and channel tile
//   (EpilogueCols) and the act as a template constant for the path's ReLU
//   and none (read at run time for the rest), so no element runs a switch
//   on it.
#include <stdint.h>

#include "common.cuh"

namespace {

using namespace rt;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix .x4 .trans and mma.sync m16n8k16 (bf16 in, fp32 sums), volatile
// but with no memory clobber: the compiler may move the halo's shared loads
// across them and so keep the next K step's gather in flight during this
// step's products (the barriers order them against the stores).
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

constexpr int TH = 8, TW = 16;          // output tile: rows x columns
constexpr int TPIX = TH * TW;           // 128 pixels
constexpr int NCO = 64;                  // channels a tile
constexpr int WLD = NCO + 8;             // bf16 weight / staging row (144 B)
constexpr int HALO_MAX = 3072;          // conv2d.py SMALL_CI_HALO_MAX
constexpr int MMA_THREADS = 256;        // bf16: 8 warps
constexpr int MMA_MIN_BLOCKS = 2;       // bf16 blocks an SM (<= 128 regs)
constexpr int FMA_THREADS = 128;        // fp32: 4 warps
constexpr int FMA_MIN_BLOCKS = 3;       // fp32 blocks an SM (<= 170 regs)
constexpr int ANY_ACT = -1;             // the act read at run time

struct Params {
  const void* x;
  const void* w;
  Epilogue epi;
  void* out;
  int N, H, W, CI, CO, KH, KW, stride, pad_t, pad_l, Ho, Wo;
  int K, KP;             // taps; padded to the 16-deep mma step (bf16)
  int HC, HE;            // halo row elements, elements
  int tiles_h, tiles_w, tiles;
};

struct Tile {
  int n, oh0, ow0, n0;
};

__device__ __forceinline__ Tile tile_of(const Params& p, int t) {
  Tile r;
  const int tw = t % p.tiles_w;
  t /= p.tiles_w;
  const int th = t % p.tiles_h;
  t /= p.tiles_h;
  r.n = t % p.N;
  r.n0 = (t / p.N) * NCO;
  r.oh0 = th * TH;
  r.ow0 = tw * TW;
  return r;
}

// 4 bytes global -> shared, zeros when src_bytes is 0.
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// The K map and the weights of channels n0 .. n0 + 63 in shared memory:
// rows 0 .. rows - 1 of ld elements, zeros past K and CO.  16-byte cp.async
// where CO * elem is a multiple of 16 and w 16-byte aligned, 4-byte (fp32)
// otherwise, element loads for bf16 rows of odd byte alignment.
template <typename T, int NT>
__device__ void stage_weights(const Params& p, T* ws, int ld, int rows,
                              int n0) {
  const T* w = static_cast<const T*>(p.w);
  constexpr int EC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  if ((p.CO * (int)sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<uintptr_t>(w) & 15) == 0) {
    constexpr int CPR = NCO / EC;
    for (int i = tid; i < rows * CPR; i += NT) {
      const int k = i / CPR, c = (i % CPR) * EC;
      const bool ok = k < p.K && n0 + c < p.CO;
      cp_async16(ws + k * ld + c, ok ? w + (size_t)k * p.CO + n0 + c : w,
                 ok ? 16 : 0);
    }
  } else if (sizeof(T) == 4) {
    for (int i = tid; i < rows * NCO; i += NT) {
      const int k = i / NCO, c = i % NCO;
      const bool ok = k < p.K && n0 + c < p.CO;
      cp_async4z(ws + k * ld + c, ok ? w + (size_t)k * p.CO + n0 + c : w,
                 ok ? 4 : 0);
    }
  } else {
    for (int i = tid; i < rows * NCO; i += NT) {
      const int k = i / NCO, c = i % NCO;
      const bool ok = k < p.K && n0 + c < p.CO;
      ws[k * ld + c] = ok ? w[(size_t)k * p.CO + n0 + c] : from_f32<T>(0.0f);
    }
  }
  cp_async_commit();
}

template <int NT>
__device__ void stage_kmap(const Params& p, int* koff, int rows) {
  for (int k = threadIdx.x; k < rows; k += NT) {
    int o = -1;
    if (k < p.K) {
      const int tap = k / p.CI, ci = k - tap * p.CI;
      const int dh = tap / p.KW, dw = tap - dh * p.KW;
      o = dh * p.HC + dw * p.CI + ci;
    }
    koff[k] = o;
  }
}

// The bf16 tile's input halo into shared memory: a batch of E element loads
// a thread into registers (all in flight together), then the stores; zeros
// outside the image.  (A halo row starts at any 2-byte offset: no cp.async.)
__device__ void stage_halo_bf16(const Params& p, const Tile& t,
                                __nv_bfloat16* hs, float inv_hc) {
  using T = __nv_bfloat16;
  constexpr int NT = MMA_THREADS, E = HALO_MAX / NT;
  const T* x = static_cast<const T*>(p.x) + (size_t)t.n * p.H * p.W * p.CI;
  const int ih0 = t.oh0 * p.stride - p.pad_t;
  const int iw0 = t.ow0 * p.stride - p.pad_l;
  const int lo = max(0, -iw0) * p.CI;                       // valid run of
  const int hi = min(p.HC / p.CI, p.W - iw0) * p.CI;        // a halo row
  T v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = threadIdx.x + j * NT;
    v[j] = from_f32<T>(0.0f);
    if (e < p.HE) {
      const int r = __float2int_rz(((float)e + 0.5f) * inv_hc);
      const int rem = e - r * p.HC, ih = ih0 + r;
      if (ih >= 0 && ih < p.H && rem >= lo && rem < hi)
        v[j] = x[((size_t)ih * p.W + iw0) * p.CI + rem];
    }
  }
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int e = threadIdx.x + j * NT;
    if (e < p.HE) hs[e] = v[j];
  }
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo,
                                          __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ __forceinline__ __nv_bfloat16 tap(const __nv_bfloat16* hs, int pb,
                                             int o) {
  return o >= 0 ? hs[pb + o] : __ushort_as_bfloat16(0);
}

__device__ __forceinline__ bool pixel_ok(const Params& p, const Tile& t,
                                         int pix) {
  return t.oh0 + pix / TW < p.Ho && t.ow0 + pix % TW < p.Wo;
}

__device__ __forceinline__ size_t pixel_at(const Params& p, const Tile& t,
                                           int pix) {
  return ((size_t)t.n * p.Ho + t.oh0 + pix / TW) * p.Wo + t.ow0 + pix % TW;
}

// The epilogue of one fp32 sum of tile channel c: Epilogue::finish's
// arithmetic on the block's staged fold, with the act a template constant
// (the path's ReLU and none; ANY_ACT reads it at run time).
template <int ACT>
__device__ __forceinline__ float finish(const Params& p,
                                        const EpilogueCols<NCO>* cols,
                                        float v, int c) {
  if (p.epi.scale != nullptr) v = (v - cols->mean[c]) * cols->f[c];
  if (p.epi.bias != nullptr) v += cols->bias[c];
  return apply_act(v, ACT == ANY_ACT ? p.epi.act : ACT);
}

// One 16-deep K step of a warp's m16 x 64 tile: the A fragment gathered from
// the halo through the K map (rows pb0 and pb1), B by ldmatrix from the
// weights' rows k0 .. k0 + 15.
__device__ __forceinline__ void mma_kstep(
    const __nv_bfloat16* hs, const int* koff, const __nv_bfloat16* wl,
    int k0, int q, int pb0, int pb1, float (&acc)[NCO / 8][4]) {
  const int o0 = koff[k0 + 2 * q], o1 = koff[k0 + 2 * q + 1];
  const int o2 = koff[k0 + 2 * q + 8], o3 = koff[k0 + 2 * q + 9];
  uint32_t a[4];
  a[0] = pack2(tap(hs, pb0, o0), tap(hs, pb0, o1));
  a[1] = pack2(tap(hs, pb1, o0), tap(hs, pb1, o1));
  a[2] = pack2(tap(hs, pb0, o2), tap(hs, pb0, o3));
  a[3] = pack2(tap(hs, pb1, o2), tap(hs, pb1, o3));
#pragma unroll
  for (int j = 0; j < NCO / 16; ++j) {
    uint32_t b[4];
    ldsm_x4_trans(b, wl + k0 * WLD + j * 16);
    mma_16816(acc[2 * j], a, b[0], b[1]);
    mma_16816(acc[2 * j + 1], a, b[2], b[3]);
  }
}

// ------------------------------------------------------------------ bf16

// KS > 0: K is KS 16-deep steps, unrolled (the stem's 10, MobileNetV1's and
// LeNet-5's first conv's 2); KS = 0: any K, a loop.
template <int KS, int ACT>
__global__ void __launch_bounds__(MMA_THREADS, MMA_MIN_BLOCKS)
conv_small_ci_mma(const Params p) {
  using T = __nv_bfloat16;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ws = reinterpret_cast<T*>(smem);                      // [KP][WLD]
  T* os = ws + p.KP * WLD;                                 // [TPIX][WLD]
  int* koff = reinterpret_cast<int*>(os + TPIX * WLD);     // [KP]
  auto* cols = reinterpret_cast<EpilogueCols<NCO>*>(koff + p.KP);
  T* hs = reinterpret_cast<T*>(cols + 1);                  // [HE]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const float inv_hc = 1.0f / (float)p.HC;
  stage_kmap<MMA_THREADS>(p, koff, p.KP);
  // rows g and g + 8 of this warp's m16 fragment: tile row `warp`, columns
  // g and g + 8
  const int pb0 = warp * p.stride * p.HC + g * p.stride * p.CI;
  const int pb1 = pb0 + 8 * p.stride * p.CI;
  // the ldmatrix row of this lane: k row (lane / 8 % 2) 8 + lane % 8,
  // channel column (lane / 16) 8
  const T* wl = ws + (((lane >> 3) & 1) * 8 + (lane & 7)) * WLD +
                (lane >> 4) * 8;
  const bool vec_out = p.CO % 8 == 0 &&
                       (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
  int staged_n0 = -1;

  for (int ti = blockIdx.x; ti < p.tiles; ti += gridDim.x) {
    const Tile t = tile_of(p, ti);
    if (t.n0 != staged_n0) {
      __syncthreads();                  // every warp is done with ws, cols
      stage_weights<T, MMA_THREADS>(p, ws, WLD, p.KP, t.n0);
      cols->stage(p.epi, t.n0, p.CO);
      staged_n0 = t.n0;
    }
    stage_halo_bf16(p, t, hs, inv_hc);
    cp_async_wait<0>();
    __syncthreads();

    float acc[NCO / 8][4];
#pragma unroll
    for (int j = 0; j < NCO / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[j][i] = 0.0f;
    if (KS > 0) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        mma_kstep(hs, koff, wl, ks * 16, q, pb0, pb1, acc);
    } else {
      for (int k0 = 0; k0 < p.KP; k0 += 16)
        mma_kstep(hs, koff, wl, k0, q, pb0, pb1, acc);
    }

    // the epilogue into the staging rows: pixel warp * 16 + g (+ 8),
    // channels j * 8 + 2 q, + 1
#pragma unroll
    for (int j = 0; j < NCO / 8; ++j) {
      const int c = j * 8 + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pix = warp * TW + g + 8 * h;
        const float v0 = finish<ACT>(p, cols, acc[j][2 * h], c);
        const float v1 = finish<ACT>(p, cols, acc[j][2 * h + 1], c + 1);
        *reinterpret_cast<__nv_bfloat162*>(os + pix * WLD + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
    __syncthreads();
    T* out = static_cast<T*>(p.out);
    const int ncols = min(NCO, p.CO - t.n0);
    if (vec_out) {
      const int cpp = ncols / 8;                  // 16-byte chunks a pixel
      for (int i = tid; i < TPIX * cpp; i += MMA_THREADS) {
        const int pix = i / cpp, c = (i - pix * cpp) * 8;
        if (pixel_ok(p, t, pix))
          *reinterpret_cast<uint4*>(out + pixel_at(p, t, pix) * p.CO + t.n0 +
                                    c) =
              *reinterpret_cast<const uint4*>(os + pix * WLD + c);
      }
    } else {
      for (int i = tid; i < TPIX * ncols; i += MMA_THREADS) {
        const int pix = i / ncols, c = i - pix * ncols;
        if (pixel_ok(p, t, pix))
          out[pixel_at(p, t, pix) * p.CO + t.n0 + c] = os[pix * WLD + c];
      }
    }
    __syncthreads();                    // hs and os are free again
  }
}

// ------------------------------------------------------------------ fp32

// The tile's input halo into shared memory by 4-byte cp.async (zeros
// outside the image), issued without waiting: the fp32 kernel fetches the
// next tile's halo while it computes this one.
__device__ void fetch_halo_f32(const Params& p, const Tile& t, float* hs,
                               float inv_hc) {
  const float* x =
      static_cast<const float*>(p.x) + (size_t)t.n * p.H * p.W * p.CI;
  const int ih0 = t.oh0 * p.stride - p.pad_t;
  const int iw0 = t.ow0 * p.stride - p.pad_l;
  const int lo = max(0, -iw0) * p.CI;
  const int hi = min(p.HC / p.CI, p.W - iw0) * p.CI;
  for (int e = threadIdx.x; e < p.HE; e += FMA_THREADS) {
    const int r = __float2int_rz(((float)e + 0.5f) * inv_hc);
    const int rem = e - r * p.HC, ih = ih0 + r;
    const bool ok = ih >= 0 && ih < p.H && rem >= lo && rem < hi;
    cp_async4z(hs + e, ok ? x + ((size_t)ih * p.W + iw0) * p.CI + rem : x,
               ok ? 4 : 0);
  }
}

// One tap k of a thread's 8 pixels x 8 channels: the pixels' inputs at xp,
// xp + step, ... (step = stride * CI, a constant when STEP > 0), the
// channels' weights of row k.
template <int STEP>
__device__ __forceinline__ void ffma_tap(const float* xp, int step,
                                         const float4* wk, int cg,
                                         float (&acc)[8][8]) {
  const int st = STEP > 0 ? STEP : step;
  float av[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) av[i] = xp[i * st];
  const float4 b0 = wk[cg], b1 = wk[8 + cg];
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

// STEP > 0: stride * CI is STEP (6 at the stem and MobileNetV1's first
// conv), so the 8 pixels' loads take immediate offsets; 0: any.
template <int ACT, int STEP>
__global__ void __launch_bounds__(FMA_THREADS, FMA_MIN_BLOCKS)
conv_small_ci_ffma(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ws = reinterpret_cast<float*>(smem);              // [K][NCO]
  int* koff = reinterpret_cast<int*>(ws + p.K * NCO);      // [K], 4-aligned
  auto* cols = reinterpret_cast<EpilogueCols<NCO>*>(
      koff + ((p.K + 3) & ~3));
  float* halo = reinterpret_cast<float*>(cols + 1);        // [2][HE4]
  const int he4 = (p.HE + 3) & ~3;

  const int tid = threadIdx.x;
  const int cg = tid & 7, pg = tid >> 3;   // channel group, pixel group
  const int prow = pg >> 1, pcol = (pg & 1) * 8;
  const float inv_hc = 1.0f / (float)p.HC;
  stage_kmap<FMA_THREADS>(p, koff, p.K);
  const int step = p.stride * p.CI;        // a pixel's step in the halo
  const int pb = prow * p.stride * p.HC + pcol * step;
  const bool vec_out = p.CO % 4 == 0 &&
                       (reinterpret_cast<uintptr_t>(p.out) & 15) == 0;
  const float4* w4 = reinterpret_cast<const float4*>(ws);
  int staged_n0 = -1;

  if (blockIdx.x < p.tiles)
    fetch_halo_f32(p, tile_of(p, blockIdx.x), halo, inv_hc);
  cp_async_commit();
  int it = 0;
  for (int ti = blockIdx.x; ti < p.tiles; ti += gridDim.x, ++it) {
    const Tile t = tile_of(p, ti);
    if (t.n0 != staged_n0) {
      __syncthreads();                  // every warp is done with ws, cols
      stage_weights<float, FMA_THREADS>(p, ws, NCO, p.K, t.n0);
      cols->stage(p.epi, t.n0, p.CO);
      staged_n0 = t.n0;
    }
    // the next tile's halo into the other buffer, last read two barriers
    // ago
    if (ti + (int)gridDim.x < p.tiles)
      fetch_halo_f32(p, tile_of(p, ti + gridDim.x),
                     halo + ((it + 1) & 1) * he4, inv_hc);
    cp_async_commit();
    cp_async_wait<1>();                 // all but the next tile's halo
    __syncthreads();

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    const float* hp = halo + (it & 1) * he4 + pb;
    int k = 0;
#pragma unroll 1
    for (; k + 4 <= p.K; k += 4) {
      const int4 o = *reinterpret_cast<const int4*>(koff + k);
      ffma_tap<STEP>(hp + o.x, step, w4 + k * (NCO / 4), cg, acc);
      ffma_tap<STEP>(hp + o.y, step, w4 + (k + 1) * (NCO / 4), cg, acc);
      ffma_tap<STEP>(hp + o.z, step, w4 + (k + 2) * (NCO / 4), cg, acc);
      ffma_tap<STEP>(hp + o.w, step, w4 + (k + 3) * (NCO / 4), cg, acc);
    }
    for (; k < p.K; ++k)
      ffma_tap<STEP>(hp + koff[k], step, w4 + k * (NCO / 4), cg, acc);

    float* out = static_cast<float*>(p.out);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pix = prow * TW + pcol + i;
      if (!pixel_ok(p, t, pix)) continue;
      float* op = out + pixel_at(p, t, pix) * p.CO + t.n0;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = h * 32 + cg * 4;
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = finish<ACT>(p, cols, acc[i][h * 4 + u], c + u);
        if (vec_out) {
          if (t.n0 + c < p.CO)
            *reinterpret_cast<float4*>(op + c) =
                make_float4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (t.n0 + c + u < p.CO) op[c + u] = v[u];
        }
      }
    }
    __syncthreads();                    // this halo buffer is free again
  }
  cp_async_wait<0>();
}

size_t smem_bytes(const Params& p, bool bf16) {
  const size_t cols = sizeof(EpilogueCols<NCO>);
  if (bf16)
    return (size_t)p.KP * WLD * 2 + (size_t)TPIX * WLD * 2 +
           (size_t)p.KP * 4 + cols + (size_t)p.HE * 2;
  return (size_t)p.K * NCO * 4 + (size_t)((p.K + 3) & ~3) * 4 + cols +
         (size_t)2 * ((p.HE + 3) & ~3) * 4;
}

// One launch: a grid of as many blocks as the card holds at once (at most
// one a tile).  The shared-memory opt-in and the occupancy are computed
// when a launch needs more shared memory than any before it.
template <void (*KERN)(Params), int THREADS>
int launch(const Params& p, size_t smem, cudaStream_t stream) {
  static size_t opted = 0;
  static int per_sm = 0, sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (smem > opted) {
    cudaError_t e = cudaFuncSetAttribute(
        KERN, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, KERN,
                                                        THREADS, smem);
    if (e != cudaSuccess) return (int)e;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    opted = smem;
  }
  const int grid = min(p.tiles, per_sm * sms);
  KERN<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  dtype: 0 fp32,
// 1 bf16, for x, w and out alike; the four batch-norm pointers all null
// when the conv has none.  The wrapper checks the rule (CI < 8, K <= 256,
// the halo within HALO_MAX elements); this checks it again.  Returns the
// first CUDA error of the launch, or 0.
extern "C" int conv2d_small_ci(int dtype, const void* x, const void* w,
                               const float* scale, const float* bias,
                               const float* mean, const float* var,
                               void* out, int N, int H, int W, int CI,
                               int CO, int KH, int KW, int stride, int pad_t,
                               int pad_l, int Ho, int Wo, int act,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  Params p{x, w, rt::Epilogue{bias, scale, mean, var, act, 0}, out, N, H, W,
           CI, CO, KH, KW, stride, pad_t, pad_l, Ho, Wo};
  p.K = KH * KW * CI;
  p.KP = (p.K + 15) / 16 * 16;
  p.HC = ((TW - 1) * stride + KW) * CI;
  p.HE = ((TH - 1) * stride + KH) * p.HC;
  p.tiles_h = (Ho + TH - 1) / TH;
  p.tiles_w = (Wo + TW - 1) / TW;
  p.tiles = N * p.tiles_h * p.tiles_w * ((CO + NCO - 1) / NCO);
  if (p.K > 256 || p.HE > HALO_MAX || p.tiles <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kBF16) {
    const size_t smem = smem_bytes(p, true);
    const int ks = p.KP / 16;
    if (ks == 10 && act == kRelu)
      return launch<conv_small_ci_mma<10, kRelu>, MMA_THREADS>(p, smem, s);
    if (ks == 10 && act == kIdentity)
      return launch<conv_small_ci_mma<10, kIdentity>, MMA_THREADS>(p, smem,
                                                                   s);
    if (ks == 2 && act == kRelu)
      return launch<conv_small_ci_mma<2, kRelu>, MMA_THREADS>(p, smem, s);
    if (ks == 2 && act == kIdentity)
      return launch<conv_small_ci_mma<2, kIdentity>, MMA_THREADS>(p, smem,
                                                                  s);
    return launch<conv_small_ci_mma<0, ANY_ACT>, MMA_THREADS>(p, smem, s);
  }
  if (dtype == rt::kF32) {
    const size_t smem = smem_bytes(p, false);
    if (stride * CI == 6 && act == kRelu)
      return launch<conv_small_ci_ffma<kRelu, 6>, FMA_THREADS>(p, smem, s);
    if (stride * CI == 6 && act == kIdentity)
      return launch<conv_small_ci_ffma<kIdentity, 6>, FMA_THREADS>(p, smem,
                                                                   s);
    return launch<conv_small_ci_ffma<ANY_ACT, 0>, FMA_THREADS>(p, smem, s);
  }
  return (int)cudaErrorInvalidValue;
}
