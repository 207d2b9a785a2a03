// flash_attention_ffma: the fp32 schedule of flash_attention at head widths
// 64, 128 and 256, full fp32 FMAs on the CUDA cores (no TF32 and no 3xTF32,
// so the fp32 parity of 1e-5 and the fp32 greedy-token identity hold).
// Replaces the Pallas kernel flash_attention of
// src/repro/kernels/attention.py:93 for fp32 operands; the wrapper, the
// schedule choice and the plain version it is held against are in
// src/repro_torch/kernels/attention.py (head widths 16 and 32 stay on the
// SIMT kernel of flash_attention.cu, bf16 at 64-256 on
// flash_attention_wgmma.cu).
//
// What bounds it on the H100: the operations.  At llama3.2-1b's prefill
// (B 8 x S 512, 32 heads over 8 KV heads of 64, causal) a call does ~8.6
// GFLOP of products against ~84 MB of q, k, v and out in fp32: ~100
// operations a byte, far above the ridge of fp32 outside the tensor cores
// (67 TFLOP/s over 3.35 TB/s, ~20).  So the FMA pipes have to stay busy:
// many FMAs a shared-memory load, and the next tiles' loads in flight while
// this tile's products run.
//
// The design: one block of 256 threads (a 16 x 16 grid, ty = tid / 16,
// tx = tid % 16) per (BQ query rows, head, batch row), blocks in a 1-D grid
// whose query tile varies slowest and runs from the last: under causal the
// tiles with the most keys go out first, the G heads of a KV head next to
// each other.  Q (BQ x D) comes in once by 16-byte cp.async.cg into a
// padded row-major tile (rows of D + 4 floats); K and V come in 64-key
// tiles (K_0, V_0, K_1, V_1, ...) through a ring of SLOTS slots of the same
// shape, each tile one cp.async group, SLOTS - 1 of them in flight while the
// next is used, with the K tile's key positions (4-byte cp.async) beside
// it.  No per-element index arithmetic and no transposed scalar stores.
// A thread owns query rows 4 ty .. 4 ty + 3 (and + 64 where BQ is 128),
// keys tx + 16 j of a tile and output columns 64 g + 4 tx .. + 3:
//   S = Q K^T  an "NT" product: per 4-deep step of D a thread reads its
//              rows and its 4 keys as float4s along D (a half-warp reads 16
//              consecutive K rows of stride D + 4: no bank conflict; the
//              two half-warps read the same ones) and does RM x 16 FMAs;
//   in registers: the scale (a power of two at 64 and 256), the softcap,
//              the positional mask (key pos >= 0, <= query pos under
//              causal, > query pos - window) only on the tiles that need
//              one (padding or keys past Skv, the causal diagonal, the
//              window's edge: exact in index space under the positions
//              contract), the online max over the 16 lanes of a row (one
//              half-warp), the exponentials, the row sums kept per thread
//              until the end, O rescaled;
//   P          written once to a padded row-major tile (rows of 68 floats);
//   O += P V   the matmul form: per 4 keys a thread reads its rows of P as
//              float4s and V's rows as float4 column groups 64 apart (a
//              warp's V reads are conflict-free), RM x D / 16 x 4 FMAs.
// Tiles dead in index space (above the causal diagonal or wholly outside
// the window) are never loaded, as in the Pallas kernel.  The epilogue
// divides by max(l, 1e-30) and writes rows < Sq as float4s.  No atomics:
// the same inputs give the same bits on every run.
//
// Tiles by head width and query rows (Cfg; BQ is the plan's tile,
// plan.tiles["attention"][0], which kernels/attention.py hands down, by
// default its FFMA_TILES entry): D 64 takes 64 query rows (4 a thread, 16
// output accumulators) and 105,472 bytes of shared memory, two blocks an SM
// at up to 128 registers a thread; D 128 128 rows (8 a thread, 64
// accumulators) and 204,544 bytes, D 256 64 rows (4 a thread, 64
// accumulators) and 217,600 bytes, one block an SM under the 232,448 a
// block may opt in to; the ring has 4, 3 and 2 slots.  The other tiles
// the kernel takes: D 64 at 128 rows (3 slots, 122,624 bytes) and D 128 at
// 64 rows (3 slots, 153,344 bytes), one block an SM.  D 256 at 128 rows
// would need 301,568 bytes even at 2 slots: no such tile.
#include <climits>
#include <cmath>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int BK = 64;            // keys a K or V tile
constexpr int KN = BK / 16;       // keys a thread: tx + 16 j
constexpr int PLD = BK + 4;       // padded P row (floats)
constexpr float NEG = -1e30f;

// Per head width and query rows a block: the ring's slots, the blocks an
// SM (two at D 64 and 64 rows: at most 128 registers a thread) and the
// unroll of Q K^T's 4-deep steps (2 at D 64, where 4 spills at 128
// registers)
template <int D, int BQ> struct Cfg;
template <> struct Cfg<64, 64> {
  static constexpr int SLOTS = 4, MINB = 2, UNROLL = 2;
};
template <> struct Cfg<64, 128> {
  static constexpr int SLOTS = 3, MINB = 1, UNROLL = 4;
};
template <> struct Cfg<128, 64> {
  static constexpr int SLOTS = 3, MINB = 1, UNROLL = 4;
};
template <> struct Cfg<128, 128> {
  static constexpr int SLOTS = 3, MINB = 1, UNROLL = 4;
};
template <> struct Cfg<256, 64> {
  static constexpr int SLOTS = 2, MINB = 1, UNROLL = 4;
};

template <int D, int BQ_>
struct Layout {
  static constexpr int BQ = BQ_, SLOTS = Cfg<D, BQ_>::SLOTS;
  static constexpr int LD = D + 4;                  // padded Q, K, V row
  static constexpr int Q_FLOATS = BQ * LD;
  static constexpr int SLOT_FLOATS = BK * LD + BK;  // a tile, its key positions
  static constexpr int P_FLOATS = BQ * PLD;
  static constexpr int SMEM_BYTES =
      (Q_FLOATS + SLOTS * SLOT_FLOATS + P_FLOATS) * 4;
};
// kernels/attention.py FFMA_TILES, FFMA_RING and _ffma_smem_bytes state
// the same
static_assert(Layout<64, 64>::SMEM_BYTES == 105472, "D 64 shared bytes");
static_assert(Layout<128, 128>::SMEM_BYTES == 204544, "D 128 shared bytes");
static_assert(Layout<256, 64>::SMEM_BYTES == 217600, "D 256 shared bytes");
static_assert(Layout<64, 128>::SMEM_BYTES == 122624, "D 64 x 128 bytes");
static_assert(Layout<128, 64>::SMEM_BYTES == 153344, "D 128 x 64 bytes");
static_assert(Layout<256, 64>::SMEM_BYTES <= 232448, "one block an SM");
static_assert(2 * (Layout<64, 64>::SMEM_BYTES + 1024) <= 233472,
              "two an SM");

// 4 bytes global -> shared; src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Row ii of a thread's patch within the block's query tile: rows 4 ty ..
// 4 ty + 3, and 64 + the same for ii >= 4.
__device__ __forceinline__ int patch_row(int ii) {
  return (ii >> 2) * 64 + (threadIdx.x >> 4) * 4 + (ii & 3);
}

template <int D, int BQ_>
__global__ void __launch_bounds__(THREADS, Cfg<D, BQ_>::MINB)
flash_ffma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const int* __restrict__ qpos,
                  const int* __restrict__ kpos, float* __restrict__ out,
                  int B, int Sq, int Skv, int H, int KV, int causal,
                  int window, float softcap, int q_offset, float scale) {
  using L = Layout<D, BQ_>;
  constexpr int BQ = L::BQ, SLOTS = L::SLOTS, LD = L::LD;
  constexpr int RM = BQ / 16;     // query rows a thread
  constexpr int DN = D / 16;      // output columns a thread
  constexpr int CH = D / 4;       // 16-byte chunks of a row
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + L::Q_FLOATS;
  float* Ps = ring + SLOTS * L::SLOT_FLOATS;

  const int tid = threadIdx.x, tx = tid & 15, lane = tid & 31;
  // heaviest first: the query tile varies slowest and runs from the last
  const int nq = (Sq + BQ - 1) / BQ, per = H * B;
  const int q0 = (nq - 1 - (int)(blockIdx.x / per)) * BQ;
  const int h = (int)(blockIdx.x % per) % H, b = (int)(blockIdx.x % per) / H;
  const int kvh = h / (H / KV);

  // the live key tiles [kb, ke) of the block's rows (index space)
  const int q_lo = q0 + q_offset, nk = (Skv + BK - 1) / BK;
  const int ke = causal ? min(nk, (q_lo + BQ - 1) / BK + 1) : nk;
  int kb = 0;
  if (window > 0) {
    const int lo = q_lo - window + 2 - BK;   // the first k0 with a live key
    kb = lo > 0 ? (lo + BK - 1) / BK : 0;
  }
  const int nsteps = 2 * max(ke - kb, 0);   // K and V of each live tile

  const size_t krow = (size_t)KV * D;        // a key's stride in k and v
  const float* kbase = k + (size_t)b * Skv * krow + (size_t)kvh * D;
  const float* vbase = v + (size_t)b * Skv * krow + (size_t)kvh * D;
  // step st brings K (st even) or V (st odd) of tile kb + st / 2 into slot
  auto load = [&](int st, int slot) {
    const int k0 = (kb + (st >> 1)) * BK;
    float* dst = ring + slot * L::SLOT_FLOATS;
    const float* src = (st & 1) ? vbase : kbase;
#pragma unroll
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / CH, c = 4 * (i % CH);
      const bool ok = k0 + r < Skv;
      rt::cp_async16(dst + r * LD + c, ok ? src + (k0 + r) * krow + c : src,
                     ok ? 16 : 0);
    }
    if (!(st & 1) && kpos != nullptr && tid < BK) {
      const bool ok = k0 + tid < Skv;
      cp_async4(dst + BK * LD + tid,
                ok ? kpos + (size_t)b * Skv + k0 + tid : kpos, ok ? 4 : 0);
    }
  };

  // Q once, in the first group
  {
    const size_t qrow = (size_t)H * D;
    const float* qbase = q + (size_t)b * Sq * qrow + (size_t)h * D;
#pragma unroll
    for (int it = 0; it < BQ * CH / THREADS; ++it) {
      const int i = tid + it * THREADS, r = i / CH, c = 4 * (i % CH);
      const bool ok = q0 + r < Sq;
      rt::cp_async16(Qs + r * LD + c, ok ? qbase + (q0 + r) * qrow + c : qbase,
                     ok ? 16 : 0);
    }
  }
#pragma unroll
  for (int s = 0; s < SLOTS - 1; ++s) {
    if (s < nsteps) load(s, s);
    rt::cp_async_commit();
  }

  int qp[RM];                                // the rows' query positions
#pragma unroll
  for (int ii = 0; ii < RM; ++ii) {
    const int row = q0 + patch_row(ii);
    qp[ii] = row >= Sq ? 0
             : qpos != nullptr ? qpos[(size_t)b * Sq + row]
                               : row + q_offset;
  }
  float o[RM][DN], m[RM], l[RM];
#pragma unroll
  for (int ii = 0; ii < RM; ++ii) {
    m[ii] = NEG;
    l[ii] = 0.0f;
#pragma unroll
    for (int c = 0; c < DN; ++c) o[ii][c] = 0.0f;
  }

  for (int st = 0; st < nsteps; ++st) {
    rt::cp_async_wait<SLOTS - 2>();          // step st has landed
    __syncthreads();                         // ... for all; slot st-1 free
    const int nx = st + SLOTS - 1;
    if (nx < nsteps) load(nx, nx % SLOTS);
    rt::cp_async_commit();

    const float* tile = ring + (st % SLOTS) * L::SLOT_FLOATS;
    const int k0 = (kb + (st >> 1)) * BK;
    if (!(st & 1)) {
      // S = Q K^T over D in 4-deep steps
      float s[RM][KN];
#pragma unroll
      for (int ii = 0; ii < RM; ++ii)
#pragma unroll
        for (int j = 0; j < KN; ++j) s[ii][j] = 0.0f;
#pragma unroll Cfg<D, BQ_>::UNROLL
      for (int d = 0; d < D; d += 4) {
        float4 a[RM], kk[KN];
#pragma unroll
        for (int ii = 0; ii < RM; ++ii)
          a[ii] = *reinterpret_cast<const float4*>(Qs + patch_row(ii) * LD + d);
#pragma unroll
        for (int j = 0; j < KN; ++j)
          kk[j] = *reinterpret_cast<const float4*>(tile + (tx + 16 * j) * LD + d);
#pragma unroll
        for (int ii = 0; ii < RM; ++ii)
#pragma unroll
          for (int j = 0; j < KN; ++j) {
            s[ii][j] = fmaf(a[ii].x, kk[j].x, s[ii][j]);
            s[ii][j] = fmaf(a[ii].y, kk[j].y, s[ii][j]);
            s[ii][j] = fmaf(a[ii].z, kk[j].z, s[ii][j]);
            s[ii][j] = fmaf(a[ii].w, kk[j].w, s[ii][j]);
          }
      }
#pragma unroll
      for (int ii = 0; ii < RM; ++ii)
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          float x = s[ii][j] * scale;
          if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
          s[ii][j] = x;
        }

      // the mask, on the tiles that need one
      const int* kp_s = reinterpret_cast<const int*>(tile + BK * LD);
      bool need = k0 + BK > Skv || (causal && k0 + BK - 1 > q_lo) ||
                  (window > 0 && k0 <= q_lo + BQ - 1 - window);
      if (kpos != nullptr)
        need = __any_sync(0xffffffffu,
                          need || kp_s[lane] < 0 || kp_s[lane + 32] < 0);
      if (need) {
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          const int key = k0 + tx + 16 * j;
          const int kp = key >= Skv ? -1
                         : kpos != nullptr ? kp_s[tx + 16 * j] : key;
#pragma unroll
          for (int ii = 0; ii < RM; ++ii) {
            bool ok = kp >= 0;
            if (causal) ok = ok && kp <= qp[ii];
            if (window > 0) ok = ok && kp > qp[ii] - window;
            if (!ok) s[ii][j] = NEG;
          }
        }
      }

      // the online softmax: a row's 16 lanes are one half-warp
#pragma unroll
      for (int ii = 0; ii < RM; ++ii) {
        float mt = s[ii][0];
#pragma unroll
        for (int j = 1; j < KN; ++j) mt = fmaxf(mt, s[ii][j]);
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
        const float m_new = fmaxf(m[ii], mt);
        const float alpha = expf(m[ii] - m_new);
        m[ii] = m_new;
        float rs = 0.0f;
#pragma unroll
        for (int j = 0; j < KN; ++j) {
          s[ii][j] = expf(s[ii][j] - m_new);
          rs += s[ii][j];
        }
        l[ii] = l[ii] * alpha + rs;
#pragma unroll
        for (int c = 0; c < DN; ++c) o[ii][c] *= alpha;
      }
      // P to shared memory: a half-warp writes 16 consecutive floats of a
      // row, the other half-warp the row 4 below (68 x 4 floats apart: the
      // other 16 banks)
#pragma unroll
      for (int ii = 0; ii < RM; ++ii)
#pragma unroll
        for (int j = 0; j < KN; ++j)
          Ps[patch_row(ii) * PLD + tx + 16 * j] = s[ii][j];
    } else {
      // O += P V over the tile's keys in 4-key steps (P is visible: the
      // step began with a barrier)
      const int tx4 = 4 * tx;
#pragma unroll 2
      for (int kq = 0; kq < BK; kq += 4) {
        float4 p[RM];
#pragma unroll
        for (int ii = 0; ii < RM; ++ii)
          p[ii] = *reinterpret_cast<const float4*>(Ps + patch_row(ii) * PLD + kq);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float vv[DN];
#pragma unroll
          for (int g = 0; g < DN / 4; ++g) {
            const float4 t = *reinterpret_cast<const float4*>(
                tile + (kq + kk) * LD + 64 * g + tx4);
            vv[4 * g] = t.x;
            vv[4 * g + 1] = t.y;
            vv[4 * g + 2] = t.z;
            vv[4 * g + 3] = t.w;
          }
#pragma unroll
          for (int ii = 0; ii < RM; ++ii) {
            const float pv = rt::float4_at(p[ii], kk);
#pragma unroll
            for (int c = 0; c < DN; ++c) o[ii][c] = fmaf(pv, vv[c], o[ii][c]);
          }
        }
      }
    }
  }
  rt::cp_async_wait<0>();

  // epilogue: the row sums across the row's 16 lanes, O / max(l, 1e-30)
#pragma unroll
  for (int ii = 0; ii < RM; ++ii) {
    float den = l[ii];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      den += __shfl_xor_sync(0xffffffffu, den, off);
    den = fmaxf(den, 1e-30f);
    const int row = q0 + patch_row(ii);
    if (row >= Sq) continue;
    float* orow = out + ((size_t)(b * Sq + row) * H + h) * D + 4 * tx;
#pragma unroll
    for (int g = 0; g < DN / 4; ++g)
      *reinterpret_cast<float4*>(orow + 64 * g) =
          make_float4(o[ii][4 * g] / den, o[ii][4 * g + 1] / den,
                      o[ii][4 * g + 2] / den, o[ii][4 * g + 3] / den);
  }
}

template <int D, int BQ>
int launch(const float* q, const float* k, const float* v, const int* qpos,
           const int* kpos, float* out, int B, int Sq, int Skv, int H, int KV,
           int causal, int window, float softcap, int q_offset,
           cudaStream_t stream) {
  auto kern = flash_ffma_kernel<D, BQ>;
  constexpr int smem = Layout<D, BQ>::SMEM_BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)((Sq + BQ - 1) / BQ) * H * B;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)blocks, THREADS, smem, stream>>>(
      q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap,
      q_offset, (float)(1.0 / std::sqrt((double)D)));
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  q (B, Sq, H, D),
// k and v (B, Skv, KV, D), out (B, Sq, H, D): fp32, contiguous, 16-byte
// aligned (the wrapper sees to it), D in {64, 128, 256}; qpos (B, Sq) and
// kpos (B, Skv) int32, -1 for padding, or both null for the positions of
// the indices (query i at q_offset + i, key j at j).  window 0 means none,
// softcap 0 means none.  bq: the query rows a block (the plan's tile): 64
// or 128 at D 64 and 128, 64 at D 256.  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for a shape or tile it does not
// take.
extern "C" int flash_attention_ffma(const void* q, const void* k,
                                    const void* v, const int* qpos,
                                    const int* kpos, void* out, int B, int Sq,
                                    int Skv, int H, int KV, int D, int causal,
                                    int window, float softcap, int q_offset,
                                    int bq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (D * 1000 + bq) {
    case 64064:
      return launch<64, 64>(qf, kf, vf, qpos, kpos, of, B, Sq, Skv, H, KV,
                            causal, window, softcap, q_offset, s);
    case 64128:
      return launch<64, 128>(qf, kf, vf, qpos, kpos, of, B, Sq, Skv, H, KV,
                             causal, window, softcap, q_offset, s);
    case 128064:
      return launch<128, 64>(qf, kf, vf, qpos, kpos, of, B, Sq, Skv, H, KV,
                             causal, window, softcap, q_offset, s);
    case 128128:
      return launch<128, 128>(qf, kf, vf, qpos, kpos, of, B, Sq, Skv, H, KV,
                              causal, window, softcap, q_offset, s);
    case 256064:
      return launch<256, 64>(qf, kf, vf, qpos, kpos, of, B, Sq, Skv, H, KV,
                             causal, window, softcap, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace {
template <int D, int BQ>
int tiles_of(int* t) {
  t[0] = BQ, t[1] = BK, t[2] = Cfg<D, BQ>::SLOTS, t[3] = Cfg<D, BQ>::MINB;
  t[4] = Layout<D, BQ>::SMEM_BYTES;
  return 0;
}
}  // namespace

// The tile of head width D and bq query rows as the kernel takes it:
// tiles[0..4] = query rows a block, keys a K/V tile, ring slots, blocks an
// SM, dynamic shared bytes.  Returns cudaErrorInvalidValue for a head width
// or tile it does not take.
extern "C" int flash_attention_ffma_tiles(int D, int bq, int* tiles) {
  switch (D * 1000 + bq) {
    case 64064: return tiles_of<64, 64>(tiles);
    case 64128: return tiles_of<64, 128>(tiles);
    case 128064: return tiles_of<128, 64>(tiles);
    case 128128: return tiles_of<128, 128>(tiles);
    case 256064: return tiles_of<256, 64>(tiles);
    default: return (int)cudaErrorInvalidValue;
  }
}
