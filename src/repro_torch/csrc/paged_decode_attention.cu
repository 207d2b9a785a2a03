// paged_decode_attention: the query rows of q (B, Sq, H, D) over a paged KV
// pool, through the (B, nblk) block table, split over each row's live
// tokens.  Replaces the Pallas kernel paged_decode_attention of
// src/repro/kernels/decode_attention.py; see
// src/repro_torch/kernels/decode_attention.py for the design note and the
// plain PyTorch version it is held against.
//
// q and out (B, Sq, H, D), kp and vp (NB, bs, KV, D), all contiguous in one
// dtype; bt (B, nblk) int32 pool block ids; qpos (B, Sq) int32 absolute
// query positions (< 0: a padding row).  Token t of row b lives in pool
// block bt[b, t / bs] at offset t % bs.  The first kernel runs one block per
// (split, KV head x row tile, batch row): it serves up to ROWS of the
// R = Sq * H / KV query rows of its KV head (row r is query token r / G,
// head kvh * G + r % G) over its split of the tokens 0 .. max(qpos[b]), and
// writes partial (m, l, acc) to the fp32 workspace ws; the second combines
// the splits of each row.  ROWS is 64, 32 at D = 256.
#include <algorithm>
#include <cmath>

#include "common.cuh"

namespace {

using namespace rt;

constexpr int SLOTS = 64;          // tokens per tile
// query rows per block at most: at D = 256, 64 rows of q and acc beside
// the K/V tile would outgrow shared memory (kernels/decode_attention.py
// paged_rows)
template <int D>
__host__ __device__ constexpr int rows_per_block() { return D > 128 ? 32 : 64; }
constexpr int PTHREADS = 128;
constexpr int PWARPS = PTHREADS / 32;
constexpr int CTHREADS = 128;      // threads of the combining kernel
constexpr float NEG = -1e30f;

template <int D>
size_t smem_bytes(int RT) {
  // token offsets [SLOTS] (64-bit), then qs [RT][D], Ks [SLOTS][D+1],
  // Vs [SLOTS][D], Ss [RT][SLOTS], acc [RT][D], m, l, alpha [RT], then the
  // rows' positions [RT]
  return SLOTS * sizeof(long long) +
         (size_t)(RT * D + SLOTS * (D + 1) + SLOTS * D + RT * SLOTS + RT * D +
                  3 * RT) * sizeof(float) +
         RT * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(PTHREADS)
paged_partial_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                     const T* __restrict__ vp, const int* __restrict__ bt,
                     const int* __restrict__ qpos, float* __restrict__ ws,
                     int Sq, int H, int KV, int NB, int bs, int nblk,
                     int window, float softcap, int nsplit, int n_rt,
                     float scale) {
  const int split = blockIdx.x;
  const int kvh = blockIdx.y / n_rt, rt = blockIdx.y % n_rt;
  const int b = blockIdx.z;
  const int G = H / KV, R = Sq * G;
  constexpr int ROWS = rows_per_block<D>();
  const int RT = min(R, ROWS);
  const int r0 = rt * ROWS;
  const int nr = min(ROWS, R - r0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  long long* toff = reinterpret_cast<long long*>(smem_raw);
  float* qs = reinterpret_cast<float*>(toff + SLOTS);
  float* Ks = qs + RT * D;
  float* Vs = Ks + SLOTS * (D + 1);
  float* Ss = Vs + SLOTS * D;
  float* acc = Ss + RT * SLOTS;
  float* ms = acc + RT * D;
  float* ls = ms + RT;
  float* as = ls + RT;
  int* rp = reinterpret_cast<int*>(as + RT);
  __shared__ int s_live;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    int mx = -1;
    for (int c = 0; c < Sq; ++c) mx = max(mx, qpos[(size_t)b * Sq + c]);
    s_live = min(mx + 1, nblk * bs);       // tokens 0 .. max(qpos[b])
  }
  for (int idx = tid; idx < nr * D; idx += PTHREADS) {
    const int r = idx / D, d = idx % D, rg = r0 + r;
    const int c = rg / G, g = rg % G;
    qs[idx] = to_f32(q[(((size_t)b * Sq + c) * H + kvh * G + g) * D + d]) *
              scale;
    acc[idx] = 0.0f;
  }
  for (int r = tid; r < nr; r += PTHREADS) {
    ms[r] = NEG;
    ls[r] = 0.0f;
    rp[r] = qpos[(size_t)b * Sq + (r0 + r) / G];
  }
  __syncthreads();

  // this split's tokens: a whole number of tiles of the live range
  const int live = s_live;
  int per = (live + nsplit - 1) / nsplit;
  per = (per + SLOTS - 1) / SLOTS * SLOTS;
  const int t_begin = split * per;
  const int t_end = min(live, t_begin + per);
  for (int t0 = t_begin; t0 < t_end; t0 += SLOTS) {
    // resolve the tile's tokens through the block table
    for (int j = tid; j < SLOTS; j += PTHREADS) {
      const int t = t0 + j;
      long long off = -1;
      if (t < t_end) {
        const int pb = bt[(size_t)b * nblk + t / bs];
        if (pb >= 0 && pb < NB)
          off = (((long long)pb * bs + t % bs) * KV + kvh) * D;
      }
      toff[j] = off;
    }
    __syncthreads();
    for (int idx = tid; idx < SLOTS * D; idx += PTHREADS) {
      const int j = idx / D, d = idx % D;
      const long long off = toff[j];
      float kk = 0.0f, vv = 0.0f;
      if (off >= 0) {
        kk = to_f32(kp[off + d]);
        vv = to_f32(vp[off + d]);
      }
      Ks[j * (D + 1) + d] = kk;
      Vs[j * D + d] = vv;
    }
    __syncthreads();

    // scores of the block's rows against the tile, masked by position
    for (int idx = tid; idx < nr * SLOTS; idx += PTHREADS) {
      const int r = idx / SLOTS, j = idx % SLOTS, t = t0 + j;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d)
        s = fmaf(qs[r * D + d], Ks[j * (D + 1) + d], s);
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      const int qp = rp[r];
      bool ok = t < t_end && qp >= 0 && t <= qp;
      if (window > 0) ok = ok && t > qp - window;
      Ss[idx] = ok ? s : NEG;
    }
    __syncthreads();

    // online softmax: one warp per row, two tokens a lane
    for (int r = warp; r < nr; r += PWARPS) {
      float* sr = Ss + r * SLOTS;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = ms[r];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ls[r] = ls[r] * alpha + sum;
        ms[r] = m_new;
        as[r] = alpha;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < nr * D; idx += PTHREADS) {
      const int r = idx / D, d = idx % D;
      const float* pr = Ss + r * SLOTS;
      float a = acc[idx] * as[r];
#pragma unroll 8
      for (int j = 0; j < SLOTS; ++j) a = fmaf(pr[j], Vs[j * D + d], a);
      acc[idx] = a;
    }
    __syncthreads();
  }

  // partials of this split: [R] m, [R] l, [R][D] acc
  float* w = ws + (((size_t)b * KV + kvh) * nsplit + split) * R * (D + 2);
  for (int r = tid; r < nr; r += PTHREADS) {
    w[r0 + r] = ms[r];
    w[R + r0 + r] = ls[r];
  }
  for (int idx = tid; idx < nr * D; idx += PTHREADS)
    w[2 * R + (size_t)r0 * D + idx] = acc[idx];
}

template <typename T>
__global__ void __launch_bounds__(CTHREADS)
paged_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                     int Sq, int H, int KV, int D, int nsplit) {
  const int G = H / KV, R = Sq * G;
  const int kvh = blockIdx.x / R, r = blockIdx.x % R, b = blockIdx.y;
  const int c = r / G, g = r % G;
  const size_t stride = (size_t)R * (D + 2);
  const float* base = ws + ((size_t)b * KV + kvh) * nsplit * stride;
  float M = NEG;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, base[s * stride + r]);
  float L = 0.0f;
  for (int s = 0; s < nsplit; ++s)
    L += base[s * stride + R + r] * expf(base[s * stride + r] - M);
  const float den = fmaxf(L, 1e-30f);
  T* o = out + (((size_t)b * Sq + c) * H + kvh * G + g) * D;
  for (int d = threadIdx.x; d < D; d += CTHREADS) {
    float a = 0.0f;
    for (int s = 0; s < nsplit; ++s)
      a += base[s * stride + 2 * R + (size_t)r * D + d] *
           expf(base[s * stride + r] - M);
    o[d] = from_f32<T>(a / den);
  }
}

// A block's bytes at R query rows a KV head (at most ROWS a block).
template <int D>
size_t block_smem(int R) {
  constexpr int ROWS = rows_per_block<D>();
  return smem_bytes<D>(R < ROWS ? R : ROWS);
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const int* bt,
           const int* qpos, void* out, float* ws, int B, int Sq, int H,
           int KV, int NB, int bs, int nblk, int window, float softcap,
           int nsplit, cudaStream_t stream) {
  constexpr int ROWS = rows_per_block<D>();
  const int R = Sq * (H / KV);
  const int n_rt = (R + ROWS - 1) / ROWS;
  auto kern = paged_partial_kernel<T, D>;
  const size_t smem = block_smem<D>(R);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((unsigned)nsplit, (unsigned)(KV * n_rt), (unsigned)B),
         PTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), bt, qpos, ws, Sq, H, KV, NB, bs, nblk,
      window, softcap, nsplit, n_rt, (float)(1.0 / std::sqrt((double)D)));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  paged_combine_kernel<T><<<dim3((unsigned)(KV * R), (unsigned)B), CTHREADS,
                            0, stream>>>(ws, static_cast<T*>(out), Sq, H, KV,
                                         D, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* kp, const void* vp,
             const int* bt, const int* qpos, void* out, float* ws, int B,
             int Sq, int H, int KV, int NB, int bs, int nblk, int window,
             float softcap, int nsplit, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
    case 32:
      return launch<T, 32>(q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
    case 64:
      return launch<T, 64>(q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
    case 128:
      return launch<T, 128>(q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
    case 256:
      return launch<T, 256>(q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  dtype is that of q,
// kp, vp and out (0 fp32, 1 bf16); window 0 means none, softcap 0 means
// none; ws holds B * KV * nsplit * Sq * (H / KV) * (D + 2) floats.  Table
// entries outside [0, NB) read as zeros.  Returns the first CUDA error of
// the two launches, or 0.
extern "C" int paged_decode_attention(int dtype, const void* q,
                                      const void* kp, const void* vp,
                                      const int* bt, const int* qpos,
                                      void* out, float* ws, int B, int Sq,
                                      int H, int KV, int D, int NB, int bs,
                                      int nblk, int window, float softcap,
                                      int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || NB <= 0 || bs <= 0 ||
      nblk <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, kp, vp, bt, qpos, out, ws, B, Sq, H, KV, NB, bs, nblk, window, softcap, nsplit, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The "mma" (bf16) and "ffma" (fp32) schedules at head widths 64, 128 and
// 256: the split-KV core of decode_core.cuh with the pool's slot map, one
// launch a call.
// ---------------------------------------------------------------------------
#include "decode_core.cuh"

namespace {

// The slot-map ints a block of the core keeps: tmax table entries and the
// Sq query positions of its row.
int core_extra(int tmax, int Sq) { return tmax + Sq; }

int paged_core_call(int dtype, const void* q, const void* kp, const void* vp,
                    const int* bt, const int* qpos, void* out, float* ws,
                    int* tickets, int B, int Sq, int H, int KV, int D, int NB,
                    int bs, int nblk, int window, float softcap, int nsplit,
                    int min_chunk, float cfac, int tmax, void* stream) {
  if (B <= 0 || Sq <= 0 || KV <= 0 || H % KV != 0 || NB <= 0 || bs <= 0 ||
      nblk <= 0 || nsplit <= 0 || nsplit > dcore::MAX_SPLITS ||
      min_chunk <= 0 || min_chunk % dcore::TILE != 0 ||
      min_chunk > dcore::MAX_CHUNK || tmax <= 0 || !(cfac >= 0.0f) ||
      (long long)nblk * bs > 0x7fffffffLL ||
      (nsplit > 1 && (ws == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  // a split covers at most as many tokens as it would with every token
  // live: tmax must hold the table entries that cover it (or the row)
  const long long cap = (long long)nblk * bs;
  long long per = (cap + nsplit - 1) / nsplit;
  per = std::max(per, (long long)std::ceil(std::sqrt((double)cap * cfac)));
  per = (per + dcore::TILE - 1) / dcore::TILE * dcore::TILE;
  if (per < min_chunk) per = min_chunk;
  if (per > dcore::MAX_CHUNK ||
      (tmax < (per + bs - 1) / bs + 1 && tmax < nblk))
    return (int)cudaErrorInvalidValue;
  dcore::Params p{};
  p.q = q, p.k = kp, p.v = vp, p.pos = nullptr, p.bt = bt, p.qpos = qpos;
  p.out = out, p.ws = ws, p.tickets = tickets;
  p.B = B, p.Sq = Sq, p.H = H, p.KV = KV, p.C = (int)cap;
  p.NB = NB, p.bs = bs, p.nblk = nblk;
  p.window = window, p.softcap = softcap;
  p.scale = (float)(1.0 / std::sqrt((double)D));
  p.nsplit = nsplit, p.chunk = min_chunk, p.cfac = cfac;
  p.n_rt = (Sq * (H / KV) + dcore::RB - 1) / dcore::RB;
  p.extra = core_extra(tmax, Sq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return dcore::dispatch<float, dcore::PagedMap>(D, p, s);
  return dcore::dispatch<__nv_bfloat16, dcore::PagedMap>(D, p, s);
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py):
// paged_decode_attention's mma schedule (bf16) and ffma schedule (fp32).
// Operands as for paged_decode_attention above; each row's live tokens
// (those up to max(qpos[b]), none older than the youngest row's window)
// are cut into at most nsplit splits of at least min_chunk tokens (a
// multiple of 16) and at least sqrt(live tokens * cfac); tmax table
// entries cover a split (tmax >= nblk: the row's whole table); ws holds
// B * KV * n_rt * nsplit * (RT * D + 2 * RTP) floats (R = Sq * H / KV,
// n_rt = ceil(R / 16), RT = min(R, 16), RTP = RT rounded up to even) and
// tickets B * KV * n_rt zeros, left zero; both may be null with one split.
// Returns the launch's CUDA error, or 0.
extern "C" int paged_decode_attention_mma(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* qpos, void* out, float* ws, int* tickets, int B, int Sq, int H,
    int KV, int D, int NB, int bs, int nblk, int window, float softcap,
    int nsplit, int min_chunk, float cfac, int tmax, void* stream) {
  return paged_core_call(rt::kBF16, q, kp, vp, bt, qpos, out, ws, tickets, B,
                         Sq, H, KV, D, NB, bs, nblk, window, softcap, nsplit,
                         min_chunk, cfac, tmax, stream);
}

extern "C" int paged_decode_attention_ffma(
    const void* q, const void* kp, const void* vp, const int* bt,
    const int* qpos, void* out, float* ws, int* tickets, int B, int Sq, int H,
    int KV, int D, int NB, int bs, int nblk, int window, float softcap,
    int nsplit, int min_chunk, float cfac, int tmax, void* stream) {
  return paged_core_call(rt::kF32, q, kp, vp, bt, qpos, out, ws, tickets, B,
                         Sq, H, KV, D, NB, bs, nblk, window, softcap, nsplit,
                         min_chunk, cfac, tmax, stream);
}

extern "C" int decode_core_smem(int dtype, int D, int extra);

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// The mma (dtype 1) and ffma (dtype 0) schedules at Sq queries a row and
// tmax table entries (the wrapper's argument); the simt kernel at R query
// rows a KV head.
extern "C" int paged_decode_core_smem(int dtype, int D, int Sq, int tmax) {
  if (Sq < 1 || tmax < 1) return -1;
  return decode_core_smem(dtype, D, core_extra(tmax, Sq));
}

extern "C" int paged_decode_attention_simt_smem(int D, int R) {
  if (R < 1) return -1;
  switch (D) {
    case 16: return (int)block_smem<16>(R);
    case 32: return (int)block_smem<32>(R);
    case 64: return (int)block_smem<64>(R);
    case 128: return (int)block_smem<128>(R);
    case 256: return (int)block_smem<256>(R);
    default: return -1;
  }
}
