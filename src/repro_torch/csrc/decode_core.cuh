// decode_core: the split-KV decode attention core shared by decode_attention
// (the rolling cache, csrc/decode_attention.cu) and paged_decode_attention
// (the paged pool, csrc/paged_decode_attention.cu): the schedules "mma"
// (bf16, mma.sync tensor cores) and "ffma" (fp32, FFMA) at head widths 64,
// 128 and 256.  Replaces the Pallas kernels decode_attention
// (src/repro/kernels/decode_attention.py:61) and paged_decode_attention
// (:189); the wrappers, the split policy and the plain versions the kernels
// are held against are in src/repro_torch/kernels/decode_attention.py.
//
// What bounds it on the H100: the K/V bytes.  A KV head's G (or Sq x G)
// query rows do ~4 G D operations per slot against 2 D elements of K and V:
// 2-5 operations a byte in bf16 at G 4-10, far under either ridge.  At the
// main path's sizes (1-9 MB of live K/V) the whole call is a few
// microseconds at 3.35 TB/s, so latency and the grid's fill matter as much
// as the bytes: every SM needs tens of KB of loads in flight, a call must
// not pay for dead slots or a second launch, and the serial work of a
// block (its set-up, its merge, the combine) must stay short.
//
// The design, one block per (split, KV head x row tile, batch row):
// - Up to RB = 16 query rows a block (row r: query token r / G, head
//   kvh G + r % G), staged once in shared memory in their own dtype.
// - The block's split of the slots (a static chunk of the rolling cache; a
//   share of the pool's live token range [lo, hi), cut inside the kernel)
//   is walked in tiles of NS slots.  Warp w takes tiles w, w + W, ...: each
//   warp streams its tiles through its own ring of ST stages by 16-byte
//   cp.async (ST - 1 tiles in flight while one computes), and keeps its own
//   online softmax (m, l, acc) in registers.  No block barrier in the loop.
// - Slot maps (the Map policy): the rolling cache reads slot c of row b at
//   ((b C + c) KV + kvh) D and masks it by its position pos[b, c]; the pool
//   reads token t at ((bt[b, t / bs] bs + t % bs) KV + kvh) D and masks it
//   by t.  Either way a slot's key k (the position; the token) is valid for
//   a row of query position qp when k >= 0, k <= qp and, with a window,
//   k > qp - window.  The block loads the positions of its split (rolling)
//   or the table entries that cover it (paged) into shared memory with the
//   Q tile, all by cp.async, so no load waits on an index.  A rolling tile
//   none of whose slots is valid loads nothing.
// - Products (the Prod policy): "mma" multiplies Q K^T and P V with
//   mma.sync m16n8k16 (bf16 in, fp32 sums), fragments by ldmatrix from rows
//   padded by 16 bytes (conflict-free); P enters P V as bf16 hi + lo, two
//   MMAs on one V fragment, so it keeps ~16 bits as the Pallas kernel's fp32
//   p does.  "ffma" runs both products as fp32 FMAs on the same ring, no
//   TF32, for 4, 8 or 16 rows (a template, so no row branches): lanes split
//   a tile's slots (and D) for Q K^T, the output columns for P V.  Both
//   scale the fp32 scores after Q K^T (JAX's q * scale is the same number
//   at D 64 and 256, where the scale is a power of two).
// - At the end the block merges its warps' states in warp order; with one
//   split it writes the output, else its partial (m, l, acc) to the fp32
//   workspace and takes a ticket (atomicAdd after __threadfence): the last
//   block of a (row, KV head, row tile) combines the splits in split order
//   (their (m, l) pairs and acc rows brought in by cp.async together, in
//   batches when they outgrow shared memory), writes the output and resets
//   the ticket to 0.  One launch a call; no float atomics, so a
//   call's bits repeat.
// - A masked score contributes p = 0 exactly, so a row with no valid slot
//   in its whole range gets zeros (the plain versions give the mean of V
//   there, the Pallas rolling kernel sum(V[:C]) / rup(C, bk) over its
//   padded cache; the wrappers' docstrings say so).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace dcore {

constexpr int RB = 16;            // query rows a block (one m16 fragment)
constexpr int TILE = 16;          // split granularity in slots
constexpr int MAX_SPLITS = 128;   // kernels/decode_attention.py MAX_SPLITS
constexpr int MAX_CHUNK = 2048;   // slots a split at most (MAX_CHUNK)
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned FULL = 0xffffffffu;

// Per (element type, head width): W warps a block, NS slots a warp tile,
// ST ring stages a warp.  Shared bytes before the slot map's ints: 57,856 /
// 109,056 / 219,392 in bf16 at D 64 / 128 / 256 (3, 2 and 1 blocks an SM),
// 113,152 / 112,000 / 218,496 in fp32 (2, 2 and 1).  At D 256 one block of
// four warps an SM: a call with few (row, KV head) groups gets four warps
// on each of its SMs, and the combine 128 threads.
template <typename T, int D> struct Cfg;
template <> struct Cfg<__nv_bfloat16, 64> { static constexpr int W = 4, NS = 16, ST = 3; };
template <> struct Cfg<__nv_bfloat16, 128> { static constexpr int W = 4, NS = 16, ST = 3; };
template <> struct Cfg<__nv_bfloat16, 256> { static constexpr int W = 4, NS = 16, ST = 3; };
template <> struct Cfg<float, 64> { static constexpr int W = 4, NS = 16, ST = 3; };
template <> struct Cfg<float, 128> { static constexpr int W = 2, NS = 16, ST = 3; };
template <> struct Cfg<float, 256> { static constexpr int W = 4, NS = 8, ST = 3; };

// Everything a launch needs (one struct, passed by value).
struct Params {
  const void* q;        // (B, Sq, H, D)
  const void* k;        // rolling (B, C, KV, D); paged (NB, bs, KV, D)
  const void* v;
  const int* pos;       // rolling: (B, C) slot positions (-1 empty)
  const int* bt;        // paged: (B, nblk) pool block ids
  const int* qpos;      // rolling (B, 1); paged (B, Sq); < 0 a padding row
  void* out;            // (B, Sq, H, D)
  float* ws;            // acc [groups][nsplit][RT][D], then (m, l) pairs
                        // [groups][nsplit][RTP] (RTP: RT rounded up even)
  int* tickets;         // [groups], 0 between calls
  int B, Sq, H, KV;
  int C;                // rolling: slots; paged: nblk * bs
  int NB, bs, nblk;     // paged only
  int window;           // 0: none
  float softcap;        // 0: none
  float scale;
  int nsplit;
  int chunk;            // rolling: slots a split; paged: a split's least
  float cfac;           // paged: a split holds >= sqrt(live * cfac) tokens
  int n_rt;             // row tiles: ceil(Sq G / RB)
  int extra;            // shared ints of the Map's data: rolling, chunk
                        // positions; paged, the table entries (the whole
                        // row when they reach nblk), then Sq positions
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
      : "r"(smem_u32(p))
      : "memory");
}

// d (16 x 8 fp32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4],
                                          const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (x, y) as bf16 hi + lo pairs: hi = bf16(x), lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                                 y - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// 4 bytes global -> shared (an index or a position), no register waiting.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float score(float acc, float scale, float softcap) {
  float s = acc * scale;
  if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
  return s;
}

// A slot of key k (a position or a token, -1 none) for a row of query
// position qp.
__device__ __forceinline__ bool valid(int k, int qp, int window) {
  return k >= 0 && k <= qp && (window <= 0 || k > qp - window);
}

// ---------------------------------------------------------------------------
// Slot maps: start() begins the loads of the map's data (cp.async, one
// round trip with the Q tile); finish() runs once they landed and returns
// true when it began a second load; key(i), offset(i) for slot i < n of
// the split; rowq(r) the query position of the block's row r (-1 beyond).
// ---------------------------------------------------------------------------

// The rolling cache: the split is slots [s0, s0 + n) of row b; the slots'
// positions sit in shared memory.
struct RollingMap {
  const int* sp;       // positions of the split's slots (shared)
  int s0, n, qp, window, nr;
  long long row_base;  // element offset of slot 0 of (b, kvh)
  int slot_stride;     // KV * D

  __device__ __forceinline__ void start(const Params& p, int b, int kvh,
                                        int split, int D, int r0, int nr_,
                                        int* ints) {
    (void)r0;
    nr = nr_;
    qp = p.qpos[b];                     // first used after the wait
    window = p.window;
    s0 = split * p.chunk;
    n = max(0, min(p.C, s0 + p.chunk) - s0);
    slot_stride = p.KV * D;
    row_base = ((long long)b * p.C * p.KV + kvh) * D;
    const int* src = p.pos + (size_t)b * p.C + s0;
    for (int i = threadIdx.x; i < n; i += blockDim.x)
      cp_async4(ints + i, src + i);
    sp = ints;
  }
  __device__ __forceinline__ bool finish(const Params& p, int b, int split) {
    (void)p, (void)b, (void)split;
    return false;
  }
  __device__ __forceinline__ bool slot_live(int i) const {
    return valid(sp[i], qp, window);
  }
  __device__ __forceinline__ int key(int i) const { return sp[i]; }
  __device__ __forceinline__ int rowq(int r) const { return r < nr ? qp : -1; }
  __device__ __forceinline__ int offset(int i) const {
    return (int)(row_base + (long long)(s0 + i) * slot_stride);
  }
};

// The paged pool: the split is tokens [s0, s0 + n) of row b's live range;
// the table entries that cover it and row b's query positions sit in
// shared memory (ints: the table, then the Sq positions).
struct PagedMap {
  int* tb;             // bt[b, blk0 ..] (shared)
  const int* qrow;     // qpos[b, 0 .. Sq) (shared)
  int s0, n, blk0, bs, NB, window, kvh, KV, D, G, r0, nr;
  bool whole;

  __device__ __forceinline__ void start(const Params& p, int b, int kvh_,
                                        int split, int D_, int r0_, int nr_,
                                        int* ints) {
    (void)split;
    kvh = kvh_, KV = p.KV, D = D_, bs = p.bs, NB = p.NB, window = p.window;
    G = p.H / p.KV, r0 = r0_, nr = nr_;
    const int tmax = p.extra - p.Sq;
    tb = ints;
    int* qr = ints + tmax;
    qrow = qr;
    const int* qsrc = p.qpos + (size_t)b * p.Sq;
    for (int i = threadIdx.x; i < p.Sq; i += blockDim.x)
      cp_async4(qr + i, qsrc + i);
    // a table row that fits is loaded whole, beside the query positions
    whole = tmax >= p.nblk;
    blk0 = 0;
    if (whole) {
      const int* tsrc = p.bt + (size_t)b * p.nblk;
      for (int i = threadIdx.x; i < p.nblk; i += blockDim.x)
        cp_async4(tb + i, tsrc + i);
    }
  }
  __device__ __forceinline__ bool finish(const Params& p, int b, int split) {
    // the live range: tokens lo .. max(qpos[b]); with a window, none older
    // than the youngest row's window
    int hi = -1, lo = 0x7fffffff;
    for (int c = 0; c < p.Sq; ++c) {
      const int qv = qrow[c];
      hi = max(hi, qv);
      if (qv >= 0) lo = min(lo, qv);
    }
    hi = min(hi + 1, p.C);
    lo = (window > 0 && hi > 0) ? max(0, lo - window + 1) : 0;
    const int live = max(0, hi - lo);
    // the split: a share of the live tokens, at least the workspace's
    // least, and at least sqrt(live * cfac), so the last block's combine
    // reads no more than a block's K and V
    int per = (live + p.nsplit - 1) / p.nsplit;
    per = max(per, (int)ceilf(sqrtf((float)live * p.cfac)));
    per = max(p.chunk, (per + TILE - 1) / TILE * TILE);
    s0 = lo + split * per;
    n = max(0, min(hi, s0 + per) - s0);
    if (whole) return false;
    blk0 = s0 / bs;
    const int nb = n > 0 ? (s0 + n - 1) / bs - blk0 + 1 : 0;
    const int* tsrc = p.bt + (size_t)b * p.nblk + blk0;
    for (int i = threadIdx.x; i < nb; i += blockDim.x)
      cp_async4(tb + i, tsrc + i);
    return true;
  }
  __device__ __forceinline__ bool slot_live(int i) const {
    (void)i;
    return true;
  }
  __device__ __forceinline__ int key(int i) const { return s0 + i; }
  __device__ __forceinline__ int rowq(int r) const {
    return r < nr ? qrow[(r0 + r) / G] : -1;
  }
  __device__ __forceinline__ int offset(int i) const {
    const int t = s0 + i;
    const int pb = tb[t / bs - blk0];
    if (pb < 0 || pb >= NB) return -1;            // reads as zeros
    return ((pb * bs + t % bs) * KV + kvh) * D;
  }
};

// ---------------------------------------------------------------------------
// Products: init(map), tile(Q, K tile, V tile, P scratch, key) with key the
// key of slot lane % NS of the tile (-1 past the split), store(m, l, acc)
// ---------------------------------------------------------------------------

// bf16 on mma.sync: one warp's 16 rows x NS = 16 slots a tile.  Thread
// (g = lane / 4, t = lane % 4) holds rows g and g + 8 of the score and
// output fragments.  exp2 of pre-scaled differences (the bf16 tolerance
// has room for MUFU's ~2 ulp).
template <int D>
struct MmaProd {
  using T = __nv_bfloat16;
  static constexpr int LD = D + 8;       // padded shared row (elements)
  static constexpr int P_FLOATS = 0;     // no P scratch: P stays in registers
  float o[D / 8][4];
  float m[2], l[2];
  int qv[2];                             // the query positions of rows g, g + 8

  template <class Map>
  __device__ __forceinline__ void init(const Map& map) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.0f;
    const int g = (threadIdx.x & 31) >> 2;
    m[0] = m[1] = NEG;
    l[0] = l[1] = 0.0f;
    qv[0] = map.rowq(g);
    qv[1] = map.rowq(g + 8);
  }

  __device__ __forceinline__ void tile(const T* qs, const T* ks, const T* vs,
                                       float* pw, int key, int window,
                                       float scale, float softcap) {
    (void)pw;
    const int lane = threadIdx.x & 31, t = lane & 3;
    float s[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.0f;
    // S = Q K^T: A from Q rows, B from K rows (non-transposed ldmatrix)
    const T* qa = qs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
    const T* ka = ks + ((lane >> 4) * 8 + (lane & 7)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, qa + kk * 16);
      ldsm_x4(b, ka + kk * 16);
      mma_16816(s[0], a, b[0], b[1]);
      mma_16816(s[1], a, b[2], b[3]);
    }
    // the keys of this thread's four slots: 2t, 2t + 1, 8 + 2t, 9 + 2t
    int kj[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        kj[nt][e] = __shfl_sync(FULL, key, nt * 8 + 2 * t + e);
    // the online softmax of rows g (h = 0) and g + 8 (h = 1)
    bool ok[2][4];
    float mx[2] = {NEG, NEG};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        ok[nt][e] = valid(kj[nt][e & 1], qv[h], window);
        s[nt][e] = ok[nt][e] ? score(s[nt][e], scale, softcap) : NEG;
        mx[h] = fmaxf(mx[h], s[nt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(FULL, mx[h], 2));
      const float mn = fmaxf(m[h], mx[h]);
      alpha[h] = mn == m[h] ? 1.0f : exp2f((m[h] - mn) * LOG2E);
      m[h] = mn;
      l[h] *= alpha[h];
    }
    if (__any_sync(FULL, alpha[0] != 1.0f || alpha[1] != 1.0f)) {
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    const float mb[2] = {m[0] * LOG2E, m[1] * LOG2E};
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[nt][e] = ok[nt][e] ? exp2f(fmaf(s[nt][e], LOG2E, -mb[h])) : 0.0f;
        l[h] += s[nt][e];
      }
    // P (16 rows x 16 slots) as the A operand, bf16 hi + lo
    uint32_t ph[4], pl[4];
    split_bf16(s[0][0], s[0][1], ph[0], pl[0]);
    split_bf16(s[0][2], s[0][3], ph[1], pl[1]);
    split_bf16(s[1][0], s[1][1], ph[2], pl[2]);
    split_bf16(s[1][2], s[1][3], ph[3], pl[3]);
    // O += P V: B from V rows (transposed ldmatrix), two n8 tiles a load
    const T* va = vs + (((lane >> 3) & 1) * 8 + (lane & 7)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int nd = 0; nd < D / 16; ++nd) {
      uint32_t b[4];
      ldsm_x4_trans(b, va + nd * 16);
      mma_16816(o[2 * nd], ph, b[0], b[1]);
      mma_16816(o[2 * nd + 1], ph, b[2], b[3]);
      mma_16816(o[2 * nd], pl, b[0], b[1]);
      mma_16816(o[2 * nd + 1], pl, b[2], b[3]);
    }
  }

  // this warp's (m, l, acc) into the merge scratch: m[RB], l[RB],
  // acc[RB][D]
  __device__ __forceinline__ void store(float* ms, float* ls, float* acc) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(FULL, l[h], 1);
      l[h] += __shfl_xor_sync(FULL, l[h], 2);
      if (t == 0) {
        ms[g + 8 * h] = m[h];
        ls[g + 8 * h] = l[h];
      }
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      *reinterpret_cast<float2*>(acc + g * D + c) = make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(acc + (g + 8) * D + c) =
          make_float2(o[n][2], o[n][3]);
    }
  }
};

// fp32 on FFMA: one warp's RBF rows (4, 8 or 16) x NS slots a tile.  Q K^T:
// lane (j = lane % NS, h = lane / NS) sums slot j's products over the float4
// chunks h, h + LPS, ... of D, then the LPS lanes of a slot add theirs.
// P V: lane owns CPL = D / 32 output columns of every row.  expf as the
// plain version's softmax (the fp32 greedy tokens rest on it).
template <int D, int NS, int RBF>
struct FfmaProd {
  using T = float;
  static constexpr int LD = D + 4;        // padded shared row (floats)
  static constexpr int LPS = 32 / NS;     // lanes a slot in Q K^T
  static constexpr int CPL = D / 32;      // output columns a lane
  static constexpr int P_FLOATS = RB * NS;
  float o[RBF][CPL];
  float m[RBF], l[RBF];
  int qv[RBF];

  // output column c of this lane: float2 pairs at D 64, float4 groups 128
  // apart above (a warp's V and acc accesses stay conflict-free)
  __device__ __forceinline__ static int col(int lane, int c) {
    return CPL == 2 ? 2 * lane + c : (c >> 2) * 128 + 4 * lane + (c & 3);
  }

  template <class Map>
  __device__ __forceinline__ void init(const Map& map) {
#pragma unroll
    for (int r = 0; r < RBF; ++r) {
      m[r] = NEG;
      l[r] = 0.0f;
      qv[r] = map.rowq(r);
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[r][c] = 0.0f;
    }
  }

  __device__ __forceinline__ void tile(const T* qs, const T* ks, const T* vs,
                                       float* pw, int key, int window,
                                       float scale, float softcap) {
    const int lane = threadIdx.x & 31, j = lane % NS, h = lane / NS;
    float s[RBF];
#pragma unroll
    for (int r = 0; r < RBF; ++r) s[r] = 0.0f;
    const float* kr = ks + j * LD;
#pragma unroll 4
    for (int c4 = h; c4 < D / 4; c4 += LPS) {
      const float4 kv = *reinterpret_cast<const float4*>(kr + 4 * c4);
#pragma unroll
      for (int r = 0; r < RBF; ++r) {
        const float4 qv4 = *reinterpret_cast<const float4*>(qs + r * LD + 4 * c4);
        s[r] = fmaf(qv4.x, kv.x, s[r]);
        s[r] = fmaf(qv4.y, kv.y, s[r]);
        s[r] = fmaf(qv4.z, kv.z, s[r]);
        s[r] = fmaf(qv4.w, kv.w, s[r]);
      }
    }
#pragma unroll
    for (int off = NS; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < RBF; ++r) s[r] += __shfl_xor_sync(FULL, s[r], off);
    const int kj = __shfl_sync(FULL, key, j);
#pragma unroll
    for (int r = 0; r < RBF; ++r) {
      const bool ok = valid(kj, qv[r], window);
      const float v = ok ? score(s[r], scale, softcap) : NEG;
      float mx = v;
#pragma unroll
      for (int off = 1; off < NS; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      const float mn = fmaxf(m[r], mx);
      const float p = ok ? expf(v - mn) : 0.0f;
      if (mn != m[r]) {                   // warp-uniform
        const float alpha = expf(m[r] - mn);
        l[r] *= alpha;
#pragma unroll
        for (int c = 0; c < CPL; ++c) o[r][c] *= alpha;
      }
      m[r] = mn;
      l[r] += h == 0 ? p : 0.0f;
      if (h == 0) pw[r * NS + j] = p;
    }
    __syncwarp();
    // O += P V, four slots a step
#pragma unroll
    for (int j0 = 0; j0 < NS; j0 += 4) {
      float vv[4][CPL];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float* vr = vs + (j0 + jj) * LD;
        if constexpr (CPL == 2) {
          const float2 x = *reinterpret_cast<const float2*>(vr + col(lane, 0));
          vv[jj][0] = x.x;
          vv[jj][1] = x.y;
        } else {
#pragma unroll
          for (int c = 0; c < CPL; c += 4) {
            const float4 x = *reinterpret_cast<const float4*>(vr + col(lane, c));
            vv[jj][c] = x.x;
            vv[jj][c + 1] = x.y;
            vv[jj][c + 2] = x.z;
            vv[jj][c + 3] = x.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RBF; ++r) {
        const float4 p4 = *reinterpret_cast<const float4*>(pw + r * NS + j0);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float a = o[r][c];
          a = fmaf(p4.x, vv[0][c], a);
          a = fmaf(p4.y, vv[1][c], a);
          a = fmaf(p4.z, vv[2][c], a);
          a = fmaf(p4.w, vv[3][c], a);
          o[r][c] = a;
        }
      }
    }
  }

  __device__ __forceinline__ void store(float* ms, float* ls, float* acc) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < RBF) {
        float lr = l[r];
#pragma unroll
        for (int off = 1; off < 32; off <<= 1)
          lr += __shfl_xor_sync(FULL, lr, off);
        if (lane == 0) {
          ms[r] = m[r];
          ls[r] = lr;
        }
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r * D + col(lane, c)] = o[r][c];
      } else if (lane == 0) {             // rows this product never ran
        ms[r] = NEG;
        ls[r] = 0.0f;
      }
    }
  }
};

template <typename T, int D, int RBF> struct ProdOf;
template <int D, int RBF> struct ProdOf<__nv_bfloat16, D, RBF> {
  using type = MmaProd<D>;
};
template <int D, int RBF> struct ProdOf<float, D, RBF> {
  using type = FfmaProd<D, Cfg<float, D>::NS, RBF>;
};

// Shared memory of one block: the warps' rings, Q, the warps' P scratch
// and load offsets, then the Map's ints; the merge and combine scratch
// reuse the rings.
template <typename T, int D>
struct Layout {
  using C = Cfg<T, D>;
  using Prod = typename ProdOf<T, D, RB>::type;
  static constexpr int W = C::W, NS = C::NS, ST = C::ST, LD = Prod::LD;
  static constexpr int STAGE = 2 * NS * LD;             // K then V (elements)
  static constexpr int RING_BYTES = W * ST * STAGE * (int)sizeof(T);
  static constexpr int Q_BYTES = RB * LD * (int)sizeof(T);
  static constexpr int P_BYTES = W * Prod::P_FLOATS * 4;
  static constexpr int OFF_BYTES = W * NS * 4;
  static constexpr int FIXED_BYTES = RING_BYTES + Q_BYTES + P_BYTES + OFF_BYTES;
  // the merge's states, weights and row sums
  static constexpr int MERGE_BYTES = W * RB * (D + 3) * 4 + 2 * RB * 4;
  // the combine's (m, l) pairs, weights, sums and room for a split's acc
  // rows
  static constexpr int COMBINE_BYTES =
      MAX_SPLITS * RB * 3 * 4 + RB * 4 + RB * D * 4;
  static_assert(MERGE_BYTES <= RING_BYTES, "merge scratch fits the rings");
  static_assert(COMBINE_BYTES <= RING_BYTES, "combine scratch fits");
  static_assert(RING_BYTES % 16 == 0 && Q_BYTES % 16 == 0, "16-byte rows");
  static size_t bytes(int extra) {
    return FIXED_BYTES + (size_t)extra * sizeof(int);
  }
};

// Four outputs at o (a row's column 4 d4).
__device__ __forceinline__ void store4(float* o, float4 v) {
  *reinterpret_cast<float4*>(o) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* o, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&a);
  u.y = *reinterpret_cast<const uint32_t*>(&b);
  *reinterpret_cast<uint2*>(o) = u;
}

// ---------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------

template <typename T, int D, class Map, int RBF>
__global__ void __launch_bounds__(Cfg<T, D>::W * 32)
decode_core_kernel(const Params p) {
  using L = Layout<T, D>;
  using Prod = typename ProdOf<T, D, RBF>::type;
  constexpr int W = L::W, NS = L::NS, ST = L::ST, LD = L::LD;
  constexpr int EPC = 16 / (int)sizeof(T);          // elements a 16-byte chunk
  constexpr int CPR = D / EPC;                      // chunks a row
  constexpr int NTH = W * 32;
  constexpr int D4 = D / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  T* qs = reinterpret_cast<T*>(smem + L::RING_BYTES);
  float* pscr = reinterpret_cast<float*>(smem + L::RING_BYTES + L::Q_BYTES);
  int* offs = reinterpret_cast<int*>(smem + L::RING_BYTES + L::Q_BYTES +
                                     L::P_BYTES);
  int* ints = reinterpret_cast<int*>(smem + L::FIXED_BYTES);
  __shared__ int s_last;
  __shared__ long long s_orow[RB];      // output element offset of each row

  const int split = blockIdx.x, kvh = blockIdx.y / p.n_rt;
  const int rtile = blockIdx.y % p.n_rt, b = blockIdx.z;
  const int G = p.H / p.KV, R = p.Sq * G, r0 = rtile * RB;
  const int nr = min(RB, R - r0), RT = min(R, RB), RTP = RT + (RT & 1);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // Q rows r0 .. r0 + nr - 1 in their own dtype (zero rows below) and the
  // slot map's data, all by cp.async: one round trip, no register waits
  const T* q = static_cast<const T*>(p.q);
  if (tid < RB) {
    const int rg = r0 + tid;
    s_orow[tid] = (((long long)b * p.Sq + rg / G) * p.H +
                   (long long)kvh * G + rg % G) * D;
  }
  __syncthreads();
  for (int i = tid; i < RB * CPR; i += NTH) {
    const int r = i / CPR, cc = i % CPR;      // CPR: a power of two
    rt::cp_async16(qs + r * LD + cc * EPC,
                   r < nr ? q + s_orow[r] + cc * EPC : q, r < nr ? 16 : 0);
  }
  Map map;
  map.start(p, b, kvh, split, D, r0, nr, ints);
  rt::cp_async_commit();
  rt::cp_async_wait<0>();
  __syncthreads();
  if (map.finish(p, b, split)) {        // a second load the first decided
    rt::cp_async_commit();
    rt::cp_async_wait<0>();
    __syncthreads();
  }

  // this warp's tiles w, w + W, ...; a dead tile loads nothing
  const int ntiles = (map.n + NS - 1) / NS;
  auto live = [&](int k) {
    while (k < ntiles) {
      const int i = k * NS + lane;
      if (__any_sync(FULL, lane < NS && i < map.n && map.slot_live(i)))
        return k;
      k += W;
    }
    return ntiles;
  };
  const T* kg = static_cast<const T*>(p.k);
  const T* vg = static_cast<const T*>(p.v);
  T* wring = ring + warp * ST * L::STAGE;
  int* woff = offs + warp * NS;
  auto load = [&](int k, int stage) {
    const int i0 = k * NS;
    __syncwarp();                       // the last tile's offsets are read
    if (lane < NS) woff[lane] = i0 + lane < map.n ? map.offset(i0 + lane) : -1;
    __syncwarp();
    T* sk = wring + stage * L::STAGE;
#pragma unroll
    for (int it = 0; it < 2 * NS * CPR / 32; ++it) {
      const int idx = it * 32 + lane;
      const int mat = idx / (NS * CPR), rem = idx % (NS * CPR);
      const int j = rem / CPR, cc = rem % CPR;
      const int o = woff[j];
      const T* src = (mat ? vg : kg) + (o >= 0 ? o : 0) + cc * EPC;
      rt::cp_async16(sk + mat * NS * LD + j * LD + cc * EPC, src,
                     o >= 0 ? 16 : 0);
    }
  };

  Prod prod;
  prod.init(map);
  float* pw = pscr + warp * Prod::P_FLOATS;
  int ik = live(warp), ck = ik;
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (ik < ntiles) {
      load(ik, s);
      ik = live(ik + W);
    }
    rt::cp_async_commit();
  }
  int stage = 0;
  while (ck < ntiles) {
    if (ik < ntiles) {
      load(ik, (stage + ST - 1) % ST);
      ik = live(ik + W);
    }
    rt::cp_async_commit();
    const int i = ck * NS + lane;
    const int key = lane < NS && i < map.n ? map.key(i) : -1;
    rt::cp_async_wait<ST - 1>();
    __syncwarp();
    const T* sk = wring + stage * L::STAGE;
    prod.tile(qs, sk, sk + NS * LD, pw, key, p.window, p.scale, p.softcap);
    __syncwarp();
    stage = (stage + 1) % ST;
    ck = live(ck + W);
  }
  rt::cp_async_wait<0>();
  __syncthreads();                    // every warp is done with the rings

  // the warps' states, merged in warp order
  float* mscr = reinterpret_cast<float*>(smem);      // [W][RB] m, then l
  float* lscr = mscr + W * RB;
  float* ascr = lscr + W * RB;                       // [W][RB][D]
  float* ew = ascr + W * RB * D;                     // [W][RB] weights
  float* rowm = ew + W * RB;                         // [RB] max, sum
  float* rowl = rowm + RB;
  prod.store(mscr + warp * RB, lscr + warp * RB, ascr + warp * RB * D);
  __syncthreads();
  if (tid < nr) {
    const int r = tid;
    float M = NEG;
#pragma unroll
    for (int w = 0; w < W; ++w) M = fmaxf(M, mscr[w * RB + r]);
    float Lr = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float e = expf(mscr[w * RB + r] - M);
      ew[w * RB + r] = e;
      Lr += lscr[w * RB + r] * e;
    }
    rowm[r] = M;
    rowl[r] = Lr;
  }
  __syncthreads();

  const int group = (b * p.KV + kvh) * p.n_rt + rtile;
  T* out = static_cast<T*>(p.out);
  const size_t groups = (size_t)gridDim.y * gridDim.z;
  float* wacc = p.ws + (((size_t)group * p.nsplit + split) * RT) * D;
  float* wml = p.ws + groups * p.nsplit * RT * D +
               (((size_t)group * p.nsplit + split) * RTP) * 2;
  for (int i = tid; i < nr * D4; i += NTH) {
    const int r = i / D4, d4 = i % D4;
    float4 A = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float e = ew[w * RB + r];
      const float4 x =
          *reinterpret_cast<const float4*>(ascr + (w * RB + r) * D + 4 * d4);
      A.x += x.x * e;
      A.y += x.y * e;
      A.z += x.z * e;
      A.w += x.w * e;
    }
    if (p.nsplit == 1) {
      const float inv = fmaxf(rowl[r], 1e-30f);
      store4(out + s_orow[r] + 4 * d4,
             make_float4(A.x / inv, A.y / inv, A.z / inv, A.w / inv));
    } else {
      *reinterpret_cast<float4*>(wacc + r * D + 4 * d4) = A;
    }
  }
  if (p.nsplit == 1) return;
  if (tid < RTP) {
    wml[2 * tid] = tid < nr ? rowm[tid] : NEG;
    wml[2 * tid + 1] = tid < nr ? rowl[tid] : 0.0f;
  }

  // the last block of the group combines the splits in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(p.tickets + group, 1) == p.nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int ns = p.nsplit;
  const float* gacc = p.ws + (size_t)group * ns * RT * D;
  const float* gml = p.ws + groups * ns * RT * D + (size_t)group * ns * RTP * 2;
  float2* cml = reinterpret_cast<float2*>(smem);     // [ns][RTP] (m, l)
  float* cw = reinterpret_cast<float*>(cml + MAX_SPLITS * RB);  // [ns][RB]
  float* cL = cw + MAX_SPLITS * RB;                  // [RB] the sum
  float* cbuf = cL + RB;                             // acc rows of a batch
  const int per4 = nr * D4;                          // float4s a split
  const int batch = max(1, (int)((L::RING_BYTES -
                                  ((char*)cbuf - (char*)smem)) /
                                 (per4 * 16)));
  // the splits' acc rows come through shared memory in batches by cp.async
  // (many loads in flight, none in registers), the (m, l) pairs with the
  // first batch: one round trip when they fit
  auto fetch = [&](int k0, int kn) {
    for (int k = 0; k < kn; ++k) {
      const float* src = gacc + (size_t)(k0 + k) * RT * D;
      float* dst = cbuf + (size_t)k * per4 * 4;
      for (int c = tid; c < per4; c += NTH)
        rt::cp_async16(dst + 4 * c, src + 4 * c, 16);
    }
    rt::cp_async_commit();
  };
  for (int i = tid; i < ns * RTP / 2; i += NTH)      // two pairs a chunk
    rt::cp_async16(cml + 2 * i, gml + 4 * i, 16);
  fetch(0, min(batch, ns));
  rt::cp_async_wait<0>();
  __syncthreads();
  // each row's weights, a warp a row: lanes over the splits, then a fixed
  // shuffle tree (a dead split's acc is zeros, its weight 0 or, when no
  // split is live, 1)
  for (int r = warp; r < nr; r += W) {
    float M = NEG;
    for (int k = lane; k < ns; k += 32) M = fmaxf(M, cml[k * RTP + r].x);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(FULL, M, off));
    float Lr = 0.0f;
    for (int k = lane; k < ns; k += 32) {
      const float2 ml = cml[k * RTP + r];
      const float e = expf(ml.x - M);
      cw[k * RB + r] = e;
      Lr += ml.y * e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      Lr += __shfl_xor_sync(FULL, Lr, off);
    if (lane == 0) cL[r] = fmaxf(Lr, 1e-30f);
  }
  __syncthreads();
  constexpr int MAXO = (RB * D4 + NTH - 1) / NTH;
  float4 a[MAXO];
#pragma unroll
  for (int j = 0; j < MAXO; ++j) a[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int k0 = 0; k0 < ns; k0 += batch) {
    const int kn = min(batch, ns - k0);
    if (k0 > 0) {                       // the next batch, once this one is read
      __syncthreads();
      fetch(k0, kn);
      rt::cp_async_wait<0>();
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < MAXO; ++j) {
      const int i = tid + j * NTH;
      if (i < per4) {
        const int r = i / D4;
        for (int k = 0; k < kn; ++k) {
          const float e = cw[(k0 + k) * RB + r];
          const float4 x = *reinterpret_cast<const float4*>(
              cbuf + ((size_t)k * per4 + i) * 4);
          a[j].x += x.x * e;
          a[j].y += x.y * e;
          a[j].z += x.z * e;
          a[j].w += x.w * e;
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < MAXO; ++j) {
    const int i = tid + j * NTH;
    if (i < per4) {
      const int r = i / D4, d4 = i % D4;
      const float inv = cL[r];
      store4(out + s_orow[r] + 4 * d4,
             make_float4(a[j].x / inv, a[j].y / inv, a[j].z / inv,
                         a[j].w / inv));
    }
  }
  if (tid == 0) p.tickets[group] = 0;    // ready for the next call
}

// Launch one call: grid (nsplit, KV x n_rt, B).  Returns a CUDA error or 0.
template <typename T, int D, class Map, int RBF>
int launch(const Params& p, cudaStream_t stream) {
  using L = Layout<T, D>;
  auto kern = decode_core_kernel<T, D, Map, RBF>;
  const size_t smem = L::bytes(p.extra);
  static size_t opted = 0;               // the opt-in so far, per kernel
  if (smem > opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = smem;
  }
  kern<<<dim3((unsigned)p.nsplit, (unsigned)(p.KV * p.n_rt), (unsigned)p.B),
         L::W * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// bf16 runs 16 rows on the tensor cores; fp32 the fewest of 4, 8 and 16
// that hold a block's rows.
template <typename T, int D, class Map>
int launch_rows(const Params& p, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2) {
    return launch<T, D, Map, RB>(p, stream);
  } else {
    const int rows = min(p.Sq * (p.H / p.KV), RB);
    if (rows <= 4) return launch<T, D, Map, 4>(p, stream);
    if (rows <= 8) return launch<T, D, Map, 8>(p, stream);
    return launch<T, D, Map, RB>(p, stream);
  }
}

template <typename T, class Map>
int dispatch(int D, const Params& p, cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch_rows<T, 64, Map>(p, stream);
    case 128:
      return launch_rows<T, 128, Map>(p, stream);
    case 256:
      return launch_rows<T, 256, Map>(p, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace dcore
