// decode_attention: one query token per row over the rolling KV cache,
// split-KV (flash-decoding).  Replaces the Pallas kernel decode_attention of
// src/repro/kernels/decode_attention.py; see
// src/repro_torch/kernels/decode_attention.py for the design note and the
// plain PyTorch version it is held against.
//
// q (B, 1, H, D), kc and vc (B, C, KV, D), out (B, 1, H, D), all contiguous
// in one dtype; pos (B, C) int32 slot positions (-1 empty), qpos (B, 1)
// int32.  The first kernel runs one block per (split, KV head, batch row)
// over its split's slots and writes partial (m, l, acc) for its G heads to
// the fp32 workspace ws; the second combines the splits of each head.
#include <cmath>

#include "common.cuh"

namespace {

using namespace rt;

constexpr int SLOTS = 64;          // cache slots per tile
constexpr int DTHREADS = 128;
constexpr int DWARPS = DTHREADS / 32;
constexpr int CTHREADS = 128;      // threads of the combining kernel
constexpr float NEG = -1e30f;

template <int D>
size_t smem_bytes(int G) {
  // qs [G][D], Ks [SLOTS][D+1], Vs [SLOTS][D], Ss [G][SLOTS], acc [G][D],
  // m, l, alpha [G], slot positions [SLOTS]
  return (size_t)(G * D + SLOTS * (D + 1) + SLOTS * D + G * SLOTS + G * D +
                  3 * G) * sizeof(float) + SLOTS * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(DTHREADS)
decode_partial_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                      const T* __restrict__ vc, const int* __restrict__ pos,
                      const int* __restrict__ qpos, float* __restrict__ ws,
                      int C, int H, int KV, int window, float softcap,
                      int nsplit, int chunk, float scale) {
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / KV;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* Ks = qs + G * D;
  float* Vs = Ks + SLOTS * (D + 1);
  float* Ss = Vs + SLOTS * D;
  float* acc = Ss + G * SLOTS;
  float* ms = acc + G * D;
  float* ls = ms + G;
  float* as = ls + G;
  int* ps = reinterpret_cast<int*>(as + G);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int qp = qpos[b];
  const T* qb = q + ((size_t)b * H + (size_t)kvh * G) * D;  // G heads, contiguous
  for (int idx = tid; idx < G * D; idx += DTHREADS) {
    qs[idx] = to_f32(qb[idx]) * scale;
    acc[idx] = 0.0f;
  }
  for (int g = tid; g < G; g += DTHREADS) {
    ms[g] = NEG;
    ls[g] = 0.0f;
  }

  const int c_begin = split * chunk;
  const int c_end = min(C, c_begin + chunk);
  for (int c0 = c_begin; c0 < c_end; c0 += SLOTS) {
    for (int idx = tid; idx < SLOTS * D; idx += DTHREADS) {
      const int r = idx / D, d = idx % D, c = c0 + r;
      float kk = 0.0f, vv = 0.0f;
      if (c < c_end) {
        const size_t off = (((size_t)b * C + c) * KV + kvh) * D + d;
        kk = to_f32(kc[off]);
        vv = to_f32(vc[off]);
      }
      Ks[r * (D + 1) + d] = kk;
      Vs[r * D + d] = vv;
    }
    for (int r = tid; r < SLOTS; r += DTHREADS)
      ps[r] = c0 + r < c_end ? pos[(size_t)b * C + c0 + r] : -1;
    __syncthreads();

    // scores of the G heads against the tile's slots
    for (int idx = tid; idx < G * SLOTS; idx += DTHREADS) {
      const int g = idx / SLOTS, r = idx % SLOTS;
      float s = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qs[g * D + d], Ks[r * (D + 1) + d], s);
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      const int kp = ps[r];
      bool ok = kp >= 0 && kp <= qp;
      if (window > 0) ok = ok && kp > qp - window;
      Ss[idx] = ok ? s : NEG;
    }
    __syncthreads();

    // online softmax: one warp per head, two slots a lane
    for (int g = warp; g < G; g += DWARPS) {
      float* sg = Ss + g * SLOTS;
      const float s0 = sg[lane], s1 = sg[lane + 32];
      float mt = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = ms[g];
      const float m_new = fmaxf(m_old, mt);
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sg[lane] = p0;
      sg[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        ls[g] = ls[g] * alpha + sum;
        ms[g] = m_new;
        as[g] = alpha;
      }
    }
    __syncthreads();

    for (int idx = tid; idx < G * D; idx += DTHREADS) {
      const int g = idx / D, d = idx % D;
      const float* pg = Ss + g * SLOTS;
      float a = acc[idx] * as[g];
#pragma unroll 8
      for (int r = 0; r < SLOTS; ++r) a = fmaf(pg[r], Vs[r * D + d], a);
      acc[idx] = a;
    }
    __syncthreads();
  }

  // partials of this split: [G] m, [G] l, [G][D] acc
  float* w = ws + (((size_t)b * KV + kvh) * nsplit + split) * G * (D + 2);
  for (int g = tid; g < G; g += DTHREADS) {
    w[g] = ms[g];
    w[G + g] = ls[g];
  }
  for (int idx = tid; idx < G * D; idx += DTHREADS) w[2 * G + idx] = acc[idx];
}

template <typename T>
__global__ void __launch_bounds__(CTHREADS)
decode_combine_kernel(const float* __restrict__ ws, T* __restrict__ out,
                      int H, int KV, int D, int nsplit) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = H / KV, kvh = h / G, g = h % G;
  const size_t stride = (size_t)G * (D + 2);
  const float* base = ws + ((size_t)b * KV + kvh) * nsplit * stride;
  float M = NEG;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, base[s * stride + g]);
  float L = 0.0f;
  for (int s = 0; s < nsplit; ++s)
    L += base[s * stride + G + g] * expf(base[s * stride + g] - M);
  const float den = fmaxf(L, 1e-30f);
  for (int d = threadIdx.x; d < D; d += CTHREADS) {
    float o = 0.0f;
    for (int s = 0; s < nsplit; ++s)
      o += base[s * stride + 2 * G + (size_t)g * D + d] *
           expf(base[s * stride + g] - M);
    out[((size_t)b * H + h) * D + d] = from_f32<T>(o / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* kc, const void* vc, const int* pos,
           const int* qpos, void* out, float* ws, int B, int C, int H, int KV,
           int window, float softcap, int nsplit, int chunk,
           cudaStream_t stream) {
  auto kern = decode_partial_kernel<T, D>;
  const size_t smem = smem_bytes<D>(H / KV);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<dim3((unsigned)nsplit, (unsigned)KV, (unsigned)B), DTHREADS, smem,
         stream>>>(static_cast<const T*>(q), static_cast<const T*>(kc),
                   static_cast<const T*>(vc), pos, qpos, ws, C, H, KV, window,
                   softcap, nsplit, chunk, (float)(1.0 / std::sqrt((double)D)));
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_combine_kernel<T><<<dim3((unsigned)H, (unsigned)B), CTHREADS, 0,
                             stream>>>(ws, static_cast<T*>(out), H, KV, D,
                                       nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* kc, const void* vc,
             const int* pos, const int* qpos, void* out, float* ws, int B,
             int C, int H, int KV, int window, float softcap, int nsplit,
             int chunk, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, kc, vc, pos, qpos, out, ws, B, C, H, KV, window, softcap, nsplit, chunk, s);
    case 32:
      return launch<T, 32>(q, kc, vc, pos, qpos, out, ws, B, C, H, KV, window, softcap, nsplit, chunk, s);
    case 64:
      return launch<T, 64>(q, kc, vc, pos, qpos, out, ws, B, C, H, KV, window, softcap, nsplit, chunk, s);
    case 128:
      return launch<T, 128>(q, kc, vc, pos, qpos, out, ws, B, C, H, KV, window, softcap, nsplit, chunk, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  dtype is that of q,
// kc, vc and out (0 fp32, 1 bf16); window 0 means none, softcap 0 means
// none; ws holds B * KV * nsplit * (H / KV) * (D + 2) floats, and the
// nsplit splits of chunk slots cover the C slots.  Returns the first CUDA
// error of the two launches, or 0.
extern "C" int decode_attention(int dtype, const void* q, const void* kc,
                                const void* vc, const int* pos,
                                const int* qpos, void* out, float* ws, int B,
                                int C, int H, int KV, int D, int window,
                                float softcap, int nsplit, int chunk,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || C <= 0 || KV <= 0 || H % KV != 0 || nsplit <= 0 ||
      chunk <= 0 || chunk % SLOTS != 0 || (long long)nsplit * chunk < C)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, kc, vc, pos, qpos, out, ws, B, C, H, KV, window, softcap, nsplit, chunk, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, kc, vc, pos, qpos, out, ws, B, C, H, KV, window, softcap, nsplit, chunk, s);
  return (int)cudaErrorInvalidValue;
}
