// flash_attention: causal, windowed and softcapped GQA attention with an
// online softmax in fp32.  Replaces the Pallas kernel flash_attention of
// src/repro/kernels/attention.py; see src/repro_torch/kernels/attention.py
// for the design note and the plain PyTorch version it is held against.
//
// q (B, Sq, H, D), k and v (B, Skv, KV, D), out (B, Sq, H, D), all
// contiguous in one dtype; qpos (B, Sq) and kpos (B, Skv) int32 positions,
// -1 for padding.  One block per (64 query rows, head, batch row); head h
// reads KV head h / (H / KV).
#include <cmath>

#include "common.cuh"

namespace {

using namespace rt;

constexpr int FBQ = 64;           // query rows per block
constexpr int FBK = 64;           // keys per K/V tile
constexpr int FTHREADS = 256;     // a 16 x 16 grid, 4 x 4 scores a thread
constexpr int PAD = 4;            // keeps the transposed tiles 16-byte rows
constexpr float NEG = -1e30f;

template <int D>
constexpr size_t smem_bytes() {
  // Qs [D][FBQ+PAD], Ks [D][FBK+PAD], Vs [FBK][D], Ps [FBK][FBQ+PAD], kpos;
  // 222,464 bytes at D = 256, under the 232,448 a block may opt in to
  return (size_t)(D * (FBQ + PAD) + D * (FBK + PAD) + FBK * D +
                  FBK * (FBQ + PAD)) * sizeof(float) + FBK * sizeof(int);
}

template <typename T, int D>
__global__ void __launch_bounds__(FTHREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out,
                       int Sq, int Skv, int H, int KV, int causal, int window,
                       float softcap, int q_offset, float scale) {
  constexpr int TNV = D / 16;     // output columns a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // q^T, scaled
  float* Ks = Qs + D * (FBQ + PAD);          // k^T of the tile
  float* Vs = Ks + D * (FBK + PAD);          // v of the tile
  float* Ps = Vs + FBK * D;                  // p^T of the tile
  int* kp_s = reinterpret_cast<int*>(Ps + FBK * (FBQ + PAD));
  __shared__ int qp_s[FBQ];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * FBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);

  for (int idx = tid; idx < FBQ * D; idx += FTHREADS) {
    const int r = idx / D, d = idx % D, qi = q0 + r;
    float val = 0.0f;
    if (qi < Sq) val = to_f32(q[((size_t)(b * Sq + qi) * H + h) * D + d]) * scale;
    Qs[d * (FBQ + PAD) + r] = val;
  }
  for (int r = tid; r < FBQ; r += FTHREADS)
    qp_s[r] = q0 + r < Sq ? qpos[(size_t)b * Sq + q0 + r] : -1;

  // tiles dead in index space are skipped (exact under the per-row
  // shifted-arange positions contract, as in the Pallas kernel)
  const int q_lo = q0 + q_offset;
  const int nk = (Skv + FBK - 1) / FBK;
  int kt_end = nk;
  if (causal) kt_end = min(nk, (q_lo + FBQ - 1) / FBK + 1);
  int kt_begin = 0;
  if (window > 0) {
    const int lo = q_lo - window + 2 - FBK;  // first k_lo with a live key
    kt_begin = lo > 0 ? (lo + FBK - 1) / FBK : 0;
  }

  float m[4], l[4], acc[4][TNV];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < TNV; ++c) acc[i][c] = 0.0f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * FBK;
    for (int idx = tid; idx < FBK * D; idx += FTHREADS) {
      const int r = idx / D, d = idx % D, kj = k0 + r;
      float kk = 0.0f, vv = 0.0f;
      if (kj < Skv) {
        const size_t off = ((size_t)(b * Skv + kj) * KV + kvh) * D + d;
        kk = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      Ks[d * (FBK + PAD) + r] = kk;
      Vs[r * D + d] = vv;
    }
    for (int r = tid; r < FBK; r += FTHREADS)
      kp_s[r] = k0 + r < Skv ? kpos[(size_t)b * Skv + k0 + r] : -1;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(&Qs[d * (FBQ + PAD) + ty * 4]);
      const float4 c = *reinterpret_cast<const float4*>(&Ks[d * (FBK + PAD) + tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
    }

    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = qp_s[ty * 4 + i];
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sv = s[i][j];
        if (softcap > 0.0f) sv = tanhf(sv / softcap) * softcap;
        const int kp = kp_s[tx * 4 + j];
        bool ok = kp >= 0;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && kp > qp - window;
        s[i][j] = ok ? sv : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads of a row are lanes tx = 0..15 of one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        p[i][j] = expf(s[i][j] - m_new);
        rs += p[i][j];
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, o);
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < TNV; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx * 4 + j) * (FBQ + PAD) + ty * 4]) =
          make_float4(p[0][j], p[1][j], p[2][j], p[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < FBK; ++r) {
      const float4 a = *reinterpret_cast<const float4*>(&Ps[r * (FBQ + PAD) + ty * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < TNV; ++c) {
        const float vv = Vs[r * D + tx * TNV + c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(av[i], vv, acc[i][c]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)(b * Sq + qi) * H + h) * D + tx * TNV;
#pragma unroll
    for (int c = 0; c < TNV; ++c) o[c] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* qpos,
           const int* kpos, void* out, int B, int Sq, int Skv, int H, int KV,
           int causal, int window, float softcap, int q_offset,
           cudaStream_t stream) {
  auto kern = flash_attention_kernel<T, D>;
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((Sq + FBQ - 1) / FBQ), (unsigned)H, (unsigned)B);
  kern<<<grid, FTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, static_cast<T*>(out), Sq, Skv, H,
      KV, causal, window, softcap, q_offset, (float)(1.0 / std::sqrt((double)D)));
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int D, const void* q, const void* k, const void* v,
             const int* qpos, const int* kpos, void* out, int B, int Sq,
             int Skv, int H, int KV, int causal, int window, float softcap,
             int q_offset, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
    case 32:
      return launch<T, 32>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
    case 256:
      return launch<T, 256>(q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  dtype is that of q,
// k, v and out (0 fp32, 1 bf16); window 0 means none, softcap 0 means none.
// Returns the first CUDA error of the launch, or 0.
extern "C" int flash_attention(int dtype, const void* q, const void* k,
                               const void* v, const int* qpos,
                               const int* kpos, void* out, int B, int Sq,
                               int Skv, int H, int KV, int D, int causal,
                               int window, float softcap, int q_offset,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32)
    return dispatch<float>(D, q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
  if (dtype == rt::kBF16)
    return dispatch<__nv_bfloat16>(D, q, k, v, qpos, kpos, out, B, Sq, Skv, H, KV, causal, window, softcap, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// Head width D.
extern "C" int flash_attention_simt_smem(int D) {
  switch (D) {
    case 16: return (int)smem_bytes<16>();
    case 32: return (int)smem_bytes<32>();
    case 64: return (int)smem_bytes<64>();
    case 128: return (int)smem_bytes<128>();
    case 256: return (int)smem_bytes<256>();
    default: return -1;
  }
}
