// conv2d_fused: direct NHWC x HWIO convolution as an implicit GEMM, with the
// inference batch-norm fold and the activation applied in registers before
// the single write.  Replaces the Pallas kernel conv2d_fused of
// src/repro/kernels/conv2d.py; see src/repro_torch/kernels/conv2d.py for the
// design note and the plain PyTorch version it is held against.
//
//   GEMM view: M = N*Ho*Wo output pixels, K = kh*kw*CI taps, N = CO.
//   A[m, k] = x[n, oh*s - pad_t + dh, ow*s - pad_l + dw, ci], 0 outside;
//   B[k, c] = w viewed as (kh*kw*CI, CO) — HWIO is already that matrix.
//
// The padding is a predicate in the gather (XLA's SAME split: the odd extra
// row/column on the high side, so only pad_t/pad_l are needed), so the input
// is never padded in memory.  Accumulation is fp32; the output is written
// once, in the input dtype.
//
// Two entries.  conv2d_fused is the `simt` schedule: 64 x 64 tiles staged
// element by element as fp32, for any CI and CO (the 7x7 stem's 3 channels,
// LeNet-5's 1 and 6, the bf16 convs conv2d_wgmma.cu does not take).
// conv2d_ffma is the `ffma` schedule: fp32 with CI and CO multiples of 4
// (every ResNet-34 conv but the stem in the base flow).  The mainloop is
// ffma_tile.cuh's (full fp32 FMAs, 128 x 128 tiles, 128 x 64 when CO is 64,
// a 4-slot cp.async ring); its A loader is the im2col gather below, one
// float4 of 4 channels of one tap a chunk (CI % 4 == 0: a chunk never
// straddles two taps), zeros where the tap falls in the padding.  A grid
// under half a wave splits K (the wrapper's _conv_split) and sums the fp32
// partials in a fixed order before the batch-norm fold and act.
#include "common.cuh"
#include "ffma_tile.cuh"

namespace {

using namespace rt;

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv2d_fused_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias,
                    const float* __restrict__ mean,
                    const float* __restrict__ var, T* __restrict__ out, int N,
                    int H, int W, int CI, int CO, int KH, int KW, int stride,
                    int pad_t, int pad_l, int Ho, int Wo, int act) {
  __shared__ __align__(16) float As[BK][BM + 4];
  __shared__ __align__(16) float Bs[1][BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int M = N * Ho * Wo;
  const int K = KH * KW * CI;

  // gather assignment: row ar of the A tile, taps ak .. ak+3 of each step
  const int ar = tid >> 2, ak = (tid & 3) * 4;
  const int am = m0 + ar;
  const bool arow_ok = am < M;
  int ih0 = 0, iw0 = 0;
  const T* xn = x;
  if (arow_ok) {
    const int hw = Ho * Wo;
    const int n = am / hw, r = am % hw;
    ih0 = (r / Wo) * stride - pad_t;
    iw0 = (r % Wo) * stride - pad_l;
    xn = x + (size_t)n * H * W * CI;
  }
  // weight assignment: row bkr of the B tile, columns bc .. bc+3
  const int bkr = tid >> 4, bc = (tid & 15) * 4;

  float acc[1][TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[0][i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + ak + i;
      float v = 0.0f;
      if (arow_ok && k < K) {
        const int ci = k % CI, t = k / CI;
        const int ih = ih0 + t / KW, iw = iw0 + t % KW;
        if (ih >= 0 && ih < H && iw >= 0 && iw < W)
          v = to_f32(xn[((size_t)ih * W + iw) * CI + ci]);
      }
      As[ak + i][ar] = v;
    }
    {
      const int k = k0 + bkr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + bc + j;
        Bs[0][bkr][bc + j] =
            (k < K && c < CO) ? to_f32(w[(size_t)k * CO + c]) : 0.0f;
      }
    }
    __syncthreads();
    mma_step<1>(As, Bs, acc, ty, tx);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + tx * TN + j;
      if (c >= CO) continue;
      float v = acc[0][i][j];
      if (scale != nullptr) {
        const float inv = 1.0f / sqrtf(var[c] + 1e-5f);
        v = (v - mean[c]) * (inv * scale[c]) + bias[c];
      }
      out[(size_t)m * CO + c] = from_f32<T>(apply_act(v, act));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, const float* mean, const float* var, void* out,
           int N, int H, int W, int CI, int CO, int KH, int KW, int stride,
           int pad_t, int pad_l, int Ho, int Wo, int act,
           cudaStream_t stream) {
  const long long M = (long long)N * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((CO + BN - 1) / BN));
  conv2d_fused_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, bias, mean,
      var, static_cast<T*>(out), N, H, W, CI, CO, KH, KW, stride, pad_t,
      pad_l, Ho, Wo, act);
  return (int)cudaGetLastError();
}

// The A loader of the ffma schedule: the im2col gather of x (N, H, W, CI)
// fp32 NHWC, row m = output pixel (n, oh, ow), K index k = (dh, dw, ci).
struct Im2col {
  struct Args {
    const float* x;
    int M, H, W, CI, KW, stride, pad_t, pad_l, Ho, Wo;
  };
  const float* x;
  int H, W, CI, KW;
  int img[2];                        // the rows' image offsets, -1 past M
  int ih0[2], iw0[2];                // their top-left input pixel

  __device__ Im2col(const Args& a, int m0, int tid)
      : x(a.x), H(a.H), W(a.W), CI(a.CI), KW(a.KW) {
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int m = m0 + (tid >> 2) + 64 * p;
      const int hw = a.Ho * a.Wo;
      const int n = m / hw, r = m - n * hw;
      const int oh = r / a.Wo, ow = r - oh * a.Wo;
      img[p] = m < a.M ? n * a.H * a.W * a.CI : -1;
      ih0[p] = oh * a.stride - a.pad_t;
      iw0[p] = ow * a.stride - a.pad_l;
    }
  }
  __device__ const float* src(int p, int k) const {
    const int tap = k / CI, ci = k - tap * CI;
    const int dh = tap / KW, dw = tap - dh * KW;
    const int ih = ih0[p] + dh, iw = iw0[p] + dw;
    if (img[p] < 0 || ih < 0 || ih >= H || iw < 0 || iw >= W) return nullptr;
    return x + img[p] + (ih * W + iw) * CI + ci;
  }
};

}  // namespace

// C interface of the ffma schedule (bound with ctypes in
// kernels/_build.py): x, w and out fp32, 16-byte aligned, CI and CO
// multiples of 4 (the wrapper checks them); the batch-norm pointers as
// below.  K = KH KW CI is split in nsplit slabs of kc (a multiple of 16);
// with nsplit > 1, ws is an fp32 workspace of nsplit * M * CO floats.
// Returns the first CUDA error of the launches.
extern "C" int conv2d_ffma(const void* x, const void* w, const float* scale,
                           const float* bias, const float* mean,
                           const float* var, float* ws, void* out, int N,
                           int H, int W, int CI, int CO, int KH, int KW,
                           int stride, int pad_t, int pad_l, int Ho, int Wo,
                           int act, int kc, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kc % fp32tile::BK != 0) return (int)cudaErrorInvalidValue;
  const int M = N * Ho * Wo, K = KH * KW * CI;
  const Im2col::Args a{static_cast<const float*>(x), M, H, W, CI, KW,
                       stride, pad_t, pad_l, Ho, Wo};
  const rt::Epilogue epi{bias, scale, mean, var, act, 0};
  const float* wp = static_cast<const float*>(w);
  if (CO == 64)
    return fp32tile::launch<64, 1, float, Im2col>(a, wp, nullptr, epi, ws,
                                                  out, M, CO, K, kc, nsplit,
                                                  s);
  return fp32tile::launch<128, 1, float, Im2col>(a, wp, nullptr, epi, ws, out,
                                                 M, CO, K, kc, nsplit, s);
}

// C interface (bound with ctypes in kernels/_build.py).  dtype: 0 fp32,
// 1 bf16, for x, w and out alike.  The four BN pointers are all null when
// the conv has no batch-norm.  Returns cudaGetLastError() after the launch.
extern "C" int conv2d_fused(int dtype, const void* x, const void* w,
                            const float* scale, const float* bias,
                            const float* mean, const float* var, void* out,
                            int N, int H, int W, int CI, int CO, int KH,
                            int KW, int stride, int pad_t, int pad_l, int Ho,
                            int Wo, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(x, w, scale, bias, mean, var, out, N, H, W,
                                 CI, CO, KH, KW, stride, pad_t, pad_l, Ho, Wo,
                                 act, s);
  if (dtype == rt::kF32)
    return launch<float>(x, w, scale, bias, mean, var, out, N, H, W, CI, CO,
                         KH, KW, stride, pad_t, pad_l, Ho, Wo, act, s);
  return (int)cudaErrorInvalidValue;
}

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// conv2d_ffma at CO output channels; the simt kernel's static arrays,
// read off the compiled kernel.
extern "C" int conv2d_ffma_smem(int CO) {
  return CO == 64 ? fp32tile::Tile<64, 1>::SMEM_BYTES
                  : fp32tile::Tile<128, 1>::SMEM_BYTES;
}

extern "C" int conv2d_simt_smem() {
  cudaFuncAttributes a{};
  return cudaFuncGetAttributes(&a, conv2d_fused_kernel<float>) == cudaSuccess
             ? (int)a.sharedSizeBytes
             : -1;
}
