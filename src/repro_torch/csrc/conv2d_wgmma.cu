// conv2d_wgmma: the bf16 schedule of conv2d_fused on Hopper's tensor cores,
// an implicit GEMM with the inference batch-norm fold and the activation
// applied in registers before the single write.  Replaces the Pallas kernel
// conv2d_fused of src/repro/kernels/conv2d.py for bf16 convs with CI a
// multiple of 64 and CO a multiple of 8 (every ResNet-34 conv but the 7x7
// stem; MobileNetV1's pointwise convs from 64 channels up).  The schedule
// choice, the split and the plain version are in
// src/repro_torch/kernels/conv2d.py.
//
//   GEMM view (as conv2d_fused.cu): M = N*Ho*Wo output pixels,
//   K = kh*kw*CI ordered (dh, dw, ci), N = CO;
//   A[m, k] = x[n, oh*s - pad_t + dh, ow*s - pad_l + dw, ci], 0 outside;
//   B[k, c] = w viewed as (kh*kw*CI, CO): HWIO is already that matrix.
//
// What bounds it: the operations at most ResNet-34 shapes (a 3x3 conv at
// batch 8 does 100-300 flops a byte, near or above the H100's bf16 ridge of
// ~295), and only wgmma reaches the tensor cores' rate.
//
// The design: a block of two warpgroups owns a 128 x BN output tile (BN 64
// when CO is 64, else 128), 64 rows a warpgroup on wgmma m64nBNk16 with fp32
// accumulators in registers, two blocks an SM.  K walks 64-deep stages
// through a 3-slot ring; as CI % 64 == 0 a stage is one tap (dh, dw) x 64
// channels, so each output pixel's A row of the stage is 128 contiguous
// bytes of x, or zeros where the tap falls in the padding (a predicate with
// XLA's low/high split: the input is never padded in memory).  Every thread
// gathers with 16-byte cp.async (src-size 0 for the zeros) into the layout a
// 128-byte-swizzled TMA box would write (chunk j of row r at j ^ (r & 7)),
// and loads w's 64 x BN stage the same way as the MN-major 64 x 64 boxes of
// matmul_wgmma.cu, so the descriptors and the wgmma of matmul_wgmma.cu
// (hopper::stage_mma) apply unchanged.  A stage's gather is issued right
// after the previous stage's wgmmas, so the address arithmetic and the
// loads overlap the tensor cores; a fence.proxy.async makes the landed
// stage visible to wgmma.  A grid under half a wave splits K over the taps
// (grid z): each block writes fp32 partials that rt::splitk_reduce sums in a
// fixed order (the bits repeat) before the fold and act.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128;            // rows a block: two warpgroups
constexpr int BK = 64;             // K a stage: one tap x 64 channels
constexpr int THREADS = 256;
constexpr int STAGES = 3;
constexpr int A_BYTES = BM * BK * 2;              // 16 KB
constexpr int BOX_BYTES = BK * 64 * 2;            // one 64 x 64 w box, 8 KB

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return A_BYTES + (BN / 64) * BOX_BYTES;
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {
  return STAGES * stage_bytes<BN>() + 1024;       // + the 1024-byte alignment
}

struct Geom {
  int M, K, H, W, CI, CO, KW, stride, pad_t, pad_l, Ho, Wo;
};

template <int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv2d_wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                    rt::Epilogue epi, float* __restrict__ ws,
                    bf16* __restrict__ out, Geom g, int kc) {
  constexpr int STAGE = stage_bytes<BN>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  __shared__ rt::EpilogueCols<BN> cols;
  // the swizzled tiles need 1024-byte aligned slots
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  if (gridDim.z == 1) cols.stage(epi, n0, g.CO);
  const int kbeg = blockIdx.z * kc, kend = min(g.K, kbeg + kc);
  const int nst = (kend - kbeg) / BK;             // K, kc multiples of 64

  // the gather: chunk j = tid % 8 (channels 8j .. 8j + 7 of the stage) of
  // rows tid / 8 + 32 p; their image offsets (-1 past M) and top-left input
  // pixels
  const int j = tid & 7;
  int img[4], ih0[4], iw0[4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    const int m = m0 + (tid >> 3) + 32 * p;
    const int hw = g.Ho * g.Wo;
    const int n = m / hw, r = m - n * hw;
    const int oh = r / g.Wo, ow = r - oh * g.Wo;
    img[p] = m < g.M ? n * g.H * g.W * g.CI : -1;
    ih0[p] = oh * g.stride - g.pad_t;
    iw0[p] = ow * g.stride - g.pad_l;
  }

  auto load = [&](int st, int slot) {
    const int k0 = kbeg + st * BK;
    const int tap = k0 / g.CI, ci = k0 - tap * g.CI + 8 * j;
    const int dh = tap / g.KW, dw = tap - dh * g.KW;
    const uint32_t a = base + slot * STAGE;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int r = (tid >> 3) + 32 * p;
      const int ih = ih0[p] + dh, iw = iw0[p] + dw;
      const bool ok = img[p] >= 0 && ih >= 0 && ih < g.H && iw >= 0 &&
                      iw < g.W;
      const bf16* src = ok ? x + img[p] + (ih * g.W + iw) * g.CI + ci : x;
      cp_async16(a + r * 128 + ((j ^ (r & 7)) << 4), src, ok ? 16 : 0);
    }
    // w: 64 K rows x BN / 8 chunks, box c / 8 of 64 columns
    const uint32_t b = a + A_BYTES;
    constexpr int CH = BN / 8;
#pragma unroll
    for (int it = 0; it < BK * CH / THREADS; ++it) {
      const int i = tid + it * THREADS;
      const int r = i / CH, c = i % CH;
      const int n = n0 + 8 * c;
      const bool ok = n < g.CO;                   // CO % 8 == 0
      const bf16* src = ok ? w + (size_t)(k0 + r) * g.CO + n : w;
      cp_async16(b + (c >> 3) * BOX_BYTES + r * 128 +
                     (((c & 7) ^ (r & 7)) << 4),
                 src, ok ? 16 : 0);
    }
  };

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nst) load(s, s);
    rt::cp_async_commit();
  }
  const int wg = tid / 128;
  for (int kt = 0; kt < nst; ++kt) {
    rt::cp_async_wait<STAGES - 2>();   // this thread's part of stage kt
    fence_proxy_async();               // ... visible to wgmma
    __syncthreads();                   // every thread's; slot kt-1 free
    const uint32_t a = base + (kt % STAGES) * STAGE;
    wgmma_fence();
    stage_mma<BN>(acc, a + wg * (A_BYTES / 2), a + A_BYTES);
    wgmma_commit();
    const int nx = kt + STAGES - 1;    // gather ahead while wgmma runs
    if (nx < nst) load(nx, nx % STAGES);
    rt::cp_async_commit();
    wgmma_wait<0>();
  }
  rt::cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) fence_operand(acc[i]);
  __syncthreads();                     // the staged columns

  // epilogue: fragment i of a thread holds row 16 warp + lane/4 (+8 for
  // i % 4 >= 2), column 8 (i / 4) + 2 (lane % 4) + i % 2
  const int t = tid % 128, warp = t / 32, lane = t % 32;
  const int r0 = m0 + wg * 64 + warp * 16 + lane / 4;
  const size_t MN = (size_t)g.M * g.CO;
#pragma unroll
  for (int jj = 0; jj < BN / 8; ++jj) {
    const int c = n0 + jj * 8 + (lane % 4) * 2;
    if (c >= g.CO) continue;           // CO % 8 == 0: c + 1 < CO as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + h * 8;
      if (r >= g.M) continue;
      const float v0 = acc[4 * jj + 2 * h], v1 = acc[4 * jj + 2 * h + 1];
      if (gridDim.z > 1) {
        *reinterpret_cast<float2*>(ws + blockIdx.z * MN + (size_t)r * g.CO +
                                   c) = make_float2(v0, v1);
      } else {
        const float y0 = cols.template apply<false>(epi, v0, 0.0f, c - n0);
        const float y1 =
            cols.template apply<false>(epi, v1, 0.0f, c - n0 + 1);
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * g.CO + c) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
  }
}

template <int BN>
int launch(const bf16* x, const bf16* w, const rt::Epilogue& epi, float* ws,
           bf16* out, const Geom& g, int kc, int nsplit, cudaStream_t s) {
  auto kern = conv2d_wgmma_kernel<BN>;
  constexpr int smem = smem_bytes<BN>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((g.M + BM - 1) / BM), (unsigned)((g.CO + BN - 1) / BN),
            (unsigned)nsplit);
  kern<<<grid, THREADS, smem, s>>>(x, w, epi, ws, out, g, kc);
  e = cudaGetLastError();
  if (e != cudaSuccess || nsplit == 1) return (int)e;
  return rt::launch_splitk_reduce<bf16>(ws, epi, out, g.M, g.CO, nsplit,
                                        false, s);
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  x (N, H, W, CI)
// NHWC, w (KH, KW, CI, CO) HWIO and out (N, Ho, Wo, CO) are bf16, 16-byte
// aligned, CI % 64 == 0 and CO % 8 == 0 (the wrapper checks them).  The
// four batch-norm pointers (fp32, (CO,)) are all null when the conv has no
// batch norm.  K = KH KW CI is split in nsplit slabs of kc rows (kc a
// multiple of 64); with nsplit > 1, ws is an fp32 workspace of
// nsplit * M * CO floats (M = N Ho Wo).  Returns the first CUDA error of
// the launches.
extern "C" int conv2d_wgmma(const void* x, const void* w, const float* scale,
                            const float* bias, const float* mean,
                            const float* var, float* ws, void* out, int N,
                            int H, int W, int CI, int CO, int KH, int KW,
                            int stride, int pad_t, int pad_l, int Ho, int Wo,
                            int act, int kc, int nsplit, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (CI % BK != 0 || CO % 8 != 0 || kc % BK != 0 || nsplit < 1 ||
      (nsplit > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const Geom g{N * Ho * Wo, KH * KW * CI, H, W, CI, CO, KW, stride,
               pad_t, pad_l, Ho, Wo};
  const rt::Epilogue epi{bias, scale, mean, var, act, 0};
  const bf16* xp = static_cast<const bf16*>(x);
  const bf16* wp = static_cast<const bf16*>(w);
  bf16* op = static_cast<bf16*>(out);
  if (CO == 64)
    return launch<64>(xp, wp, epi, ws, op, g, kc, nsplit, s);
  return launch<128>(xp, wp, epi, ws, op, g, kc, nsplit, s);
}

// The shared bytes a block asks for, for the static verifier's K202
// (kernels/workingset.py mirrors them for a machine with no card and
// chip_smoke.py holds the mirror to these), or -1 for a shape the
// kernel does not take.
// CO output channels (BN 64 at 64, else 128, as conv2d_wgmma picks).
extern "C" int conv2d_wgmma_smem(int CO) {
  return CO == 64 ? smem_bytes<64>() : smem_bytes<128>();
}
