// lru_scan: h_t = a_t * h_{t-1} + b_t over (B, S, W), h_0 = 0, the state in
// fp32.  Replaces the Pallas kernel lru_scan of src/repro/kernels/lru_scan.py;
// see src/repro_torch/kernels/lru_scan.py for the design note and the plain
// PyTorch version it is held against.
//
// a, b and h (B, S, W), contiguous, in one dtype.  One thread per (b, w)
// channel, 128 channels a block: grid (ceil(W / 128), B).  Each thread
// walks S in order with its state in a register, loading the next UNROLL
// steps' a and b before it runs their FMAs.
#include "common.cuh"

namespace {

using namespace rt;

constexpr int LTHREADS = 128;
constexpr int UNROLL = 16;        // time steps loaded ahead

template <typename T>
__global__ void __launch_bounds__(LTHREADS)
lru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                T* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * LTHREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* bp = b + base;
  T* hp = h + base;
  float state = 0.0f;
  int t = 0;
  for (; t + UNROLL <= S; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = to_f32(ap[(size_t)(t + u) * W]);
      bv[u] = to_f32(bp[(size_t)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      state = fmaf(av[u], state, bv[u]);
      hp[(size_t)(t + u) * W] = from_f32<T>(state);
    }
  }
  for (; t < S; ++t) {
    state = fmaf(to_f32(ap[(size_t)t * W]), state, to_f32(bp[(size_t)t * W]));
    hp[(size_t)t * W] = from_f32<T>(state);
  }
}

template <typename T>
int launch(const void* a, const void* b, void* h, int B, int S, int W,
           cudaStream_t stream) {
  dim3 grid((unsigned)((W + LTHREADS - 1) / LTHREADS), (unsigned)B);
  lru_scan_kernel<T><<<grid, LTHREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  dtype is that of a,
// b and h (0 fp32, 1 bf16).  Returns the CUDA error of the launch, or 0.
extern "C" int lru_scan(int dtype, const void* a, const void* b, void* h,
                        int B, int S, int W, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32) return launch<float>(a, b, h, B, S, W, s);
  if (dtype == rt::kBF16) return launch<__nv_bfloat16>(a, b, h, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
