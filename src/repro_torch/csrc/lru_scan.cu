// lru_scan: h_t = a_t * h_{t-1} + b_t over (B, S, W), h_0 = 0, the state in
// fp32.  Replaces the Pallas kernel lru_scan of src/repro/kernels/lru_scan.py;
// see src/repro_torch/kernels/lru_scan.py for the design note, the launch
// geometry (scan_geometry) and the plain PyTorch version it is held against.
//
// a, b and h (B, S, W), contiguous, in one dtype.  Two schedules:
//
// lru_scan_chunked ("chunked"): a block is a strip of 128 bytes of channels
// (32 fp32, 64 bf16: 4 bytes a lane) of one batch row, by C = TS / 8 warps
// along S.  It walks S in windows of TS steps, staged in shared memory by
// 16-byte cp.async through a ring of NSTAGE windows (the loads of the next
// NSTAGE - 1 windows are in flight while one is scanned).  In a window, warp
// c scans its L = 8 steps to its chunk's product P_c and local end H_c; after
// a barrier every warp folds the C (P, H) pairs in order into the window's
// carry-in (the same arithmetic in every warp, so all agree on the next
// window's carry), stopping at its own to take its carry-in; then it rescans
// its steps from that carry and writes h, 128 contiguous bytes a warp a
// step.  W * elem must be a multiple of 16 and the pointers 16-byte aligned
// (the wrapper checks), so a 16-byte chunk is wholly inside or outside W.
//
// lru_scan ("seq", the kernel before it): one thread a (b, w) channel,
// 128 channels a block, walking S in order with its state in a register and
// the next UNROLL steps' a and b loaded ahead.  It takes what the chunked
// schedule does not (W * elem not a multiple of 16, unaligned operands).
#include "common.cuh"

namespace {

using namespace rt;

// ---------------------------------------------------------------- chunked

constexpr int STEPS_A_WARP = 8;   // L: a warp's steps of a window
constexpr int NSTAGE = 3;         // windows in the cp.async ring
constexpr int ROW_BYTES = 128;    // a strip's bytes a step

// The 4 bytes a lane owns of one step: 1 fp32 channel or 2 bf16 channels,
// as fp32.
template <typename T>
struct Lane;
template <>
struct Lane<float> {
  static constexpr int V = 1;
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = *p; }
  __device__ static void store(float* p, const float (&v)[1]) { *p = v[0]; }
};
template <>
struct Lane<__nv_bfloat16> {
  static constexpr int V = 2;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[2]) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    v[0] = f.x;
    v[1] = f.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float (&v)[2]) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v[0], v[1]);
  }
};

template <int TS, typename T>
constexpr size_t chunked_smem() {
  return (size_t)NSTAGE * 2 * TS * ROW_BYTES +
         (size_t)2 * (TS / STEPS_A_WARP) * 32 * Lane<T>::V * sizeof(float);
}

template <typename T, int TS>
__global__ void __launch_bounds__(TS / STEPS_A_WARP * 32)
lru_scan_chunked_kernel(const T* __restrict__ a, const T* __restrict__ b,
                        T* __restrict__ h, int S, int W) {
  constexpr int C = TS / STEPS_A_WARP;         // warps
  constexpr int NT = C * 32;
  constexpr int V = Lane<T>::V;
  constexpr int SW = ROW_BYTES / sizeof(T);    // strip channels
  constexpr int EC = 16 / sizeof(T);           // channels a 16-byte chunk
  constexpr int CPR = ROW_BYTES / 16;          // chunks a row
  extern __shared__ __align__(16) unsigned char smem[];
  T* sa = reinterpret_cast<T*>(smem);                      // [NSTAGE][TS][SW]
  T* sb = sa + NSTAGE * TS * SW;
  float* sP = reinterpret_cast<float*>(sb + NSTAGE * TS * SW);  // [C][32 V]
  float* sH = sP + C * 32 * V;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int w0 = blockIdx.x * SW;
  const size_t base = (size_t)blockIdx.y * S * W + w0;
  const int nwin = (S + TS - 1) / TS;
  const bool lane_in = w0 + lane * V < W;

  auto load_window = [&](int win) {
    if (win < nwin) {
      const int slot = win % NSTAGE;
      for (int i = tid; i < TS * CPR; i += NT) {
        const int row = i / CPR, c = i % CPR;
        const int t = win * TS + row;
        const bool ok = t < S && w0 + c * EC < W;
        const size_t off = base + (size_t)(ok ? t : 0) * W + c * EC;
        const int dst = (slot * TS + row) * SW + c * EC;
        cp_async16(sa + dst, a + (ok ? off : 0), ok ? 16 : 0);
        cp_async16(sb + dst, b + (ok ? off : 0), ok ? 16 : 0);
      }
    }
    cp_async_commit();                 // an empty group past the end
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) load_window(s);

  float carry[V];
#pragma unroll
  for (int v = 0; v < V; ++v) carry[v] = 0.0f;

  for (int win = 0; win < nwin; ++win) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();                   // the window landed; the slot of
    load_window(win + NSTAGE - 1);     // win - 1 and sP/sH are free
    const int slot = win % NSTAGE;
    const T* wa = sa + (slot * TS + warp * STEPS_A_WARP) * SW + lane * V;
    const T* wb = sb + (slot * TS + warp * STEPS_A_WARP) * SW + lane * V;

    // pass 1: this warp's chunk, from zero: its product and its end
    float P[V], Hc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) P[v] = 1.0f, Hc[v] = 0.0f;
#pragma unroll
    for (int j = 0; j < STEPS_A_WARP; ++j) {
      float av[V], bv[V];
      Lane<T>::load(wa + j * SW, av);
      Lane<T>::load(wb + j * SW, bv);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        Hc[v] = fmaf(av[v], Hc[v], bv[v]);
        P[v] *= av[v];
      }
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
      sP[(warp * 32 + lane) * V + v] = P[v];
      sH[(warp * 32 + lane) * V + v] = Hc[v];
    }
    __syncthreads();

    // the carries: chunk c starts from the window's carry folded through
    // chunks 0 .. c-1; the last fold is the next window's carry
    float cin[V];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (c == warp) {
#pragma unroll
        for (int v = 0; v < V; ++v) cin[v] = carry[v];
      }
#pragma unroll
      for (int v = 0; v < V; ++v)
        carry[v] = fmaf(sP[(c * 32 + lane) * V + v], carry[v],
                        sH[(c * 32 + lane) * V + v]);
    }

    // pass 2: rescan from the carry-in and write h
    const int t0 = win * TS + warp * STEPS_A_WARP;
    T* hp = h + base + (size_t)t0 * W + lane * V;
#pragma unroll
    for (int j = 0; j < STEPS_A_WARP; ++j) {
      float av[V], bv[V];
      Lane<T>::load(wa + j * SW, av);
      Lane<T>::load(wb + j * SW, bv);
#pragma unroll
      for (int v = 0; v < V; ++v) cin[v] = fmaf(av[v], cin[v], bv[v]);
      if (lane_in && t0 + j < S) Lane<T>::store(hp + (size_t)j * W, cin);
    }
  }
  cp_async_wait<0>();
}

template <typename T, int TS>
int launch_chunked(const void* a, const void* b, void* h, int B, int S,
                   int W, cudaStream_t stream) {
  constexpr size_t smem = chunked_smem<TS, T>();
  auto kern = lru_scan_chunked_kernel<T, TS>;
  static bool opted = false;             // the opt-in, once a kernel
  if (smem > 48 * 1024 && !opted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted = true;
  }
  constexpr int SW = ROW_BYTES / sizeof(T);
  dim3 grid((unsigned)((W + SW - 1) / SW), (unsigned)B);
  kern<<<grid, TS / STEPS_A_WARP * 32, smem, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(h),
      S, W);
  return (int)cudaGetLastError();
}

template <typename T>
int chunked(int steps, const void* a, const void* b, void* h, int B, int S,
            int W, cudaStream_t s) {
  switch (steps) {
    case 32: return launch_chunked<T, 32>(a, b, h, B, S, W, s);
    case 64: return launch_chunked<T, 64>(a, b, h, B, S, W, s);
    case 128: return launch_chunked<T, 128>(a, b, h, B, S, W, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// -------------------------------------------------------------------- seq

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

// The chunked schedule: steps (TS) is 32, 64 or 128, from the wrapper's
// scan_geometry; W * elem a multiple of 16, a, b and h 16-byte aligned.
extern "C" int lru_scan_chunked(int dtype, const void* a, const void* b,
                                void* h, int B, int S, int W, int steps,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == rt::kF32) {
    if (W % 4 != 0) return (int)cudaErrorInvalidValue;
    return chunked<float>(steps, a, b, h, B, S, W, s);
  }
  if (dtype == rt::kBF16) {
    if (W % 8 != 0) return (int)cudaErrorInvalidValue;
    return chunked<__nv_bfloat16>(steps, a, b, h, B, S, W, s);
  }
  return (int)cudaErrorInvalidValue;
}
