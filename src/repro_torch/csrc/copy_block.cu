// copy_block: the copy-on-write fork of the paged KV pool.  Pool block dst
// := block src, in place, in every rep of a (R, NB, block) pool at once.
// Replaces the Pallas kernel copy_block of
// src/repro/kernels/decode_attention.py; see
// src/repro_torch/kernels/decode_attention.py for the note and the plain
// PyTorch version it is held against.
#include <cuda_runtime.h>

namespace {

constexpr int CB_THREADS = 256;
constexpr int CB_MAX_CHUNKS = 64;   // blocks per rep at most

// One grid row per rep; its blocks stride over the block's units (16-byte
// vectors where the sizes allow, else bytes).
template <typename V>
__global__ void __launch_bounds__(CB_THREADS)
copy_block_kernel(unsigned char* __restrict__ pool, long long rep_bytes,
                  long long block_bytes, long long src, long long dst) {
  unsigned char* base = pool + (long long)blockIdx.y * rep_bytes;
  const V* from = reinterpret_cast<const V*>(base + src * block_bytes);
  V* to = reinterpret_cast<V*>(base + dst * block_bytes);
  const long long n = block_bytes / (long long)sizeof(V);
  for (long long i = (long long)blockIdx.x * CB_THREADS + threadIdx.x; i < n;
       i += (long long)gridDim.x * CB_THREADS)
    to[i] = from[i];
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  pool holds R reps
// of NB blocks of block_bytes bytes each; src and dst in [0, NB).  Returns
// the launch's CUDA error, or 0.
extern "C" int copy_block(void* pool, int R, int NB, int block_bytes, int src,
                          int dst, void* stream) {
  if (R <= 0 || NB <= 0 || block_bytes <= 0 || src < 0 || src >= NB ||
      dst < 0 || dst >= NB)
    return (int)cudaErrorInvalidValue;
  if (src == dst) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rep = (long long)NB * block_bytes;
  const bool vec = block_bytes % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(pool) % 16 == 0;
  const long long units = vec ? block_bytes / 16 : block_bytes;
  long long chunks = (units + CB_THREADS - 1) / CB_THREADS;
  if (chunks > CB_MAX_CHUNKS) chunks = CB_MAX_CHUNKS;
  const dim3 grid((unsigned)chunks, (unsigned)R);
  unsigned char* p = static_cast<unsigned char*>(pool);
  if (vec)
    copy_block_kernel<uint4><<<grid, CB_THREADS, 0, s>>>(p, rep, block_bytes, src, dst);
  else
    copy_block_kernel<unsigned char><<<grid, CB_THREADS, 0, s>>>(p, rep, block_bytes, src, dst);
  return (int)cudaGetLastError();
}
