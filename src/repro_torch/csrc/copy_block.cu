// copy_block: the copy-on-write fork of the paged KV pool.  Pool block dst
// := block src, in place, in every rep of a (R, NB, block) pool, and in the
// K and the V pool of a paged entry together: one launch a fork.
// Replaces the Pallas kernel copy_block of
// src/repro/kernels/decode_attention.py; see
// src/repro_torch/kernels/decode_attention.py for the note and the plain
// PyTorch version it is held against.
//
// What bounds it: the bytes, and at a fork's size (a 16-rep llama3.2-1b
// block pair: 2 x 16 x 16 KB in bf16) the launch.  So one launch moves both
// pools: a grid over (chunk, rep, pool), one 16-byte vector a thread where
// the sizes allow (else one byte), 128 threads a block, so that the pair
// gives 256 blocks in bf16, at least one on each of the 132 SMs.
#include <cuda_runtime.h>

namespace {

constexpr int CB_THREADS = 128;

template <typename V>
__global__ void __launch_bounds__(CB_THREADS)
copy_block_kernel(unsigned char* pool0, unsigned char* pool1,
                  long long rep_bytes, long long block_bytes, long long src,
                  long long dst) {
  const long long i = (long long)blockIdx.x * CB_THREADS + threadIdx.x;
  if (i >= block_bytes / (long long)sizeof(V)) return;
  unsigned char* base =
      (blockIdx.z ? pool1 : pool0) + (long long)blockIdx.y * rep_bytes;
  reinterpret_cast<V*>(base + dst * block_bytes)[i] =
      reinterpret_cast<const V*>(base + src * block_bytes)[i];
}

}  // namespace

// C interface (bound with ctypes in kernels/_build.py).  pool holds R reps
// of NB blocks of block_bytes bytes each; pool2, null or a second pool of
// the same shape (the V pool beside the K pool), is copied in the same
// launch; src and dst in [0, NB).  Returns the launch's CUDA error, or 0.
extern "C" int copy_block(void* pool, void* pool2, int R, int NB,
                          int block_bytes, int src, int dst, void* stream) {
  if (pool == nullptr || R <= 0 || R > 65535 || NB <= 0 || block_bytes <= 0 ||
      src < 0 || src >= NB || dst < 0 || dst >= NB)
    return (int)cudaErrorInvalidValue;
  if (src == dst) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long rep = (long long)NB * block_bytes;
  auto aligned = [](const void* p) {
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
  };
  const bool vec = block_bytes % 16 == 0 && aligned(pool) &&
                   (pool2 == nullptr || aligned(pool2));
  const long long units = vec ? block_bytes / 16 : block_bytes;
  const dim3 grid((unsigned)((units + CB_THREADS - 1) / CB_THREADS),
                  (unsigned)R, pool2 != nullptr ? 2u : 1u);
  unsigned char* p0 = static_cast<unsigned char*>(pool);
  unsigned char* p1 = static_cast<unsigned char*>(pool2);
  if (vec)
    copy_block_kernel<uint4><<<grid, CB_THREADS, 0, s>>>(p0, p1, rep,
                                                         block_bytes, src, dst);
  else
    copy_block_kernel<unsigned char><<<grid, CB_THREADS, 0, s>>>(
        p0, p1, rep, block_bytes, src, dst);
  return (int)cudaGetLastError();
}
