// Batched unkeyed BLAKE2s-256 over the lanes of a column stack (Merkle
// leaves).
//
// Replaces the Pallas TPU kernel `_leaf_kernel` of
// cairo_m_tpu/hash/blake2s_pallas.py (built by `_leaf_call`, entered through
// `hash_leaves`) for leaf messages; the inner levels of a tree, which the
// TPU sent through the same kernel one level at a time, are
// blake2s_pyramid.cu's.  Lane j hashes the message of words in[0][j] ..
// in[K-1][j] followed by (n_words - K) zero words, little-endian, and writes
// its digest to out[0..7][j], the rows of `out` being `out_stride` words
// apart (so a leaf pass can write into the first columns of a packed
// pyramid).
//
// What bounds it on an H100: integer issue and memory traffic about
// equally.  One compression is ~980 integer operations
// (blake2s_compress.cuh); at K = 16 a lane moves 24 int64 words (192 bytes),
// ~5 operations per byte, the card's INT32-rate-to-bandwidth balance.  The
// design runs one thread per lane so nothing is shared, and reads word k of
// lane j at k*n + j so each warp's loads and stores are coalesced.  A
// message of more than one block (K > 16) at few lanes is one warp's serial
// chain: its kernel loads the next block's 16 words before it compresses
// the current one, so the chain is the arithmetic and not 16 loads' latency
// a block besides.  What is left is one warp scheduler's integer rate: a
// compression's ~980 instructions at two cycles each, ~1.1 us.  Splitting
// a lane over four threads of the warp would not shorten that: they share
// the scheduler.  The one-block kernel (K <= 16) keeps its 16 message
// registers.  The TPU's K <= 64 and n >= 1024 limits do not apply: K is a
// run-time argument and the grid covers any n >= 1.  Times beside the
// bounds are in PERF.md.
//
// Words arrive as int64 (the port's carrier dtype) holding values below
// 2^32; the kernel truncates them to uint32 and does all arithmetic in
// unsigned 32-bit, so additions wrap and shifts are logical.

#include "blake2s_compress.cuh"

namespace {

__device__ __forceinline__ void load_block(uint32_t m[16],
                                           const int64_t* __restrict__ in,
                                           int64_t n, int64_t j, int32_t k,
                                           int32_t blk) {
#pragma unroll
  for (int w = 0; w < 16; ++w) {
    const int32_t word = blk * 16 + w;
    m[w] = word < k ? (uint32_t)in[(int64_t)word * n + j] : 0u;
  }
}

// kLong = false: messages of one block.  kLong = true: any length, the next
// block's words in flight while the current block is compressed.
template <bool kLong>
__global__ void blake2s_leaves_kernel(const int64_t* __restrict__ in,
                                      int64_t* __restrict__ out, int64_t n,
                                      int64_t out_stride, int32_t k,
                                      int32_t n_words) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t h[8];
  init_state(h);
  uint32_t m[16];
  load_block(m, in, n, j, k, 0);
  if (kLong) {
    const int32_t n_blocks = (n_words + 15) / 16;
    for (int32_t blk = 0; blk + 1 < n_blocks; ++blk) {
      uint32_t next[16];
      load_block(next, in, n, j, k, blk + 1);
      compress(h, m, 64u * (uint32_t)(blk + 1), false);
#pragma unroll
      for (int w = 0; w < 16; ++w) m[w] = next[w];
    }
  }
  compress(h, m, 4u * (uint32_t)n_words, true);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(int64_t)i * out_stride + j] = (int64_t)h[i];
}

}  // namespace

// in: (k, n) int64 words; out: (8, n) int64 digest words, row i at
// out + i * out_stride.  Returns the CUDA error of the launch (0 on success).
extern "C" int cm_blake2s_leaves(const int64_t* in, int64_t* out, int64_t n,
                                 int64_t out_stride, int32_t k,
                                 int32_t n_words, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  if (n_words > 16)
    blake2s_leaves_kernel<true><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        in, out, n, out_stride, k, n_words);
  else
    blake2s_leaves_kernel<false><<<blocks, threads, 0, (cudaStream_t)stream>>>(
        in, out, n, out_stride, k, n_words);
  return (int)cudaGetLastError();
}
