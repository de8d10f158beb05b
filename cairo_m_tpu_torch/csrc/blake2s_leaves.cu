// Batched unkeyed BLAKE2s-256 over the lanes of a column stack (Merkle
// leaves and inner levels).
//
// Replaces the Pallas TPU kernel `_leaf_kernel` of
// cairo_m_tpu/hash/blake2s_pallas.py (built by `_leaf_call`, entered through
// `hash_leaves`).  Lane j hashes the message of words in[0][j] .. in[K-1][j]
// followed by (n_words - K) zero words, little-endian, and writes its digest
// to out[0..7][j].
//
// What bounds it on an H100: integer issue and memory traffic about
// equally.  One compression is ~980 32-bit integer machine operations (80 G
// functions of 12: three-input adds, xors, one funnel shift a rotation); at
// K = 16 a lane moves 24 int64 words (192 bytes), ~5 operations per byte, the
// card's INT32-rate-to-bandwidth balance.  (K = 16, n = 2^20 takes 0.081 ms
// on an H100 80GB HBM3 at 700 W: ~76% of the INT32 issue rate and ~74% of
// HBM bandwidth.)  A 32-bit carrier would halve the bytes and leave
// it compute-bound.  The design keeps the 16-word state and
// the message block in registers (the SIGMA schedule is unrolled with
// literal indices so no local-memory array is ever indexed at run time),
// runs one thread per lane so nothing is shared, and reads word k of lane j
// at k*n + j so each warp's loads and stores are coalesced.  The TPU's
// K <= 64 and n >= 1024 limits do not apply: K is a run-time argument and
// the grid covers any n >= 1.
//
// Words arrive as int64 (the port's carrier dtype) holding values below
// 2^32; the kernel truncates them to uint32 and does all arithmetic in
// unsigned 32-bit, so additions wrap and shifts are logical.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

#define G(a, b, c, d, x, y)      \
  do {                           \
    v[a] = v[a] + v[b] + (x);    \
    v[d] = rotr(v[d] ^ v[a], 16); \
    v[c] = v[c] + v[d];          \
    v[b] = rotr(v[b] ^ v[c], 12); \
    v[a] = v[a] + v[b] + (y);    \
    v[d] = rotr(v[d] ^ v[a], 8);  \
    v[c] = v[c] + v[d];          \
    v[b] = rotr(v[b] ^ v[c], 7);  \
  } while (0)

#define ROUND(s0, s1, s2, s3, s4, s5, s6, s7, s8, s9, s10, s11, s12, s13, s14, s15) \
  do {                                  \
    G(0, 4, 8, 12, m[s0], m[s1]);       \
    G(1, 5, 9, 13, m[s2], m[s3]);       \
    G(2, 6, 10, 14, m[s4], m[s5]);      \
    G(3, 7, 11, 15, m[s6], m[s7]);      \
    G(0, 5, 10, 15, m[s8], m[s9]);      \
    G(1, 6, 11, 12, m[s10], m[s11]);    \
    G(2, 7, 8, 13, m[s12], m[s13]);     \
    G(3, 4, 9, 14, m[s14], m[s15]);     \
  } while (0)

__constant__ uint32_t kIV[8] = {
    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
    0x510E527Fu, 0x9B05688Cu, 0x1F83D9ABu, 0x5BE0CD19u,
};

__device__ __forceinline__ void compress(uint32_t h[8], const uint32_t m[16],
                                         uint32_t t, bool last) {
  uint32_t v[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = h[i];
    v[i + 8] = kIV[i];
  }
  v[12] ^= t;  // byte counter; its high word stays 0 (messages < 4 GiB)
  if (last) v[14] = ~v[14];
  ROUND(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);
  ROUND(14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3);
  ROUND(11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4);
  ROUND(7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8);
  ROUND(9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13);
  ROUND(2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9);
  ROUND(12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11);
  ROUND(13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10);
  ROUND(6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5);
  ROUND(10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] ^= v[i] ^ v[i + 8];
}

__global__ void blake2s_leaves_kernel(const int64_t* __restrict__ in,
                                      int64_t* __restrict__ out, int64_t n,
                                      int32_t k, int32_t n_words) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n) return;
  uint32_t h[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = kIV[i];
  h[0] ^= 0x01010020u;  // digest length 32, fanout 1, depth 1
  const int32_t n_blocks = n_words > 16 ? (n_words + 15) / 16 : 1;
  for (int32_t blk = 0; blk < n_blocks; ++blk) {
    uint32_t m[16];
#pragma unroll
    for (int w = 0; w < 16; ++w) {
      const int32_t word = blk * 16 + w;
      m[w] = word < k ? (uint32_t)in[(int64_t)word * n + j] : 0u;
    }
    const bool last = blk == n_blocks - 1;
    const uint32_t t = last ? 4u * (uint32_t)n_words : 64u * (uint32_t)(blk + 1);
    compress(h, m, t, last);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[(int64_t)i * n + j] = (int64_t)h[i];
}

}  // namespace

// in: (k, n) int64 words; out: (8, n) int64 digest words.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int cm_blake2s_leaves(const int64_t* in, int64_t* out, int64_t n,
                                 int32_t k, int32_t n_words, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (n + threads - 1) / threads;
  blake2s_leaves_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      in, out, n, k, n_words);
  return (int)cudaGetLastError();
}
