// The inner levels of a BLAKE2s Merkle tree, a whole sub-pyramid per block.
//
// Replaces, for inner nodes, the Pallas TPU kernel `_leaf_kernel` of
// cairo_m_tpu/hash/blake2s_pallas.py: the TPU hashed a tree one level at a
// time (`_hash_inner_fast` of cairo_m_tpu/prover/stark/merkle.py: an XLA
// copy of the level into a (16, m/2) message stack, then the leaf kernel)
// and finished the top ten levels on the host.  Parent i of a level is the
// unkeyed BLAKE2s-256 of its left child's 8 digest words followed by its
// right child's: one 64-byte block, byte counter 64, last-block flag set.
//
// The tree is one packed tensor of 8 word-rows: columns [0, n) the leaf
// digests, then the n/2 nodes of level 1, ... , the root in column 2n - 2.
// A launch takes a level of m digests at column `in_off` and writes the
// levels above it in place.  Each block of 256 threads takes C = min(2^L, m)
// adjacent children and climbs log2(C) levels.  For the first of them a
// thread reads its two children straight from device memory (adjacent
// words, so a warp reads whole lines; no one else reads them) and loops
// where the level has more parents than the block has threads; every parent
// goes to the packed tensor in device memory (coalesced) and, as uint32, to
// shared memory.  The levels above read their children from there as one
// 64-bit word per word-row (no bank conflict, where two 32-bit reads at
// stride 2 would have two-way ones) and write to the other of two shared
// buffers, with one block barrier a level.  No message stack is ever built,
// and a level is read from device memory only by the launch that starts
// from it.
//
// What bounds it on an H100: the integer instruction rate.  m - 1
// compressions of ~980 operations against (2m - 1) * 64 bytes in the int64
// carrier: ~7.7 operations a byte, above the card's balance of ~5.  One warp
// alone keeps its scheduler's integer pipe busy (a compression's ~980
// instructions take two cycles each, ~1.1 us; its dependent chain is
// shorter), so what the design can lose is scheduler slots spent on warps
// with few live lanes (every level of fewer than 32 parents costs a whole
// warp's instructions) and schedulers left idle: the single live warp of a
// block's upper levels is a different warp slot from block to block, so the
// resident blocks' tails spread over the SM's four schedulers.  A tree is
// also a chain: log2(n) compressions, one after the other, ~1.1 us each,
// whatever the width.  Hence the two tile sizes: 2^11 children a block where
// the level is wide (m >= 2^18: 3% of the instructions run in partly filled
// warps, against 25% at 2^9), and 2^9 where it is not, so that a small level
// spreads over more SMs.  A tree of 2^21 leaves takes 3 launches (1024
// blocks, 2 blocks, 1 block of 2 children), one of at most 2^9 leaves takes
// 1.  The launches of a tree follow each other on one stream, which is all
// the ordering the tiers need; a single launch in which the last block to
// finish a group carries on with the next tier would save one or two
// launches a tree at the price of a fence-and-counter protocol between
// blocks and a zeroed scratch of counters, and was not built.  Times beside
// the bounds are in PERF.md.

#include "blake2s_compress.cuh"

namespace {

// One parent: compress the two children's words, keep the digest in shared
// memory for the next level and write it to the packed pyramid.
__device__ __forceinline__ void hash_node(const uint32_t msg[16], uint32_t* dst,
                                          int dst_pitch, int i, int64_t* out,
                                          int64_t stride) {
  uint32_t h[8];
  init_state(h);
  compress(h, msg, 64u, true);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    dst[w * dst_pitch + i] = h[w];
    out[w * stride] = (int64_t)h[w];
  }
}

constexpr int T = 256;  // threads of a block

template <int LOGC>
__global__ void __launch_bounds__(T)
    blake2s_pyramid_kernel(int64_t* packed, int64_t stride, int64_t in_off,
                           int64_t m) {
  constexpr int C = 1 << LOGC;  // children a block takes
  __shared__ __align__(16) uint32_t buf_a[8 * (C / 2)];
  __shared__ __align__(16) uint32_t buf_b[8 * (C / 4)];
  const int c = m < C ? (int)m : C;
  // Lane index, rotated by whole warps from block to block: the upper levels
  // have one active warp, and it should not be the same warp slot (the same
  // scheduler of the SM) in every resident block.
  const int u = (threadIdx.x + 32 * (blockIdx.x % (T / 32))) % T;
  const int64_t base = in_off + (int64_t)blockIdx.x * c;
  int64_t level_off = in_off + m;  // first column of the level being written
  int64_t level_m = m >> 1;        // and its node count over all blocks

  // first level: children straight from device memory (read by no one else)
  int cnt = c >> 1;
  for (int i = u; i < cnt; i += T) {
    uint32_t msg[16];
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const int64_t* pair = packed + w * stride + base + 2 * i;
      msg[w] = (uint32_t)__ldg(pair);
      msg[8 + w] = (uint32_t)__ldg(pair + 1);
    }
    hash_node(msg, buf_a, C / 2, i,
              packed + level_off + (int64_t)blockIdx.x * cnt + i, stride);
  }
  __syncthreads();

  const uint32_t* src = buf_a;
  uint32_t* dst = buf_b;
  int src_pitch = C / 2, dst_pitch = C / 4;
  for (cnt >>= 1; cnt >= 1; cnt >>= 1) {
    level_off += level_m;
    level_m >>= 1;
    for (int i = u; i < cnt; i += T) {
      uint32_t msg[16];
#pragma unroll
      for (int w = 0; w < 8; ++w) {
        const uint2 pair =
            reinterpret_cast<const uint2*>(src + w * src_pitch)[i];
        msg[w] = pair.x;
        msg[8 + w] = pair.y;
      }
      hash_node(msg, dst, dst_pitch, i,
                packed + level_off + (int64_t)blockIdx.x * cnt + i, stride);
    }
    __syncthreads();
    // the parents just written are the next level's children; the buffer
    // just read is free (a level needs half the room of the one below)
    uint32_t* freed = const_cast<uint32_t*>(src);
    src = dst;
    dst = freed;
    const int pitch = src_pitch;
    src_pitch = dst_pitch;
    dst_pitch = pitch;
  }
}

template <int LOGC>
int launch(int64_t* packed, int64_t stride, int64_t in_off, int64_t m,
           cudaStream_t s) {
  const int64_t c = m < (1 << LOGC) ? m : (1 << LOGC);
  blake2s_pyramid_kernel<LOGC><<<(unsigned)(m / c), T, 0, s>>>(
      packed, stride, in_off, m);
  return (int)cudaGetLastError();
}

}  // namespace

// packed: (8, stride) int64, a level of m digests (m a power of two, m >= 2)
// at columns [in_off, in_off + m).  One launch: each block takes
// 2^log_tile children (log_tile is 9 or 11), climbs min(log_tile, log2(m))
// levels and writes them at their places in `packed`.  Returns the CUDA
// error of the launch (0 on success).
extern "C" int cm_blake2s_pyramid(int64_t* packed, int64_t stride,
                                  int64_t in_off, int64_t m, int32_t log_tile,
                                  void* stream) {
  if (m < 2 || (m & (m - 1)) != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (log_tile == 9) return launch<9>(packed, stride, in_off, m, s);
  if (log_tile == 11) return launch<11>(packed, stride, in_off, m, s);
  return (int)cudaErrorInvalidValue;
}
