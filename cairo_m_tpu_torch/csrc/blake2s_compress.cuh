// The BLAKE2s compression function, in registers, for the kernels of
// blake2s_leaves.cu and blake2s_pyramid.cu.
//
// The 16-word state and the message block live in registers: the SIGMA
// schedule is unrolled with literal indices, so no local-memory array is
// ever indexed at run time.  One compression is ~980 32-bit integer machine
// operations (80 G functions of 12: three-input adds, xors, one funnel shift
// a rotation) on a dependent chain of ~240 (the four G functions of a
// half-round are independent, the 20 half-rounds are not).

#pragma once

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

// h = the chaining value of an unkeyed BLAKE2s-256 before its first block
__device__ __forceinline__ void init_state(uint32_t h[8]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = kIV[i];
  h[0] ^= 0x01010020u;  // digest length 32, fanout 1, depth 1
}

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

}  // namespace
