// The witness of the `poseidon2` AIR component: for each of the 2^log rows,
// one Poseidon2-M31 permutation (T = 16, 8 full + 14 partial rounds) of the
// row's input state, written out as the component's 443 columns
// (prover/components/generic.py `poseidon2_round_columns`):
//     enabler, state (16),
//     4 full rounds x (sq1, sq2, out) (16 each),
//     14 partial rounds x (sq1, sq2, sbox),
//     4 full rounds x (sq1, sq2, out).
// Rows n .. 2^log hash the zero state with enabler 0, as the host writer
// pads.
//
// Replaces no Pallas kernel: the JAX package builds these columns with
// NumPy on the host and uploads them (3.7 GB of int32 at 2^21 rows), as the
// port did before this kernel.
//
// A thread takes a row: it reads its 16 input words (int32, the row-major
// (n, 16) states), keeps the state in registers through the rounds and
// writes each column's value as it is made, as int64 (the prover's carrier)
// at column * rows + row, so a warp's stores of one column are 256
// contiguous bytes.  The round constants travel by value in the launch's
// parameters (632 bytes), read through the constant cache at one address a
// warp; every loop is unrolled, so each read is at a fixed offset.
//
// Exact: every value is reduced mod p = 2^31 - 1 into [0, p), so the
// columns are bit-equal to the host's.
//
// What bounds it on an H100: the bytes written, 443 x 8 a row, against
// ~1,900 integer operations a row (426 modular products at ~4 each, the
// matrices' ~700 modular adds at ~2): ~0.5 an operation a byte, far below
// the card's ~5, so it runs at the HBM's write rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t P = 0x7fffffffu;
constexpr int T = 16;
constexpr int FULL = 8;
constexpr int PARTIAL = 14;
constexpr int NCOLS = 1 + T * (1 + FULL * 3) + 3 * PARTIAL;  // 443
constexpr int THREADS = 256;

struct Consts {
  uint32_t ext[FULL * T];  // full-round constants, rows 0..3 then 4..7
  uint32_t internal[PARTIAL];
  uint32_t diag[T];
};

__device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // both < p: no wrap
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) {
  const uint64_t p = (uint64_t)a * b;  // < 2^62
  uint32_t r = (uint32_t)(p & P) + (uint32_t)(p >> 31);  // < 2^32 - 1
  r = (r & P) + (r >> 31);  // <= p
  return r >= P ? r - P : r;
}

// M_E = circ(2 M4, M4, M4, M4) (eprint 2023/323 section 5.1)
__device__ __forceinline__ void external(uint32_t* s) {
#pragma unroll
  for (int g = 0; g < 4; ++g) {
    uint32_t* x = s + 4 * g;
    const uint32_t t0 = add(x[0], x[1]);
    const uint32_t t02 = add(t0, t0);
    const uint32_t t1 = add(x[2], x[3]);
    const uint32_t t12 = add(t1, t1);
    const uint32_t t2 = add(add(x[1], x[1]), t1);
    const uint32_t t3 = add(add(x[3], x[3]), t0);
    const uint32_t t4 = add(add(t12, t12), t3);
    const uint32_t t5 = add(add(t02, t02), t2);
    x[0] = add(t3, t5);
    x[1] = t5;
    x[2] = add(t2, t4);
    x[3] = t4;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = add(add(s[j], s[j + 4]), add(s[j + 8], s[j + 12]));
#pragma unroll
    for (int g = 0; g < 4; ++g) s[4 * g + j] = add(s[4 * g + j], c);
  }
}

__device__ __forceinline__ void full_round(uint32_t* s, const Consts& c, int r,
                                           int64_t*& col, int64_t rows) {
  uint32_t sq2[T];
#pragma unroll
  for (int i = 0; i < T; ++i) {
    s[i] = add(s[i], c.ext[r * T + i]);
    const uint32_t q1 = mul(s[i], s[i]);
    col[(int64_t)i * rows] = q1;
    sq2[i] = mul(q1, q1);
    col[(int64_t)(T + i) * rows] = sq2[i];
  }
#pragma unroll
  for (int i = 0; i < T; ++i) s[i] = mul(sq2[i], s[i]);
  external(s);
#pragma unroll
  for (int i = 0; i < T; ++i) col[(int64_t)(2 * T + i) * rows] = s[i];
  col += (int64_t)3 * T * rows;
}

__global__ void __launch_bounds__(THREADS)
poseidon2_witness_kernel(const int32_t* __restrict__ states, int64_t n,
                         int64_t rows, Consts c, int64_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (row >= rows) return;
  uint32_t s[T];
  if (row < n) {
    const int4* src = reinterpret_cast<const int4*>(states + row * T);
#pragma unroll
    for (int q = 0; q < T / 4; ++q) {
      const int4 v = __ldg(src + q);
      s[4 * q] = (uint32_t)v.x;
      s[4 * q + 1] = (uint32_t)v.y;
      s[4 * q + 2] = (uint32_t)v.z;
      s[4 * q + 3] = (uint32_t)v.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = 0;
  }
  int64_t* col = out + row;
  col[0] = row < n ? 1 : 0;
  col += rows;
#pragma unroll
  for (int i = 0; i < T; ++i) col[(int64_t)i * rows] = s[i];
  col += (int64_t)T * rows;
  external(s);
#pragma unroll
  for (int r = 0; r < FULL / 2; ++r) full_round(s, c, r, col, rows);
#pragma unroll
  for (int r = 0; r < PARTIAL; ++r) {
    const uint32_t s0 = add(s[0], c.internal[r]);
    const uint32_t q1 = mul(s0, s0);
    const uint32_t q2 = mul(q1, q1);
    s[0] = mul(q2, s0);
    col[0] = q1;
    col[rows] = q2;
    col[2 * rows] = s[0];
    col += 3 * rows;
    uint32_t total = s[0];
#pragma unroll
    for (int i = 1; i < T; ++i) total = add(total, s[i]);
#pragma unroll
    for (int i = 0; i < T; ++i) s[i] = add(mul(s[i], c.diag[i]), total);
  }
#pragma unroll
  for (int r = FULL / 2; r < FULL; ++r) full_round(s, c, r, col, rows);
}

}  // namespace

// states: the (n, 16) int32 input states on the card, row-major; consts:
// host memory, the 8 x 16 full-round constants, the 14 partial-round ones
// and the 16 internal diagonal entries (158 uint32); out: the (443, rows)
// int64 stack on the card.  One launch on `stream`; returns its CUDA error
// (0 on success).
extern "C" int cm_poseidon2_witness(const int32_t* states, int64_t n,
                                    int64_t rows, const uint32_t* consts,
                                    int64_t* out, void* stream) {
  if (rows < 1 || n < 0 || n > rows) return (int)cudaErrorInvalidValue;
  Consts c;
  const uint32_t* src = consts;
  for (int i = 0; i < FULL * T; ++i) c.ext[i] = *src++;
  for (int i = 0; i < PARTIAL; ++i) c.internal[i] = *src++;
  for (int i = 0; i < T; ++i) c.diag[i] = *src++;
  const int64_t blocks = (rows + THREADS - 1) / THREADS;
  poseidon2_witness_kernel<<<(unsigned)blocks, THREADS, 0,
                             (cudaStream_t)stream>>>(states, n, rows, c, out);
  return (int)cudaGetLastError();
}

static_assert(NCOLS == 443, "the poseidon2 component has 443 columns");
