// The out-of-domain samples of the polynomial commitment: stacks of M31
// coefficient columns evaluated at QM31 circle points, a whole sample step
// (every phase, log size and point) in one launch and one launch of its sum.
//
// Replaces no Pallas kernel: the JAX package left this step to XLA's fusion
// of the jitted halving folds (`eval_at_qpoint_folds`,
// cairo_m_tpu/prover/stark/fft.py:270), one graph a log size.  Eager, the
// same folds cost ~240 torch launches a fold level, ~100k a proof, and
// left the card idle while the host queued them.
//
// The value of a column c of 2^L coefficients at a point whose twiddle rows
// are tw_0 .. tw_{L-1} (`point_eval_twiddles_host`: bit j of the index
// pairs with tw_j) is
//     sum_i c[i] * w(i),    w(i) = prod_j tw_j^(bit j of i),
// and w factors over any split of the index bits.  A warp takes a segment
// of 2^s coefficients of one column (s = min(L, seg_log)); lane l reads
// coefficient 32r + l of it, r < 2^(s-5), so that
//     w = wlo(l) * wmid(r) * whi(segment):
// - wmid: a table of 2^(s-5) QM31 a point in shared memory, built by the
//   block (all of a block's warps work on one job);
// - a lane sums c * wmid(r) over its r unreduced: four 32x32->64 products a
//   coefficient and point, four of them added in 64 bits before one
//   Mersenne fold into a 64-bit sum, reduced once at the end;
// - then it multiplies by wlo(l), the warp adds its 32 lanes mod p, and
//   the sum times whi(segment) is the segment's partial value.
// Columns shorter than a warp (L < 5) take 2^L lanes each, 32 / 2^L columns
// a load; columns of 2^5 .. 2^(seg_log-1) coefficients are whole segments,
// 2^(seg_log - L) of them a warp, so a stack of many small columns (k =
// 1,392 at L = 4) fills few warps and no block is left nearly empty.
// `point_eval_sum_kernel` adds each column's partials (a warp a column and
// point) and multiplies by the job's factor: 1, or under a row mesh the
// twiddles of the rank's high bits (0 for a whole column on the ranks but
// the first), before the wrapper's one modular all-reduce.
//
// Exact: integers throughout, every sum reduced mod p, so any order gives
// the same field element and the values are byte-equal to the folds'.
//
// Points: a job reads its coefficients once for up to two points (the
// interaction columns are sampled at the point and at the previous row's).
//
// What bounds it on an H100: the bytes.  Each coefficient is read once, 8
// bytes in the int64 carrier, against ~2.5 integer operations a limb and
// point (one 32x32->64 multiply-add, a quarter of a fold): ~10 a
// coefficient and point, 1.3-2.5 a byte, below the card's ~5.  The sum
// kernel reads 2^-seg_log of that.  Enough bytes stay in flight for HBM:
// a lane keeps 8 loads outstanding, and the grid has a warp for every
// 2^seg_log coefficients of the step.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t P = 0x7fffffffu;
constexpr int WARPS = 8;  // warps of a block
constexpr int T = 32 * WARPS;
constexpr int MAX_SEG_LOG = 12;
constexpr int MAX_MID = 1 << (MAX_SEG_LOG - 5);
constexpr int NPTS = 2;  // points a job evaluates at most

// A job row: ROW int64 fields (fft.py `_point_eval_table` writes them).
constexpr int ROW = 16;
enum {
  J_PTR,             // the (k, 2^L) int64 coefficient stack
  J_K,               // columns
  J_L,               // index bits to contract (the local ones under a mesh)
  J_NP,              // points, 1 or 2
  J_TW,              // per point: twiddle entry of tw_0 (tw_j: entry + j)
  J_FAC = J_TW + NPTS,    // per point: entry of the factor of every value
  J_OUT = J_FAC + NPTS,   // per point: offset of its (4, k) output block
  J_PART = J_OUT + NPTS,  // first partial (QM31 units)
  J_BLK0,            // blocks [BLK0, BLK1) of the main grid
  J_BLK1,
  J_SUM0,            // warps [SUM0, SUM1) of the sum grid
  J_SUM1,
  J_TASKS,           // warp tasks of the job
};
static_assert(J_TASKS < ROW, "job row too short");

struct Q {
  uint32_t a, b, c, d;  // (a + b i) + (c + d i) u
};

// Any 64-bit value mod p: two Mersenne folds leave at most p + 7.
__device__ __forceinline__ uint32_t fold(uint64_t v) {
  v = (v & P) + (v >> 31);
  const uint32_t r = (uint32_t)((v & P) + (v >> 31));
  return r >= P ? r - P : r;
}

__device__ __forceinline__ uint32_t madd(uint32_t x, uint32_t y) {
  const uint32_t s = x + y;
  return s >= P ? s - P : s;
}

__device__ __forceinline__ uint32_t msub(uint32_t x, uint32_t y) {
  return x >= y ? x - y : x + P - y;
}

// CM31 = M31[i] / (i^2 + 1): (x0 + x1 i)(y0 + y1 i)
__device__ __forceinline__ void cmul(uint32_t x0, uint32_t x1, uint32_t y0,
                                     uint32_t y1, uint32_t& r0, uint32_t& r1) {
  r0 = msub(fold((uint64_t)x0 * y0), fold((uint64_t)x1 * y1));
  r1 = fold((uint64_t)x0 * y1 + (uint64_t)x1 * y0);
}

// QM31 = CM31[u] / (u^2 - (2 + i)): (A + B u)(C + D u) = (AC + (2 + i) BD)
// + (AD + BC) u
__device__ __forceinline__ Q qmul(Q x, Q y) {
  uint32_t ac0, ac1, bd0, bd1, ad0, ad1, bc0, bc1;
  cmul(x.a, x.b, y.a, y.b, ac0, ac1);
  cmul(x.c, x.d, y.c, y.d, bd0, bd1);
  cmul(x.a, x.b, y.c, y.d, ad0, ad1);
  cmul(x.c, x.d, y.a, y.b, bc0, bc1);
  const uint32_t rbd0 = msub(madd(bd0, bd0), bd1);
  const uint32_t rbd1 = madd(bd0, madd(bd1, bd1));
  return Q{madd(ac0, rbd0), madd(ac1, rbd1), madd(ad0, bc0), madd(ad1, bc1)};
}

__device__ __forceinline__ Q qload(const int64_t* tw, int64_t e) {
  const int64_t* q = tw + 4 * e;
  return Q{(uint32_t)q[0], (uint32_t)q[1], (uint32_t)q[2], (uint32_t)q[3]};
}

// prod of tw_j over the j in [lo, hi) whose bit (j - lo) of `bits` is set
__device__ Q weight(const int64_t* tw, int64_t t0, int lo, int hi,
                    int64_t bits) {
  Q w{1u, 0u, 0u, 0u};
  for (int j = lo; j < hi; ++j)
    if ((bits >> (j - lo)) & 1) w = qmul(w, qload(tw, t0 + j));
  return w;
}

// sum mod p over the lanes that differ in the bits below `width`
__device__ __forceinline__ Q group_sum(Q v, int width) {
  for (int o = 1; o < width; o <<= 1) {
    v.a = madd(v.a, __shfl_xor_sync(0xffffffffu, v.a, o));
    v.b = madd(v.b, __shfl_xor_sync(0xffffffffu, v.b, o));
    v.c = madd(v.c, __shfl_xor_sync(0xffffffffu, v.c, o));
    v.d = madd(v.d, __shfl_xor_sync(0xffffffffu, v.d, o));
  }
  return v;
}

__device__ __forceinline__ void put(uint32_t* part, int64_t i, Q v) {
  reinterpret_cast<uint4*>(part)[i] = make_uint4(v.a, v.b, v.c, v.d);
}

// One warp task of a job.  L < 5: 2^(seg_log - L) whole columns, 2^L lanes
// a column.  Else a segment of 2^seg_log coefficients of one column (L >=
// seg_log) or 2^(seg_log - L) whole columns, one after the other.
template <int NPT>
__device__ void run_task(const int64_t* job, const int64_t* tw, uint32_t* part,
                         int seg_log, uint4 (*mid)[MAX_MID],
                         int64_t task) {
  const int lane = threadIdx.x & 31;
  const int64_t* src0 = reinterpret_cast<const int64_t*>(job[J_PTR]);
  const int64_t k = job[J_K];
  const int L = (int)job[J_L];
  const int64_t part0 = job[J_PART];
  int64_t t0[NPT];
#pragma unroll
  for (int p = 0; p < NPT; ++p) t0[p] = job[J_TW + p];

  if (L < 5) {
    const int G = 1 << L;
    const int g = lane & (G - 1);
    Q wlo[NPT];
#pragma unroll
    for (int p = 0; p < NPT; ++p) wlo[p] = weight(tw, t0[p], 0, L, g);
    const int64_t col0 = task << (seg_log - L);
    const int nr = 1 << (seg_log - 5);
    for (int r = 0; r < nr; ++r) {
      // the load's first column; its others follow it
      if (col0 + ((32 * r) >> L) >= k) break;
      const int64_t col = col0 + ((32 * r + lane) >> L);
      const uint32_t x =
          col < k ? (uint32_t)__ldg(src0 + col0 * G + 32 * r + lane) : 0u;
#pragma unroll
      for (int p = 0; p < NPT; ++p) {
        Q v{fold((uint64_t)x * wlo[p].a), fold((uint64_t)x * wlo[p].b),
            fold((uint64_t)x * wlo[p].c), fold((uint64_t)x * wlo[p].d)};
        v = group_sum(v, G);
        if (g == 0 && col < k) put(part, part0 + p * k + col, v);
      }
    }
    return;
  }

  const int s = L < seg_log ? L : seg_log;
  const int nr = 1 << (s - 5);
  const int64_t nseg = (int64_t)1 << (L - s);
  int64_t col, g, ncols;
  if (L >= seg_log) {
    col = task >> (L - s);
    g = task & (nseg - 1);
    ncols = 1;
  } else {
    col = task << (seg_log - L);
    g = 0;
    ncols = k - col < ((int64_t)1 << (seg_log - L)) ? k - col
                                                     : (int64_t)1 << (seg_log - L);
  }
  Q wlo[NPT];
#pragma unroll
  for (int p = 0; p < NPT; ++p) wlo[p] = weight(tw, t0[p], 0, 5, lane);

  for (int64_t c = 0; c < ncols; ++c, ++col) {
    const int64_t* src = src0 + (col << L) + (g << s) + lane;
    uint64_t acc[NPT][4];
#pragma unroll
    for (int p = 0; p < NPT; ++p)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[p][q] = 0;
#pragma unroll 2
    for (int r0 = 0; r0 < nr; r0 += 4) {
      uint32_t x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        x[u] = r0 + u < nr ? (uint32_t)__ldg(src + 32 * (r0 + u)) : 0u;
#pragma unroll
      for (int p = 0; p < NPT; ++p) {
        // four products < 2^62 each fit one 64-bit sum
        uint64_t s0 = 0, s1 = 0, s2 = 0, s3 = 0;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (r0 + u < nr) {
            const uint4 m = mid[p][r0 + u];
            s0 += (uint64_t)x[u] * m.x;
            s1 += (uint64_t)x[u] * m.y;
            s2 += (uint64_t)x[u] * m.z;
            s3 += (uint64_t)x[u] * m.w;
          }
        }
        acc[p][0] += (s0 & P) + (s0 >> 31);
        acc[p][1] += (s1 & P) + (s1 >> 31);
        acc[p][2] += (s2 & P) + (s2 >> 31);
        acc[p][3] += (s3 & P) + (s3 >> 31);
      }
    }
#pragma unroll
    for (int p = 0; p < NPT; ++p) {
      Q v{fold(acc[p][0]), fold(acc[p][1]), fold(acc[p][2]), fold(acc[p][3])};
      v = group_sum(qmul(v, wlo[p]), 32);
      if (nseg > 1) v = qmul(v, weight(tw, t0[p], s, L, g));
      if (lane == 0) put(part, part0 + (p * k + col) * nseg + g, v);
    }
  }
}

__global__ void __launch_bounds__(T)
    point_eval_kernel(const int64_t* __restrict__ jobs, int njobs,
                      const int64_t* __restrict__ tw, uint32_t* part,
                      int seg_log) {
  __shared__ uint4 mid[NPTS][MAX_MID];
  __shared__ int sj;
  const int64_t b = blockIdx.x;
  for (int j = threadIdx.x; j < njobs; j += T) {
    const int64_t* row = jobs + (int64_t)j * ROW;
    if (row[J_BLK0] <= b && b < row[J_BLK1]) sj = j;
  }
  __syncthreads();
  const int64_t* job = jobs + (int64_t)sj * ROW;
  const int L = (int)job[J_L];
  const int np = (int)job[J_NP];
  const int s = L < seg_log ? L : seg_log;
  const int nr = s > 5 ? 1 << (s - 5) : 1;
  for (int e = threadIdx.x; e < np * nr; e += T) {
    const int p = e / nr, r = e % nr;
    const Q w = weight(tw, job[J_TW + p], 5, s, r);
    mid[p][r] = make_uint4(w.a, w.b, w.c, w.d);
  }
  __syncthreads();
  const int64_t task = (b - job[J_BLK0]) * WARPS + (threadIdx.x >> 5);
  if (task >= job[J_TASKS]) return;
  if (np == 1)
    run_task<1>(job, tw, part, seg_log, mid, task);
  else
    run_task<2>(job, tw, part, seg_log, mid, task);
}

// A warp a (job, point, column): the sum of its partials mod p, times the
// factor, into the (4, k) block of the point.
__global__ void __launch_bounds__(T)
    point_eval_sum_kernel(const int64_t* __restrict__ jobs, int njobs,
                          const int64_t* __restrict__ tw,
                          const uint32_t* __restrict__ part,
                          int64_t* __restrict__ out, int64_t nwarps,
                          int seg_log) {
  const int lane = threadIdx.x & 31;
  const int64_t o = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (o >= nwarps) return;
  int found = -1;
  for (int j = lane; j < njobs; j += 32) {
    const int64_t* row = jobs + (int64_t)j * ROW;
    if (row[J_SUM0] <= o && o < row[J_SUM1]) found = j;
  }
  const int64_t* job = jobs + (int64_t)__reduce_max_sync(0xffffffffu, found) * ROW;
  const int64_t k = job[J_K];
  const int L = (int)job[J_L];
  const int64_t nseg = L > seg_log ? (int64_t)1 << (L - seg_log) : 1;
  const int64_t local = o - job[J_SUM0];
  const int p = (int)(local / k);
  const int64_t col = local % k;
  const uint4* src =
      reinterpret_cast<const uint4*>(part) + job[J_PART] + (p * k + col) * nseg;
  uint64_t a = 0, b = 0, c = 0, d = 0;
  for (int64_t g = lane; g < nseg; g += 32) {
    const uint4 v = src[g];
    a += v.x;
    b += v.y;
    c += v.z;
    d += v.w;
  }
  Q v = group_sum(Q{fold(a), fold(b), fold(c), fold(d)}, 32);
  v = qmul(v, qload(tw, job[J_FAC + p]));
  if (lane == 0) {
    int64_t* dst = out + job[J_OUT + p] + col;
    dst[0] = v.a;
    dst[k] = v.b;
    dst[2 * k] = v.c;
    dst[3 * k] = v.d;
  }
}

}  // namespace

// jobs: njobs rows of ROW int64 (the layout above) on the card; tw: the
// QM31 twiddles and factors the rows point at, 4 int64 an entry; part:
// scratch of every job's partials (4 uint32 each); out: the values.  The
// main grid has `nblocks` blocks, the sum grid a warp for each of `nwarps`
// (job, point, column).  Two launches on `stream`; returns the CUDA error
// of either (0 on success).
extern "C" int cm_point_eval(const int64_t* jobs, int32_t njobs,
                             const int64_t* tw, uint32_t* part, int64_t* out,
                             int64_t nblocks, int64_t nwarps, int32_t seg_log,
                             void* stream) {
  if (njobs < 1 || nblocks < 1 || nwarps < 1 || seg_log < 5 ||
      seg_log > MAX_SEG_LOG)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  point_eval_kernel<<<(unsigned)nblocks, T, 0, s>>>(jobs, njobs, tw, part,
                                                    seg_log);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  point_eval_sum_kernel<<<(unsigned)((nwarps + WARPS - 1) / WARPS), T, 0, s>>>(
      jobs, njobs, tw, part, out, nwarps, seg_log);
  return (int)cudaGetLastError();
}
