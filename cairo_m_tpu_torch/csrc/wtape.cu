// Wide-tape M31 constraint-plan interpreter (one thread per lane).
//
// Replaces the Pallas TPU kernel `_kernel` of
// cairo_m_tpu/prover/stark/wtape_pallas.py (built by `_call`, entered
// through `run_plan`), and the `lax.scan` interpreter `_wide_kernel` of
// cairo_m_tpu/prover/stark/wtape.py that the TPU used for plans it could not
// take: these kernels run every plan, whatever its step count or domain size.
//
// Semantics, per lane: a plan is a list of M31 instructions dst = a op b
// (op 0 add, 1 sub, 2 mul, mod 2^31 - 1, results canonical in [0, P)) over
// registers, the lane's B bank values and C run-time constants; the lane's
// output k is the value of one instruction.  Inputs and outputs are int64
// (the package's carrier); the arithmetic is uint32 with a 64-bit product.
//
// Two hand-written variants.  The host picks one by a rule on the register
// count (prover/stark/wtape.py `run_plan`); neither gives way to the other
// on a failed launch.
//
// 1. `wtape_smem_kernel` (every plan of the prover today).  The register
//    file never leaves the SM: R registers for each of the block's lanes
//    sit in dynamic shared memory laid out (R, lanes), so thread j touches
//    word r * lanes + j (consecutive threads, consecutive banks, no
//    conflicts).  The plan's schedule was made for a vector unit 32 slots
//    wide and keeps up to 204 values alive (1570 on the Poseidon2 plan); one
//    thread per lane has no use for that.  The host (wtape.kernel_program)
//    drops the schedule's NOP slots, re-orders the instructions depth first
//    into bundles of 4 that do not depend on each other, and re-allocates
//    the registers (80 for the largest opcode plan, 548 for Poseidon2); it
//    gives every bank row a register that a prologue fills with one
//    coalesced read of the row (so each input byte is read once), and stores
//    an output when it is computed instead of keeping it to the end.  Every
//    register operand of the main loop is one shared-memory load at a byte
//    offset the instruction carries premultiplied; the four instructions of
//    a bundle read all their operands before any writes its result, so
//    their loads overlap.  A constant operand is no load at all: its value
//    rides in the instruction.  The stream reaches the warp a chunk of 32
//    instructions at a time through shared memory, fetched two chunks
//    ahead, so an instruction fetch is a shared-memory broadcast and never
//    a trip to L2 (with the SM's memory carved out for shared memory, L1
//    does not hold the stream).  A block is one warp of 32 lanes, one a
//    thread: the most warps for the shared memory.  Only a file so small
//    (41 registers or fewer) that the SM's cap of 32 resident blocks binds
//    before its shared memory runs two lanes a thread, 64 a block, on a long
//    domain (wtape.pick_lanes).  A block may take up to 232,448 bytes of
//    dynamic shared memory, opted into with cudaFuncSetAttribute.
//
//    What bounds it on an H100: instruction issue, not device memory and
//    not shared-memory bandwidth.  The composition plan of store_add_fp_imm
//    (919 instructions + 4 output stores in 235 bundles, 80 registers, 2^20
//    lanes, 19 warps an SM) takes 1.20 ms on an H100 80GB HBM3 at 700 W,
//    against 3.6-4.0 ms for the variant below.  Its bytes (41 rows in, 4
//    out, 377 MB) need 0.11 ms and its 5.9 * 10^9 M31 integer operations
//    (add 3, sub 3, mul 10, as written below) 0.35 ms at 16.7 * 10^12 INT32
//    operations a second; the rest is the interpreter's own work per
//    instruction (fetch, flag tests, address arithmetic, branches: about 28
//    machine instructions per plan instruction where the arithmetic is 3 to
//    10), which more lanes a thread would amortise only with more shared
//    memory than an SM has (at 64 lanes a block this plan takes 1.54 ms).
//
// 2. `wtape_global_kernel`: the register file in a global scratch laid out
//    (R, tile), streamed through L2 and HBM (up to three 4-byte accesses per
//    instruction and lane).  It takes a plan whose file does not fit in
//    shared memory even at 32 lanes a block (more than ~1,800 registers),
//    in the plan's own order and register numbering with the NOP slots
//    dropped.  Bank rows are read in place and constants from the (C,)
//    vector.
//
// The kernels allocate nothing and do not synchronise; the wrapper allocates
// the output and the scratch.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kP = 0x7FFFFFFFu;
constexpr int kMaxDynamicSmem = 232448;
constexpr int32_t kChunk = 32;  // instructions per fetch: one per thread
constexpr int32_t kBundle = 4;  // independent instructions run together
static_assert(kChunk % kBundle == 0, "a chunk holds whole bundles");

// Operands are canonical, in [0, P).  An unsigned minimum picks the reduced
// value: of s and s - P the one that did not wrap is the smaller.
__device__ __forceinline__ uint32_t m31_add(uint32_t a, uint32_t b) {
  const uint32_t s = a + b;  // < 2^32
  return min(s, s - kP);
}

// a - b as a + (-b) with -0 = 0: a - b wraps below zero exactly when it
// needs + P.
__device__ __forceinline__ uint32_t m31_sub(uint32_t a, uint32_t b) {
  const uint32_t d = a - b;
  return min(d, d + kP);
}

// The 62-bit product hi * 2^32 + lo, folded twice at bit 31.
__device__ __forceinline__ uint32_t m31_mul(uint32_t a, uint32_t b) {
  const uint32_t lo = a * b;
  const uint32_t hi = __umulhi(a, b);                          // < 2^30
  uint32_t t = (lo & kP) + __funnelshift_l(lo, hi, 1);         // < 2^32
  t = (t & kP) + (t >> 31);                                    // <= P + 1
  return min(t, t - kP);
}

__device__ __forceinline__ uint32_t m31_op(int32_t op, uint32_t a, uint32_t b) {
  return op == 2 ? m31_mul(a, b) : op == 1 ? m31_sub(a, b) : m31_add(a, b);
}

// A block is one warp that runs LPT lanes per thread, 32 * LPT lanes in
// all: thread j runs lanes j, j + 32, ... of the block, so register r of its
// lane t is word r * lanes + 32 * t + j.  One decoded instruction then serves
// LPT lanes, whose loads, arithmetic and stores are independent of each
// other and overlap.
//
// instrs: n_instrs int4, padded with zero entries to a whole number of
// chunks of 32 plus two chunks.
//   x = flags, one bit per question the kernel asks, so that each is one
//       instruction: kAConst (a is a constant), kBNoLoad (b is a constant, or
//       the instruction is an output), kOut (store a as output row z), kMul,
//       kSub (neither: add)
//   y, z = a and b: register r -> byte offset r * lanes * 4 (the thread adds
//          its lane), constant c -> c
//   w = byte offset of the destination register
// The warp fetches the stream a chunk at a time, 16 bytes a thread,
// coalesced, two chunks ahead of the one it runs; one chunk ahead, the
// thread that holds an instruction replaces a constant's index by its value
// from `consts`; then the chunk goes to shared memory.  So an instruction
// fetch is a shared-memory broadcast, a constant operand costs no load at
// all, and the trips to L2 overlap a chunk's worth of work.
// bank_off: (B,) byte offset of the register of bank row b, or -1.
constexpr int32_t kAConst = 1, kBNoLoad = 2, kOut = 4, kMul = 8, kSub = 16;

__device__ __forceinline__ int4 resolve_consts(int4 ins,
                                               const int64_t* __restrict__ consts) {
  if (ins.x & kAConst) ins.y = (int32_t)__ldg(&consts[ins.y]);
  if ((ins.x & (kBNoLoad | kOut)) == kBNoLoad) ins.z = (int32_t)__ldg(&consts[ins.z]);
  return ins;
}

template <int LPT>
__global__ void __launch_bounds__(32)
wtape_smem_kernel(const int64_t* __restrict__ rows,
                  const int64_t* __restrict__ consts,
                  const int4* __restrict__ instrs,
                  const int32_t* __restrict__ bank_off,
                  int64_t* __restrict__ out, int32_t n_instrs, int32_t B,
                  int64_t n) {
  constexpr int W = kBundle;
  extern __shared__ uint32_t sm[];
  // two chunks of kChunk instructions, then the register file
  int4* ibuf = reinterpret_cast<int4*>(sm);
  const int32_t j = threadIdx.x;
  // the thread's column of the register file, addressed in bytes
  char* mine = reinterpret_cast<char*>(sm + 2 * kChunk * 4 + j);
  auto reg = [&](int32_t off, int t) -> uint32_t& {
    return *reinterpret_cast<uint32_t*>(mine + off + 128 * t);
  };
  const int64_t lane0 = (int64_t)blockIdx.x * (32 * LPT) + j;
  ibuf[j] = resolve_consts(__ldg(&instrs[j]), consts);
  int4 ahead1 = __ldg(&instrs[kChunk + j]);
  // from here on a thread touches only its own columns of the register file;
  // the instruction chunks are written below, each followed by a warp
  // barrier.  A lane past the end of a short domain computes on the last
  // lane's inputs and stores nothing.
#pragma unroll 4
  for (int32_t b = 0; b < B; ++b) {
    const int32_t off = __ldg(&bank_off[b]);
    const int64_t* row = rows + (int64_t)b * n;
    uint32_t v[LPT];
#pragma unroll
    for (int t = 0; t < LPT; ++t) {
      const int64_t lane = lane0 + 32 * t;
      v[t] = (uint32_t)row[lane < n ? lane : n - 1];
    }
    if (off >= 0) {
#pragma unroll
      for (int t = 0; t < LPT; ++t) reg(off, t) = v[t];
    }
  }
  __syncwarp();
  for (int32_t base = 0; base < n_instrs; base += kChunk) {
    const int4 ahead2 = __ldg(&instrs[base + 2 * kChunk + j]);
    ahead1 = resolve_consts(ahead1, consts);
    const int4* chunk = ibuf + ((base / kChunk) & 1) * kChunk;
    const int32_t count = min(kChunk, n_instrs - base);
    for (int32_t i = 0; i < count; i += W) {
      // one bundle: W instructions that do not depend on each other.  All
      // operands are read before any result is written, so their loads
      // overlap.
      int4 ins[W];
      uint32_t a[W][LPT], b[W][LPT];
#pragma unroll
      for (int w = 0; w < W; ++w) ins[w] = chunk[i + w];
#pragma unroll
      for (int w = 0; w < W; ++w) {
#pragma unroll
        for (int t = 0; t < LPT; ++t) {
          a[w][t] = (ins[w].x & kAConst) ? (uint32_t)ins[w].y : reg(ins[w].y, t);
          b[w][t] = (ins[w].x & kBNoLoad) ? (uint32_t)ins[w].z : reg(ins[w].z, t);
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (ins[w].x & kMul) {
#pragma unroll
          for (int t = 0; t < LPT; ++t) a[w][t] = m31_mul(a[w][t], b[w][t]);
        } else if (!(ins[w].x & kOut)) {
#pragma unroll
          for (int t = 0; t < LPT; ++t) {
            a[w][t] = (ins[w].x & kSub) ? m31_sub(a[w][t], b[w][t])
                                        : m31_add(a[w][t], b[w][t]);
          }
        }
      }
#pragma unroll
      for (int w = 0; w < W; ++w) {
        if (ins[w].x & kOut) {
          int64_t* row = out + (int64_t)ins[w].z * n;
#pragma unroll
          for (int t = 0; t < LPT; ++t) {
            const int64_t lane = lane0 + 32 * t;
            if (lane < n) row[lane] = (int64_t)a[w][t];
          }
        } else {
#pragma unroll
          for (int t = 0; t < LPT; ++t) reg(ins[w].w, t) = a[w][t];
        }
      }
    }
    ibuf[(((base / kChunk) + 1) & 1) * kChunk + j] = ahead1;
    ahead1 = ahead2;
    __syncwarp();
  }
}

template <int LPT>
int launch_smem(const int64_t* rows, const int64_t* consts, const int4* instrs,
                const int32_t* bank_off, int64_t* out, int32_t n_instrs,
                int32_t B, int64_t n, size_t smem, cudaStream_t stream) {
  // above 48 KB a kernel must opt in; the attribute belongs to the current
  // device, so it is set at every launch (a host-side call, no device work)
  cudaError_t err = cudaFuncSetAttribute(
      wtape_smem_kernel<LPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxDynamicSmem);
  if (err != cudaSuccess) return (int)err;
  // all of the SM's L1 / shared memory as shared memory: the kernel's
  // occupancy is what fits there, and it has little use for L1
  err = cudaFuncSetAttribute(
      wtape_smem_kernel<LPT>, cudaFuncAttributePreferredSharedMemoryCarveout,
      cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  constexpr int64_t lanes = 32 * LPT;
  wtape_smem_kernel<LPT><<<(unsigned)((n + lanes - 1) / lanes), 32, smem, stream>>>(
      rows, consts, instrs, bank_off, out, n_instrs, B, n);
  return (int)cudaGetLastError();
}

// instrs: (n_instrs, 4) int32 (base op, ia, ib, dst) with operands as file
// indices (register r -> r, bank b -> R + b, const c -> R + B + c).
__global__ void wtape_global_kernel(const int64_t* __restrict__ rows,
                                    const int64_t* __restrict__ consts,
                                    const int4* __restrict__ instrs,
                                    const int32_t* __restrict__ out_regs,
                                    int64_t* __restrict__ out,
                                    uint32_t* __restrict__ file,
                                    int32_t n_instrs, int32_t R, int32_t B,
                                    int32_t n_out, int64_t n, int64_t lane0,
                                    int64_t tile) {
  const int64_t j = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= tile) return;
  const int64_t lane = lane0 + j;
  const int32_t RB = R + B;
  for (int32_t r = 0; r < R; ++r) file[(int64_t)r * tile + j] = 0u;

  auto fetch = [&](int32_t idx) -> uint32_t {
    if (idx < R) return file[(int64_t)idx * tile + j];
    if (idx < RB) return (uint32_t)rows[(int64_t)(idx - R) * n + lane];
    return (uint32_t)__ldg(&consts[idx - RB]);
  };

  for (int32_t i = 0; i < n_instrs; ++i) {
    const int4 ins = __ldg(&instrs[i]);  // (base op, ia, ib, dst)
    file[(int64_t)ins.w * tile + j] = m31_op(ins.x, fetch(ins.y), fetch(ins.z));
  }
  for (int32_t k = 0; k < n_out; ++k) {
    out[(int64_t)k * n + lane] = (int64_t)fetch(__ldg(&out_regs[k]));
  }
}

}  // namespace

// Shared-memory variant.  rows: (B, n) int64 bank rows; consts: (C,) int64;
// instrs: (padded, 4) int32 and bank_off: (B,) int32 as described at the
// kernel, encoded for `lanes` (32 or 64) lanes a block in bundles of 4;
// out: (n_out, n) int64.  R * lanes * 4 + 1,024 bytes of dynamic shared memory
// must fit 232,448.
// Returns the CUDA error of the launch.
extern "C" int cm_wtape_run(const int64_t* rows, const int64_t* consts,
                            const int32_t* instrs, const int32_t* bank_off,
                            int64_t* out, int32_t n_instrs, int32_t R,
                            int32_t B, int64_t n, int32_t lanes,
                            void* stream) {
  if (n <= 0) return 0;
  const size_t smem = ((size_t)R * lanes + 2 * kChunk * 4) * sizeof(uint32_t);
  if (smem > (size_t)kMaxDynamicSmem || n_instrs % kBundle) {
    return (int)cudaErrorInvalidValue;
  }
  const int4* ins = reinterpret_cast<const int4*>(instrs);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 32:
      return launch_smem<1>(rows, consts, ins, bank_off, out, n_instrs, B, n, smem, st);
    case 64:
      return launch_smem<2>(rows, consts, ins, bank_off, out, n_instrs, B, n, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Global-scratch variant.  instrs: (n_instrs, 4) int32 as described at the
// kernel; out_regs: (n_out,) int32; scratch: (R, tile) uint32.  Runs lanes
// [lane0, lane0 + tile).  Returns the CUDA error of the launch.
extern "C" int cm_wtape_run_global(const int64_t* rows, const int64_t* consts,
                                   const int32_t* instrs,
                                   const int32_t* out_regs, int64_t* out,
                                   uint32_t* scratch, int32_t n_instrs,
                                   int32_t R, int32_t B, int32_t n_out,
                                   int64_t n, int64_t lane0, int64_t tile,
                                   void* stream) {
  if (tile <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (tile + threads - 1) / threads;
  wtape_global_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      rows, consts, reinterpret_cast<const int4*>(instrs), out_regs, out,
      scratch, n_instrs, R, B, n_out, n, lane0, tile);
  return (int)cudaGetLastError();
}
