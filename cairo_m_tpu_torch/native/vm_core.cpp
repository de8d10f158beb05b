// Native VM + witness-adapter core.
//
// Executes a Cairo-M program (QM31 memory image) and, in the same pass,
// performs the prover adapter's memory replay: per-access previous clock /
// previous value tracking, clock-update emission for gaps beyond the clock
// range check's span (the caller's `clock_limit`: 2^20 - 1 in production), and
// initial/final memory tables.  Mirrors the semantics of
// vm/vm.py + prover/adapter/adapter.py exactly (cross-tested from
// tests/test_torch_vm.py); the reference counterparts are
// crates/runner/src/vm and crates/prover/src/adapter (SURVEY.md §2.2, §2.4).
//
// C ABI for ctypes; buffers are std::vectors owned by a RunResult handle.

#include <cstdint>
#include <array>
#include <cstring>
#include <mutex>
#include <new>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

constexpr uint64_t P = 0x7fffffffULL;          // 2^31 - 1
constexpr uint32_t MAX_ADDRESS = (1u << 28) - 1;
constexpr uint32_t U16_MASK = 0xffff;
// Max dense-array growth per access: contiguous use (frames, inline arrays,
// heap) stays dense; an isolated far-out address (e.g. from buggy pointer
// arithmetic) falls back to the sparse maps instead of resizing to GBs.
constexpr uint64_t GAP_CAP = 1ull << 22;

struct QM31 {
  uint32_t v[4];
};

inline uint64_t fadd(uint64_t a, uint64_t b) { uint64_t s = a + b; return s >= P ? s - P : s; }
inline uint64_t fsub(uint64_t a, uint64_t b) { return a >= b ? a - b : a + P - b; }
inline uint64_t fmul(uint64_t a, uint64_t b) {
  uint64_t p = a * b;
  p = (p & P) + (p >> 31);
  p = (p & P) + (p >> 31);
  return p == P ? 0 : p;
}
inline uint64_t fpow(uint64_t a, uint64_t e) {
  uint64_t r = 1;
  while (e) {
    if (e & 1) r = fmul(r, a);
    a = fmul(a, a);
    e >>= 1;
  }
  return r;
}
inline uint64_t finv(uint64_t a) { return fpow(a, P - 2); }

// opcode -> (size_in_m31s, memory_accesses); 0xff = invalid
struct OpInfo { uint8_t size; uint8_t accesses; };

OpInfo op_info(uint32_t op) {
  switch (op) {
    case 0: case 1: case 2: case 3: return {4, 3};        // felt fp fp
    case 4: case 6: return {4, 2};                        // felt fp imm
    case 48: return {4, 2};                               // store_le
    case 50: return {3, 1};                               // assert_eq
    case 8: case 42: return {4, 4};                       // double deref (+implicit)
    case 44: case 45: return {4, 4};                      // store-to deref
    case 9: case 43: return {3, 1};                       // store imm / fp
    case 10: return {3, 2};                               // call
    case 11: return {1, 2};                               // ret
    case 12: case 13: return {2, 0};                      // jumps
    case 14: return {3, 1};                               // jnz
    case 15: case 16: case 17: return {4, 6};             // u32 fp fp
    case 18: return {5, 8};                               // u32 divrem fp fp
    case 19: case 21: return {5, 4};                      // u32 fp imm
    case 22: return {6, 6};                               // u32 divrem fp imm
    case 23: return {4, 2};                               // u32 imm
    case 24: case 28: return {4, 5};                      // u32 cmp fp fp
    case 30: case 34: return {5, 3};                      // u32 cmp fp imm
    case 36: case 37: case 38: return {4, 6};             // u32 bitwise fp fp
    case 39: case 40: case 41: return {5, 4};             // u32 bitwise fp imm
    case 46: return {2, 0};                               // print felt (untraced)
    case 47: return {2, 0};                               // print u32 (untraced)
    default: return {0xff, 0xff};
  }
}

struct Memory {
  std::vector<QM31> locals, heap;
  // the initial-memory snapshot (locals after program load + entrypoint
  // setup): addresses below snapshot_len are preloaded at clock 0.
  // Resumed segments also snapshot the heap side (and any sparse cells)
  // so a first-access WRITE sees the previous segment's value as its
  // prev_value — required for final_root(k) == initial_root(k+1).
  std::vector<QM31> snapshot;
  uint32_t snapshot_len = 0;
  std::vector<QM31> snapshot_heap;
  std::unordered_map<uint32_t, QM31> snapshot_sparse;
  // adapter state: tracked (value, clock, touched) per address, flat arrays
  // mirroring the locals/heap split (hash-free hot path).  Indices beyond
  // the data arrays are legal (reads of never-written cells), so the
  // tracked arrays grow independently with the same ld<hd heuristic.
  struct Cell { QM31 value; uint32_t clock; uint32_t touched; };
  std::vector<Cell> tracked_locals, tracked_heap;
  // isolated far-out addresses (gap > GAP_CAP from both dense regions)
  std::unordered_map<uint32_t, QM31> sparse_cells;
  std::unordered_map<uint32_t, Cell> sparse_tracked;
  std::vector<uint32_t> initial_extra;  // first-access adoptions: addr,v0..v3
  std::vector<uint32_t> clock_updates;  // addr, prev_clk, v0..v3 per entry
  // largest clock gap one memory access may span; longer gaps are cut by
  // clock-update rows (the clock range check's limit)
  uint32_t clock_limit = (1u << 20) - 1;
  // per-access outputs of push():
  uint32_t last_prev_clock;
  QM31 last_prev_value;

  QM31 get_cell(uint32_t addr) {
    if (addr < locals.size()) return locals[addr];
    uint32_t h = MAX_ADDRESS - addr;
    if (h < heap.size()) return heap[h];
    if (!sparse_cells.empty()) {
      auto it = sparse_cells.find(addr);
      if (it != sparse_cells.end()) return it->second;
    }
    return QM31{{0, 0, 0, 0}};
  }
  void set_cell(uint32_t addr, QM31 v) {
    if (addr < locals.size()) { locals[addr] = v; return; }
    uint32_t h = MAX_ADDRESS - addr;
    if (h < heap.size()) { heap[h] = v; return; }
    if (!sparse_cells.empty()) {
      auto it = sparse_cells.find(addr);
      if (it != sparse_cells.end()) { it->second = v; return; }
    }
    uint64_t ld = (uint64_t)addr - locals.size();
    uint64_t hd = (uint64_t)h - heap.size();
    if (ld >= GAP_CAP && hd >= GAP_CAP) {
      sparse_cells[addr] = v;
    } else if (ld < hd) {
      locals.resize(addr + 1, QM31{{0, 0, 0, 0}});
      locals[addr] = v;
    } else {
      heap.resize(h + 1, QM31{{0, 0, 0, 0}});
      heap[h] = v;
    }
  }

  Cell* track_slot(uint32_t addr) {
    uint32_t h = MAX_ADDRESS - addr;
    if (addr < tracked_locals.size()) return &tracked_locals[addr];
    if (h < tracked_heap.size()) return &tracked_heap[h];
    if (!sparse_tracked.empty()) {
      auto it = sparse_tracked.find(addr);
      if (it != sparse_tracked.end()) return &it->second;
    }
    uint64_t ld = (uint64_t)addr - tracked_locals.size();
    uint64_t hd = (uint64_t)h - tracked_heap.size();
    if (ld >= GAP_CAP && hd >= GAP_CAP)
      return &sparse_tracked.emplace(addr, Cell{{{0, 0, 0, 0}}, 0, 0})
                  .first->second;
    if (ld < hd) {
      tracked_locals.resize(addr + 1, Cell{{{0, 0, 0, 0}}, 0, 0});
      return &tracked_locals[addr];
    }
    tracked_heap.resize(h + 1, Cell{{{0, 0, 0, 0}}, 0, 0});
    return &tracked_heap[h];
  }

  // adapter push: record access, compute prev clock/value, clock updates
  // (python adapter.push semantics: snapshot cells are preloaded at clock 0
  // with their snapshot value; fresh cells adopt the accessed value)
  void push(uint32_t addr, QM31 value, uint32_t clock) {
    Cell* cell = track_slot(addr);
    uint32_t prev_clk;
    QM31 prev_val;
    if (!cell->touched) {
      prev_clk = 0;
      uint32_t hh = MAX_ADDRESS - addr;
      if (addr < snapshot_len) {
        prev_val = snapshot[addr];
      } else if (hh < snapshot_heap.size()) {
        prev_val = snapshot_heap[hh];
      } else if (!snapshot_sparse.empty() &&
                 snapshot_sparse.count(addr)) {
        prev_val = snapshot_sparse[addr];
      } else {
        prev_val = value;  // first access adopts the value
        initial_extra.push_back(addr);
        for (int k = 0; k < 4; k++) initial_extra.push_back(value.v[k]);
      }
    } else {
      prev_clk = cell->clock;
      prev_val = cell->value;
    }
    *cell = Cell{value, clock, 1};
    uint32_t delta = clock - prev_clk;
    if (clock > prev_clk && delta > clock_limit) {
      uint32_t steps = (delta - 1) / clock_limit;
      for (uint32_t s = 0; s < steps; s++) {
        clock_updates.push_back(addr);
        clock_updates.push_back(prev_clk);
        for (int k = 0; k < 4; k++) clock_updates.push_back(prev_val.v[k]);
        prev_clk += clock_limit;
      }
    }
    last_prev_clock = prev_clk;
    last_prev_value = prev_val;
  }
};

struct RunResult {
  int status = 0;           // 0 ok, <0 error codes
  uint32_t final_pc = 0, final_fp = 0;
  uint64_t n_steps = 0;
  // bundle stream (per step): pc, fp, clock, inst_prev_clock, opcode,
  // size_m31, words[6], n_operands, then per operand (prev_clk, prev_val, val)
  std::vector<uint32_t> bundles;
  // final memory table: addr, v0..v3, clock (mult handled in python)
  std::vector<uint32_t> final_mem;
  // adapter-adopted initial cells (first writes): addr, v0..v3
  std::vector<uint32_t> initial_extra;
  std::vector<uint32_t> clock_updates;
  std::vector<QM31> final_locals, final_heap;
  std::vector<uint32_t> sparse_dump;  // addr, v0..v3 per far-gap cell
};

struct VM {
  Memory mem;
  uint32_t pc, fp, final_pc;
  uint32_t clock = 1;
  RunResult* out;

  bool felt(uint32_t addr, uint64_t* v) {
    QM31 c = mem.get_cell(addr);
    if (c.v[1] || c.v[2] || c.v[3]) return false;
    *v = c.v[0];
    return true;
  }

  struct OpsBuf { uint32_t d[24]; int n = 0; void push_back(uint32_t x) { d[n++] = x; } };

  // traced felt read
  bool rd(uint64_t addr64, uint64_t* v, OpsBuf& ops) {
    uint32_t addr = (uint32_t)(addr64 % P);
    if (addr > MAX_ADDRESS) return false;
    QM31 c = mem.get_cell(addr);
    if (c.v[1] || c.v[2] || c.v[3]) return false;
    mem.push(addr, c, clock);
    ops.push_back(mem.last_prev_clock);
    ops.push_back(mem.last_prev_value.v[0]);
    ops.push_back(c.v[0]);
    *v = c.v[0];
    return true;
  }
  // traced felt write
  bool wr(uint64_t addr64, uint64_t val, OpsBuf& ops) {
    uint32_t addr = (uint32_t)(addr64 % P);
    if (addr > MAX_ADDRESS) return false;
    QM31 c{{(uint32_t)val, 0, 0, 0}};
    mem.set_cell(addr, c);
    mem.push(addr, c, clock);
    ops.push_back(mem.last_prev_clock);
    ops.push_back(mem.last_prev_value.v[0]);
    ops.push_back((uint32_t)val);
    return true;
  }
  bool rd_u32(uint64_t addr64, uint64_t* v, OpsBuf& ops) {
    uint64_t lo, hi;
    if (!rd(addr64, &lo, ops)) return false;
    if (!rd((addr64 + 1) % P, &hi, ops)) return false;
    if (lo > U16_MASK || hi > U16_MASK) return false;
    *v = (hi << 16) | lo;
    return true;
  }
  bool wr_u32(uint64_t addr64, uint64_t val, OpsBuf& ops) {
    if (!wr(addr64, val & U16_MASK, ops)) return false;
    return wr((addr64 + 1) % P, (val >> 16) & U16_MASK, ops);
  }

  int step() {
    if (pc >= mem.locals.size()) return -2;
    QM31 cell0 = mem.locals[pc];
    uint32_t opcode = cell0.v[0];
    OpInfo info = op_info(opcode);
    if (info.size == 0xff) return -3;
    uint32_t size_qm31 = (info.size + 3) / 4;
    uint32_t words[6] = {cell0.v[0], cell0.v[1], cell0.v[2], cell0.v[3], 0, 0};
    // instruction fetch logging
    mem.push(pc, cell0, clock);
    uint32_t inst_prev = mem.last_prev_clock;
    if (size_qm31 == 2) {
      if (pc + 1 >= mem.locals.size()) return -2;
      QM31 cell1 = mem.locals[pc + 1];
      mem.push(pc + 1, cell1, clock);
      words[4] = cell1.v[0];
      words[5] = cell1.v[1];
    }
    // bundle header
    auto& B = out->bundles;
    B.push_back(pc);
    B.push_back(fp);
    B.push_back(clock);
    B.push_back(inst_prev);
    B.push_back(opcode);
    B.push_back(info.size);
    for (int k = 0; k < 6; k++) B.push_back(words[k]);
    B.push_back(info.accesses);
    OpsBuf ops;

    uint64_t f = fp;
    uint32_t next_pc = pc + size_qm31, next_fp = fp;
    const uint32_t* w = words;
    bool ok = true;
    uint64_t a, b, base, off, srcv;
    switch (opcode) {
      case 0: ok = rd(f + w[1], &a, ops) && rd(f + w[2], &b, ops) && wr(f + w[3], fadd(a, b), ops); break;
      case 1: ok = rd(f + w[1], &a, ops) && rd(f + w[2], &b, ops) && wr(f + w[3], fsub(a, b), ops); break;
      case 2: ok = rd(f + w[1], &a, ops) && rd(f + w[2], &b, ops) && wr(f + w[3], fmul(a, b), ops); break;
      case 3:
        ok = rd(f + w[1], &a, ops) && rd(f + w[2], &b, ops);
        if (ok && b == 0) return -4;
        if (ok) ok = wr(f + w[3], fmul(a, finv(b)), ops);
        break;
      case 4: ok = rd(f + w[1], &a, ops) && wr(f + w[3], fadd(a, w[2]), ops); break;
      case 6: ok = rd(f + w[1], &a, ops) && wr(f + w[3], fmul(a, w[2]), ops); break;
      case 48: ok = rd(f + w[1], &a, ops) && wr(f + w[3], a <= w[2] ? 1 : 0, ops); break;
      case 50:
        ok = rd(f + w[1], &a, ops);
        if (ok && a != w[2]) return -5;
        break;
      case 8: ok = rd(f + w[1], &base, ops) && rd(base + w[2], &a, ops) && wr(f + w[3], a, ops); break;
      case 42: ok = rd(f + w[1], &base, ops) && rd(f + w[2], &off, ops) && rd(base + off, &a, ops) && wr(f + w[3], a, ops); break;
      case 44: ok = rd(f + w[1], &base, ops) && rd(f + w[3], &srcv, ops) && wr(base + w[2], srcv, ops); break;
      case 45: ok = rd(f + w[1], &base, ops) && rd(f + w[2], &off, ops) && rd(f + w[3], &srcv, ops) && wr(base + off, srcv, ops); break;
      case 9: ok = wr(f + w[2], w[1], ops); break;
      case 43: ok = wr(f + w[2], fadd(f, w[1]), ops); break;
      case 10:
        ok = wr(f + w[1], f, ops) && wr(f + w[1] + 1, (pc + size_qm31) % P, ops);
        next_pc = w[2];
        next_fp = (uint32_t)((f + w[1] + 2) % P);
        break;
      case 11:
        ok = rd(f + P - 1, &a, ops) && rd(f + P - 2, &b, ops);
        next_pc = (uint32_t)a;
        next_fp = (uint32_t)b;
        break;
      case 12: next_pc = w[1]; break;
      case 13: next_pc = (uint32_t)((pc + (uint64_t)w[1]) % P); break;
      case 14:
        ok = rd(f + w[1], &a, ops);
        if (ok && a != 0) next_pc = (uint32_t)((pc + (uint64_t)w[2]) % P);
        break;
      case 15: case 16: case 17: {
        ok = rd_u32(f + w[1], &a, ops) && rd_u32(f + w[2], &b, ops);
        if (ok) {
          uint64_t r = opcode == 15 ? a + b : opcode == 16 ? a - b : a * b;
          ok = wr_u32(f + w[3], r & 0xffffffffULL, ops);
        }
        break;
      }
      case 18: {
        ok = rd_u32(f + w[1], &a, ops) && rd_u32(f + w[2], &b, ops);
        if (ok && b == 0) return -4;
        if (ok) ok = wr_u32(f + w[3], a / b, ops) && wr_u32(f + w[4], a % b, ops);
        break;
      }
      case 19: case 21: {
        uint64_t imm = ((uint64_t)w[3] << 16) | w[2];
        if (w[2] > U16_MASK || w[3] > U16_MASK) return -6;
        ok = rd_u32(f + w[1], &a, ops);
        if (ok) {
          uint64_t r = opcode == 19 ? a + imm : a * imm;
          ok = wr_u32(f + w[4], r & 0xffffffffULL, ops);
        }
        break;
      }
      case 22: {
        uint64_t imm = ((uint64_t)w[3] << 16) | w[2];
        if (imm == 0) return -4;
        ok = rd_u32(f + w[1], &a, ops);
        if (ok) ok = wr_u32(f + w[4], a / imm, ops) && wr_u32(f + w[5], a % imm, ops);
        break;
      }
      case 23:
        if (w[1] > U16_MASK || w[2] > U16_MASK) return -6;
        ok = wr(f + w[3], w[1], ops) && wr(f + w[3] + 1, w[2], ops);
        break;
      case 24: case 28: {
        ok = rd_u32(f + w[1], &a, ops) && rd_u32(f + w[2], &b, ops);
        if (ok) {
          uint64_t r = opcode == 24 ? (a == b) : (a < b);
          ok = wr(f + w[3], r, ops);
        }
        break;
      }
      case 30: case 34: {
        uint64_t imm = ((uint64_t)w[3] << 16) | w[2];
        ok = rd_u32(f + w[1], &a, ops);
        if (ok) {
          uint64_t r = opcode == 30 ? (a == imm) : (a < imm);
          ok = wr(f + w[4], r, ops);
        }
        break;
      }
      case 36: case 37: case 38: {
        ok = rd_u32(f + w[1], &a, ops) && rd_u32(f + w[2], &b, ops);
        if (ok) {
          uint64_t r = opcode == 36 ? (a & b) : opcode == 37 ? (a | b) : (a ^ b);
          ok = wr_u32(f + w[3], r, ops);
        }
        break;
      }
      case 39: case 40: case 41: {
        uint64_t imm = ((uint64_t)w[3] << 16) | w[2];
        ok = rd_u32(f + w[1], &a, ops);
        if (ok) {
          uint64_t r = opcode == 39 ? (a & imm) : opcode == 40 ? (a | imm) : (a ^ imm);
          ok = wr_u32(f + w[4], r, ops);
        }
        break;
      }
      case 46: case 47: break;  // prints: untraced
      default: return -3;
    }
    if (!ok) return -7;
    for (int i = 0; i < ops.n; i++) out->bundles.push_back(ops.d[i]);
    // fixed-size records (13 + 3*8 = 37 words) for vectorized parsing
    for (int i = ops.n; i < 24; i++) out->bundles.push_back(0);
    pc = next_pc;
    fp = next_fp;
    clock++;
    return 0;
  }
};

// One freed RunResult is pooled so repeated runs (segment loops, benches)
// reuse already-faulted pages: vector::clear keeps capacity, so the large
// bundle buffer stays warm instead of being munmapped and re-faulted.
// ctypes releases the GIL during calls, so pool take/put is mutex-guarded.
RunResult* g_pool = nullptr;
std::mutex g_pool_mu;

// shared run loop + result assembly for cm_run / cm_run_resume
void run_and_finish(RunResult* out, VM& vm, uint64_t max_steps) {
  uint64_t steps = 0;
  while (vm.pc != vm.final_pc && steps < max_steps) {
    int rc = vm.step();
    if (rc != 0) {
      out->status = rc;
      break;
    }
    steps++;
  }
  out->n_steps = steps;
  out->final_pc = vm.pc;
  out->final_fp = vm.fp;
  for (uint32_t a = 0; a < vm.mem.tracked_locals.size(); a++) {
    const auto& c = vm.mem.tracked_locals[a];
    if (!c.touched) continue;
    out->final_mem.push_back(a);
    for (int k = 0; k < 4; k++) out->final_mem.push_back(c.value.v[k]);
    out->final_mem.push_back(c.clock);
  }
  for (uint32_t h = 0; h < vm.mem.tracked_heap.size(); h++) {
    const auto& c = vm.mem.tracked_heap[h];
    if (!c.touched) continue;
    out->final_mem.push_back(MAX_ADDRESS - h);
    for (int k = 0; k < 4; k++) out->final_mem.push_back(c.value.v[k]);
    out->final_mem.push_back(c.clock);
  }
  for (const auto& [addr, c] : vm.mem.sparse_tracked) {
    if (!c.touched) continue;
    out->final_mem.push_back(addr);
    for (int k = 0; k < 4; k++) out->final_mem.push_back(c.value.v[k]);
    out->final_mem.push_back(c.clock);
  }
  out->sparse_dump.clear();
  for (const auto& [addr, v] : vm.mem.sparse_cells) {
    out->sparse_dump.push_back(addr);
    for (int k = 0; k < 4; k++) out->sparse_dump.push_back(v.v[k]);
  }
  out->initial_extra = std::move(vm.mem.initial_extra);
  out->clock_updates = std::move(vm.mem.clock_updates);
  out->final_locals = std::move(vm.mem.locals);
  out->final_heap = std::move(vm.mem.heap);
}

RunResult* pool_take() {
  RunResult* out;
  {
    std::lock_guard<std::mutex> lk(g_pool_mu);
    out = g_pool;
    g_pool = nullptr;
  }
  if (out) {
    out->status = 0;
    out->bundles.clear();
    out->final_mem.clear();
  } else {
    out = new (std::nothrow) RunResult();
  }
  return out;
}

void adopt_pool_buffers(VM& vm, RunResult* out) {
  vm.mem.locals = std::move(out->final_locals);
  vm.mem.locals.clear();
  vm.mem.heap = std::move(out->final_heap);
  vm.mem.heap.clear();
  vm.mem.initial_extra = std::move(out->initial_extra);
  vm.mem.initial_extra.clear();
  vm.mem.clock_updates = std::move(out->clock_updates);
  vm.mem.clock_updates.clear();
}

}  // namespace

extern "C" {

// Runs the program; returns a heap-allocated RunResult*.
// program: n_words QM31 cells (4*n_words u32 values).
// args: arg_count M31 values. Returns NULL on alloc failure.
void* cm_run(const uint32_t* program, uint64_t n_words, uint32_t entry_pc,
             uint32_t fp_offset, const uint32_t* args, uint32_t arg_count,
             uint32_t ret_slots, uint64_t max_steps, uint32_t clock_limit) {
  RunResult* out = pool_take();
  if (!out) return nullptr;
  VM vm;
  vm.out = out;
  // adopt the pooled buffers so their capacity is actually reused (they are
  // move-assigned back into `out` at the end of the run)
  adopt_pool_buffers(vm, out);
  vm.mem.clock_limit = clock_limit;
  try {
  vm.mem.locals.resize(n_words);
  for (uint64_t i = 0; i < n_words; i++)
    std::memcpy(vm.mem.locals[i].v, program + 4 * i, 16);
  vm.final_pc = (uint32_t)n_words;
  uint32_t new_fp = (uint32_t)n_words + fp_offset;
  // args at [new_fp - M - K - 2 + i]
  for (uint32_t i = 0; i < arg_count; i++) {
    uint32_t off = arg_count + ret_slots + 2 - i;
    vm.mem.set_cell(new_fp - off, QM31{{args[i], 0, 0, 0}});
  }
  // entrypoint call cells
  vm.mem.set_cell(new_fp - 2, QM31{{new_fp, 0, 0, 0}});
  vm.mem.set_cell(new_fp - 1, QM31{{vm.final_pc, 0, 0, 0}});
  vm.pc = entry_pc;
  vm.fp = new_fp;
  vm.mem.snapshot = vm.mem.locals;
  vm.mem.snapshot_len = (uint32_t)vm.mem.locals.size();
  run_and_finish(out, vm, max_steps);
  } catch (const std::bad_alloc&) {
    out->status = -8;  // out of memory (returned as a VM error, not a crash)
    out->bundles.clear();
    out->final_mem.clear();
  }
  return out;
}

// Resume a continuation segment from a full memory image (locals ascending,
// heap descending from MAX_ADDRESS, sparse (addr, v0..v3) far-gap cells).
// The whole image becomes the segment's clock-0 snapshot, so first-access
// writes see the previous segment's value — final_root(k) == initial_root(k+1)
// (reference vm/mod.rs:177-227 continuation semantics).
void* cm_run_resume(const uint32_t* locals, uint64_t n_loc,
                    const uint32_t* heap, uint64_t n_heap,
                    const uint32_t* sparse, uint64_t n_sparse,
                    uint32_t pc, uint32_t fp, uint32_t final_pc,
                    uint64_t max_steps, uint32_t clock_limit) {
  RunResult* out = pool_take();
  if (!out) return nullptr;
  VM vm;
  vm.out = out;
  adopt_pool_buffers(vm, out);
  vm.mem.clock_limit = clock_limit;
  try {
  vm.mem.locals.resize(n_loc);
  for (uint64_t i = 0; i < n_loc; i++)
    std::memcpy(vm.mem.locals[i].v, locals + 4 * i, 16);
  vm.mem.heap.resize(n_heap);
  for (uint64_t i = 0; i < n_heap; i++)
    std::memcpy(vm.mem.heap[i].v, heap + 4 * i, 16);
  for (uint64_t i = 0; i < n_sparse; i++) {
    QM31 v;
    std::memcpy(v.v, sparse + 5 * i + 1, 16);
    vm.mem.sparse_cells[sparse[5 * i]] = v;
    vm.mem.snapshot_sparse[sparse[5 * i]] = v;
  }
  vm.mem.snapshot = vm.mem.locals;
  vm.mem.snapshot_len = (uint32_t)n_loc;
  vm.mem.snapshot_heap = vm.mem.heap;
  vm.pc = pc;
  vm.fp = fp;
  vm.final_pc = final_pc;
  run_and_finish(out, vm, max_steps);
  } catch (const std::bad_alloc&) {
    out->status = -8;
    out->bundles.clear();
    out->final_mem.clear();
  }
  return out;
}

int cm_status(void* h) { return ((RunResult*)h)->status; }
uint64_t cm_n_steps(void* h) { return ((RunResult*)h)->n_steps; }
uint32_t cm_final_pc(void* h) { return ((RunResult*)h)->final_pc; }
uint32_t cm_final_fp(void* h) { return ((RunResult*)h)->final_fp; }

uint64_t cm_bundles_len(void* h) { return ((RunResult*)h)->bundles.size(); }
const uint32_t* cm_bundles(void* h) { return ((RunResult*)h)->bundles.data(); }
uint64_t cm_final_mem_len(void* h) { return ((RunResult*)h)->final_mem.size(); }
const uint32_t* cm_final_mem(void* h) { return ((RunResult*)h)->final_mem.data(); }
uint64_t cm_initial_extra_len(void* h) { return ((RunResult*)h)->initial_extra.size(); }
const uint32_t* cm_initial_extra(void* h) { return ((RunResult*)h)->initial_extra.data(); }
uint64_t cm_clock_updates_len(void* h) { return ((RunResult*)h)->clock_updates.size(); }
const uint32_t* cm_clock_updates(void* h) { return ((RunResult*)h)->clock_updates.data(); }
uint64_t cm_locals_len(void* h) { return ((RunResult*)h)->final_locals.size(); }
const uint32_t* cm_locals(void* h) { return (const uint32_t*)((RunResult*)h)->final_locals.data(); }
uint64_t cm_heap_len(void* h) { return ((RunResult*)h)->final_heap.size(); }
uint64_t cm_sparse_len(void* h) { return ((RunResult*)h)->sparse_dump.size(); }
const uint32_t* cm_sparse(void* h) { return ((RunResult*)h)->sparse_dump.data(); }
const uint32_t* cm_heap(void* h) { return (const uint32_t*)((RunResult*)h)->final_heap.data(); }

// Pool (don't release) the freed result: its large buffers stay allocated
// with warm pages for the next cm_run.  At most one result is pooled.
void cm_free(void* h) {
  auto* r = (RunResult*)h;
  RunResult* drop = nullptr;
  {
    std::lock_guard<std::mutex> lk(g_pool_mu);
    if (g_pool) {
      // keep whichever holds the larger bundle buffer
      if (r->bundles.capacity() > g_pool->bundles.capacity()) {
        drop = g_pool;
        g_pool = r;
      } else {
        drop = r;
      }
    } else {
      g_pool = r;
    }
  }
  delete drop;
}
}

// ---------------------------------------------------------------------------
// Poseidon2-M31, T = 16, 8 full + 14 partial rounds: the two-to-one hash of
// the adapter's partial Merkle trees (hash/poseidon2.py: hash(l, r) is
// permute([l, r, 0, .., 0])[0]), one batch a tree level.  The round
// constants come from the caller (the active instance,
// hash/poseidon2_params.py): ext_rc (8, 16), int_rc (14,), diag (16,).

namespace {

constexpr int PT = 16;
constexpr int P_FULL = 8;
constexpr int P_PARTIAL = 14;

inline uint32_t padd(uint32_t a, uint32_t b) {
  uint32_t s = a + b;  // both < 2^31 - 1: no wrap
  return s >= (uint32_t)P ? s - (uint32_t)P : s;
}

inline uint32_t pmul(uint32_t a, uint32_t b) { return (uint32_t)fmul(a, b); }

inline uint32_t psbox(uint32_t x) {
  const uint32_t x2 = pmul(x, x);
  return pmul(pmul(x2, x2), x);
}

// M_E = circ(2 M4, M4, M4, M4), M4 as in eprint 2023/323 section 5.1
inline void p2_external(uint32_t* s) {
  for (int g = 0; g < 4; ++g) {
    uint32_t* x = s + 4 * g;
    const uint32_t t0 = padd(x[0], x[1]);
    const uint32_t t02 = padd(t0, t0);
    const uint32_t t1 = padd(x[2], x[3]);
    const uint32_t t12 = padd(t1, t1);
    const uint32_t t2 = padd(padd(x[1], x[1]), t1);
    const uint32_t t3 = padd(padd(x[3], x[3]), t0);
    const uint32_t t4 = padd(padd(t12, t12), t3);
    const uint32_t t5 = padd(padd(t02, t02), t2);
    x[0] = padd(t3, t5);
    x[1] = t5;
    x[2] = padd(t2, t4);
    x[3] = t4;
  }
  for (int j = 0; j < 4; ++j) {
    const uint32_t c = padd(padd(s[j], s[j + 4]), padd(s[j + 8], s[j + 12]));
    for (int g = 0; g < 4; ++g) s[4 * g + j] = padd(s[4 * g + j], c);
  }
}

void p2_permute(uint32_t* s, const uint32_t* ext_rc, const uint32_t* int_rc,
                const uint32_t* diag) {
  p2_external(s);
  for (int r = 0; r < P_FULL; ++r) {
    if (r == P_FULL / 2) {
      for (int k = 0; k < P_PARTIAL; ++k) {
        s[0] = psbox(padd(s[0], int_rc[k]));
        uint32_t total = s[0];
        for (int i = 1; i < PT; ++i) total = padd(total, s[i]);
        for (int i = 0; i < PT; ++i) s[i] = padd(pmul(s[i], diag[i]), total);
      }
    }
    for (int i = 0; i < PT; ++i) s[i] = psbox(padd(s[i], ext_rc[r * PT + i]));
    p2_external(s);
  }
}

}  // namespace

extern "C" {

// out[i] = hash(left[i], right[i]) for i < n, on up to n_threads threads.
void cm_poseidon2_hash2(const uint32_t* left, const uint32_t* right,
                        uint32_t* out, uint64_t n, const uint32_t* ext_rc,
                        const uint32_t* int_rc, const uint32_t* diag,
                        uint32_t n_threads) {
  auto work = [&](uint64_t lo, uint64_t hi) {
    for (uint64_t i = lo; i < hi; ++i) {
      uint32_t s[PT] = {left[i], right[i]};
      p2_permute(s, ext_rc, int_rc, diag);
      out[i] = s[0];
    }
  };
  // below a few thousand hashes a thread costs more than it saves
  const uint64_t per = 4096;
  uint64_t k = (n + per - 1) / per;
  if (k > n_threads) k = n_threads;
  if (k <= 1) {
    work(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(k - 1);
  const uint64_t step = (n + k - 1) / k;
  for (uint64_t t = 1; t < k; ++t) {
    const uint64_t lo = t * step, hi = lo + step < n ? lo + step : n;
    if (lo < hi) pool.emplace_back(work, lo, hi);
  }
  work(0, step < n ? step : n);
  for (auto& th : pool) th.join();
}

}
