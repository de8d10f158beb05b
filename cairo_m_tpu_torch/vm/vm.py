"""The Cairo-M virtual machine: two registers (pc, fp), QM31 memory,
continuation segments.

Exact behavioral port of `crates/runner/src/vm/mod.rs` + the per-opcode
handlers in `vm/instructions/*.rs`:

- program QM31 words load at address 0; initial fp = program length;
- `step()` = fetch (logs 1-2 instruction-cell reads) -> decode -> dispatch;
  the register trace records the state *before* each step, and the final
  state is appended once execution stops (vm/mod.rs:158-175);
- pc advances in QM31-cell units (`size_in_qm31s = ceil(size_m31 / 4)`);
- hitting ``max_steps`` finalizes a continuation segment: memory snapshot
  becomes the next segment's ``initial_memory`` (locals -> addr i, heap ->
  MAX_ADDRESS - i), and the trace + memory log move into the segment.

Decoded instructions are cached per address and validated against the raw
fetched cells each step, so self-modifying code stays correct while the hot
loop skips re-decoding.
"""

from __future__ import annotations

from ..isa.instruction import SPECS_BY_OPCODE, Instruction
from ..isa.state import Segment, State
from .memory import MAX_ADDRESS, Memory, MemoryError, U32_LIMB_MASK, ZERO

P = (1 << 31) - 1

DEFAULT_MAX_STEPS = (1 << 20) - 1  # RC20 clock-diff bound (runner/src/lib.rs:15)


class VmError(Exception):
    pass


def _finv(x: int) -> int:
    if x == 0:
        raise VmError("Division by zero (felt)")
    return pow(x, P - 2, P)


# ---------------------------------------------------------------------------
# Handlers: fn(mem, pc, fp, ops, size_qm31) -> (pc, fp)
# ops = tuple of explicit operand values
# ---------------------------------------------------------------------------


def _h_store_add_fp_fp(m, pc, fp, o, sz):
    v = (m.get_data((fp + o[0]) % P) + m.get_data((fp + o[1]) % P)) % P
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_sub_fp_fp(m, pc, fp, o, sz):
    v = (m.get_data((fp + o[0]) % P) - m.get_data((fp + o[1]) % P)) % P
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_mul_fp_fp(m, pc, fp, o, sz):
    v = (m.get_data((fp + o[0]) % P) * m.get_data((fp + o[1]) % P)) % P
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_div_fp_fp(m, pc, fp, o, sz):
    v = (m.get_data((fp + o[0]) % P) * _finv(m.get_data((fp + o[1]) % P))) % P
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_add_fp_imm(m, pc, fp, o, sz):
    v = (m.get_data((fp + o[0]) % P) + o[1]) % P
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_mul_fp_imm(m, pc, fp, o, sz):
    v = (m.get_data((fp + o[0]) % P) * o[1]) % P
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_le_fp_imm(m, pc, fp, o, sz):
    v = 1 if m.get_data((fp + o[0]) % P) <= o[1] else 0
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_assert_eq_fp_imm(m, pc, fp, o, sz):
    v = m.get_data((fp + o[0]) % P)
    if v != o[1]:
        raise VmError(f"Assertion failed: {v} != {o[1]}")
    return pc + sz, fp


def _h_store_double_deref_fp(m, pc, fp, o, sz):
    base = m.get_data((fp + o[0]) % P)
    v = m.get_data((base + o[1]) % P)
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_double_deref_fp_fp(m, pc, fp, o, sz):
    base = m.get_data((fp + o[0]) % P)
    off = m.get_data((fp + o[1]) % P)
    v = m.get_data((base + off) % P)
    m.insert((fp + o[2]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_to_double_deref_fp_imm(m, pc, fp, o, sz):
    base = m.get_data((fp + o[0]) % P)
    v = m.get_data((fp + o[2]) % P)
    m.insert((base + o[1]) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_to_double_deref_fp_fp(m, pc, fp, o, sz):
    base = m.get_data((fp + o[0]) % P)
    off = m.get_data((fp + o[1]) % P)
    v = m.get_data((fp + o[2]) % P)
    m.insert((base + off) % P, (v, 0, 0, 0))
    return pc + sz, fp


def _h_store_imm(m, pc, fp, o, sz):
    m.insert((fp + o[1]) % P, (o[0], 0, 0, 0))
    return pc + sz, fp


def _h_store_frame_pointer(m, pc, fp, o, sz):
    m.insert((fp + o[1]) % P, ((fp + o[0]) % P, 0, 0, 0))
    return pc + sz, fp


def _h_call_abs_imm(m, pc, fp, o, sz):
    frame_off, target = o
    m.insert((fp + frame_off) % P, (fp, 0, 0, 0))
    m.insert((fp + frame_off + 1) % P, ((pc + sz) % P, 0, 0, 0))
    return target, (fp + frame_off + 2) % P


def _h_ret(m, pc, fp, o, sz):
    new_pc = m.get_data((fp - 1) % P)
    new_fp = m.get_data((fp - 2) % P)
    return new_pc, new_fp


def _h_jmp_abs_imm(m, pc, fp, o, sz):
    return o[0], fp


def _h_jmp_rel_imm(m, pc, fp, o, sz):
    return (pc + o[0]) % P, fp


def _h_jnz_fp_imm(m, pc, fp, o, sz):
    cond = m.get_data((fp + o[0]) % P)
    if cond != 0:
        return (pc + o[1]) % P, fp
    return pc + sz, fp


def _u32_imm(lo, hi):
    if lo > U32_LIMB_MASK or hi > U32_LIMB_MASK:
        raise MemoryError(f"U32 limbs out of range: lo={lo} hi={hi}")
    return (hi << 16) | lo


def _mk_u32_bin_fp_fp(op):
    def h(m, pc, fp, o, sz):
        a = m.get_u32((fp + o[0]) % P)
        b = m.get_u32((fp + o[1]) % P)
        m.insert_u32((fp + o[2]) % P, op(a, b) & 0xFFFFFFFF)
        return pc + sz, fp

    return h


def _mk_u32_bin_fp_imm(op):
    def h(m, pc, fp, o, sz):
        imm = _u32_imm(o[1], o[2])
        a = m.get_u32((fp + o[0]) % P)
        m.insert_u32((fp + o[3]) % P, op(a, imm) & 0xFFFFFFFF)
        return pc + sz, fp

    return h


def _mk_u32_cmp_fp_fp(op):
    def h(m, pc, fp, o, sz):
        a = m.get_u32((fp + o[0]) % P)
        b = m.get_u32((fp + o[1]) % P)
        m.insert((fp + o[2]) % P, (1 if op(a, b) else 0, 0, 0, 0))
        return pc + sz, fp

    return h


def _mk_u32_cmp_fp_imm(op):
    def h(m, pc, fp, o, sz):
        imm = _u32_imm(o[1], o[2])
        a = m.get_u32((fp + o[0]) % P)
        m.insert((fp + o[3]) % P, (1 if op(a, imm) else 0, 0, 0, 0))
        return pc + sz, fp

    return h


def _h_u32_div_rem_fp_fp(m, pc, fp, o, sz):
    a = m.get_u32((fp + o[0]) % P)
    b = m.get_u32((fp + o[1]) % P)
    if b == 0:
        raise VmError("Division by zero (u32)")
    m.insert_u32((fp + o[2]) % P, a // b)
    m.insert_u32((fp + o[3]) % P, a % b)
    return pc + sz, fp


def _h_u32_div_rem_fp_imm(m, pc, fp, o, sz):
    imm = _u32_imm(o[1], o[2])
    if imm == 0:
        raise VmError("Division by zero (u32)")
    a = m.get_u32((fp + o[0]) % P)
    m.insert_u32((fp + o[3]) % P, a // imm)
    m.insert_u32((fp + o[4]) % P, a % imm)
    return pc + sz, fp


def _h_u32_store_imm(m, pc, fp, o, sz):
    _u32_imm(o[0], o[1])
    m.insert((fp + o[2]) % P, (o[0], 0, 0, 0))
    m.insert((fp + o[2] + 1) % P, (o[1], 0, 0, 0))
    return pc + sz, fp


def _h_print_m31(m, pc, fp, o, sz):
    v = m.get_data_no_trace((fp + o[0]) % P)
    print(f"[print] M31 [fp+{o[0]}] = {v}")
    return pc + sz, fp


def _h_print_u32(m, pc, fp, o, sz):
    v = m.get_u32_no_trace((fp + o[0]) % P)
    print(f"[print] U32 [fp+{o[0]}] = {v}")
    return pc + sz, fp


HANDLERS = {
    0: _h_store_add_fp_fp,
    1: _h_store_sub_fp_fp,
    2: _h_store_mul_fp_fp,
    3: _h_store_div_fp_fp,
    4: _h_store_add_fp_imm,
    6: _h_store_mul_fp_imm,
    48: _h_store_le_fp_imm,
    50: _h_assert_eq_fp_imm,
    8: _h_store_double_deref_fp,
    42: _h_store_double_deref_fp_fp,
    44: _h_store_to_double_deref_fp_imm,
    45: _h_store_to_double_deref_fp_fp,
    9: _h_store_imm,
    43: _h_store_frame_pointer,
    10: _h_call_abs_imm,
    11: _h_ret,
    12: _h_jmp_abs_imm,
    13: _h_jmp_rel_imm,
    14: _h_jnz_fp_imm,
    15: _mk_u32_bin_fp_fp(lambda a, b: a + b),
    16: _mk_u32_bin_fp_fp(lambda a, b: a - b),
    17: _mk_u32_bin_fp_fp(lambda a, b: a * b),
    18: _h_u32_div_rem_fp_fp,
    19: _mk_u32_bin_fp_imm(lambda a, b: a + b),
    21: _mk_u32_bin_fp_imm(lambda a, b: a * b),
    22: _h_u32_div_rem_fp_imm,
    23: _h_u32_store_imm,
    24: _mk_u32_cmp_fp_fp(lambda a, b: a == b),
    28: _mk_u32_cmp_fp_fp(lambda a, b: a < b),
    30: _mk_u32_cmp_fp_imm(lambda a, b: a == b),
    34: _mk_u32_cmp_fp_imm(lambda a, b: a < b),
    36: _mk_u32_bin_fp_fp(lambda a, b: a & b),
    37: _mk_u32_bin_fp_fp(lambda a, b: a | b),
    38: _mk_u32_bin_fp_fp(lambda a, b: a ^ b),
    39: _mk_u32_bin_fp_imm(lambda a, b: a & b),
    40: _mk_u32_bin_fp_imm(lambda a, b: a | b),
    41: _mk_u32_bin_fp_imm(lambda a, b: a ^ b),
    46: _h_print_m31,
    47: _h_print_u32,
}


class VM:
    """See module docstring.  Public attributes mirror the reference VM."""

    def __init__(self, program):
        words = program.qm31_words()
        self.memory = Memory(words)
        self.program_length = len(words)
        self.final_pc = len(words)
        self.pc = 0
        self.fp = self.final_pc
        self.trace_pc: list = []
        self.trace_fp: list = []
        self.segments: list = []
        self._initial_locals = None
        self._initial_heap = None
        self._decode_cache: dict = {}

    # -- fetch + dispatch --

    def step(self):
        m = self.memory
        pc = self.pc
        locals_ = m.locals
        if pc >= len(locals_):
            raise VmError(f"Uninitialized instruction cell at pc={pc}")
        cell0 = locals_[pc]
        m.trace_addrs.append(pc)
        m.trace_values.append(cell0)
        cached = self._decode_cache.get(pc)
        if cached is not None and cached[0] is cell0:
            _, cell1_expected, handler, ops, sz = cached
            if sz == 2:
                cell1 = locals_[pc + 1]
                m.trace_addrs.append(pc + 1)
                m.trace_values.append(cell1)
                if cell1 is not cell1_expected:
                    cached = None
                    handler, ops, sz = self._decode(pc, cell0)
        else:
            handler, ops, sz = self._decode(pc, cell0)
            if sz == 2:
                cell1 = locals_[pc + 1]
                m.trace_addrs.append(pc + 1)
                m.trace_values.append(cell1)
        self.trace_pc.append(pc)
        self.trace_fp.append(self.fp)
        self.pc, self.fp = handler(m, pc, self.fp, ops, sz)

    def _decode(self, pc, cell0):
        opcode = cell0[0]
        spec = SPECS_BY_OPCODE.get(opcode)
        if spec is None:
            raise VmError(f"Invalid opcode: {opcode}")
        size_m31 = spec.size
        sz = (size_m31 + 3) // 4
        words = list(cell0)
        cell1 = None
        if sz == 2:
            if pc + 1 >= len(self.memory.locals):
                raise VmError(f"Uninitialized instruction cell at pc={pc + 1}")
            cell1 = self.memory.locals[pc + 1]
            words += list(cell1)
        ops = tuple(words[1:size_m31])
        handler = HANDLERS[opcode]
        self._decode_cache[pc] = (cell0, cell1, handler, ops, sz)
        return handler, ops, sz

    # -- execution loop --

    def _execute(self, max_steps: int) -> bool:
        """Run until final_pc or max_steps; returns True when complete."""
        if self.final_pc == 0:
            return True
        step = self.step
        while self.pc != self.final_pc and len(self.trace_pc) < max_steps:
            step()
        self.trace_pc.append(self.pc)
        self.trace_fp.append(self.fp)
        return self.pc == self.final_pc

    def finalize_segment(self, is_last: bool):
        if is_last:
            locals_, heap = self._initial_locals, self._initial_heap
            self._initial_locals = self._initial_heap = None
        else:
            locals_, heap = self._initial_locals, self._initial_heap
            self._initial_locals = list(self.memory.locals)
            self._initial_heap = list(self.memory.heap)
        initial_memory = {i: (v, 0, 0) for i, v in enumerate(locals_)}
        for i, v in enumerate(heap):
            initial_memory[MAX_ADDRESS - i] = (v, 0, 0)
        m = self.memory
        self.segments.append(
            Segment(
                initial_memory,
                list(zip(m.trace_addrs, m.trace_values)),
                [State(p, f) for p, f in zip(self.trace_pc, self.trace_fp)],
            )
        )
        m.trace_addrs.clear()
        m.trace_values.clear()
        self.trace_pc.clear()
        self.trace_fp.clear()

    def run_from_entrypoint(
        self, pc_entrypoint: int, fp_offset: int, args, num_return_values: int,
        max_steps: int = DEFAULT_MAX_STEPS,
    ):
        """Entry ABI (vm/mod.rs:249-285): args at [new_fp - M - K - 2 + i],
        call-stack cells [fp-2]=fp, [fp-1]=final_pc (untraced)."""
        new_fp = self.fp + fp_offset
        n = len(args)
        for i, arg in enumerate(args):
            offset = n + num_return_values + 2 - i
            self.memory.insert_no_trace(new_fp - offset, (arg, 0, 0, 0))
        self.pc = pc_entrypoint
        self.fp = new_fp
        self.memory.insert_entrypoint_call(self.final_pc, new_fp)
        self._initial_locals = list(self.memory.locals)
        self._initial_heap = list(self.memory.heap)
        while True:
            if self._execute(max_steps):
                self.finalize_segment(True)
                break
            self.finalize_segment(False)
