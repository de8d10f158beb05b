"""Witness preparation: runner segments -> ProverInput arrays.

Port of `crates/prover/src/adapter/{mod,memory}.rs` (SURVEY.md §2.4):

- replays the memory log step by step, tracking per-cell (value, clock)
  to produce each access's (prev_clock, prev_value);
- clock 0 is reserved for preloaded memory; execution clocks start at 1;
- a first access to a cell inserts it into *initial memory* with clock 0
  and multiplicity +1 (first-writes adopt the written value, matching the
  reference's write-as-if-present model);
- clock gaps > RC20_LIMIT emit clock_update rows every RC20_LIMIT strides
  (value = the cell's tracked previous value; the reference uses the
  initial-memory value, which coincides on every path its tests exercise —
  adapter/memory.rs:509-526);
- public program/input/output addresses get their multiplicities fixed up so
  the public data emits/consumes them instead (adapter/memory.rs:427-461);
- execution bundles are grouped by opcode into struct-of-arrays NumPy
  bundles ready for vectorized per-opcode witness generation.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...isa.instruction import SPECS_BY_OPCODE
from ...isa.program import PublicAddressRanges

P = (1 << 31) - 1
LOG_SIZE_RC_20 = 20
RC20_LIMIT = (1 << LOG_SIZE_RC_20) - 1  # production value (runner lib.rs:15)
MAX_OPERANDS = 8  # u32 div-rem fp fp: 4 u32 operands = 8 limb accesses


def rc_limit() -> int:
    """Clock range-check span; reads the active ProtocolScale (test runs
    shrink it, see prover/config.py)."""
    from ..config import SCALE

    return SCALE.rc_limit()


class VmImportError(Exception):
    pass


@dataclass
class OpcodeBundles:
    """Struct-of-arrays execution bundles for one opcode."""

    opcode: int
    pc: np.ndarray
    fp: np.ndarray
    clock: np.ndarray
    inst_prev_clock: np.ndarray
    operands: np.ndarray  # (n, spec.memory_accesses, 3): prev_clock, prev_value, value
    instr_words: np.ndarray  # (n, size_m31) operand words incl. opcode

    @property
    def n(self):
        return len(self.pc)


@dataclass
class MerkleTreesData:
    initial_nodes: dict  # field name -> np arrays (see build_partial_merkle_tree)
    final_nodes: dict
    initial_root: int | None
    final_root: int | None


@dataclass
class ProverInput:
    initial_memory: dict  # addr -> (value4, clock, mult) after fixups
    final_memory: dict
    clock_update_data: list  # (addr, prev_clk, value4)
    initial_registers: tuple  # (pc, fp)
    final_registers: tuple
    states_by_opcodes: dict  # opcode -> OpcodeBundles
    merkle_trees: MerkleTreesData
    poseidon2_inputs: np.ndarray  # (n, 16) uint32
    public_address_ranges: object
    total_steps: int


def import_from_runner_output(segment, public_address_ranges) -> ProverInput:
    trace = segment.trace
    if not trace:
        raise VmImportError("Empty trace")
    mem_iter = iter(segment.memory_trace)

    initial_memory = {a: (tuple(v), c, m) for a, (v, c, m) in segment.initial_memory.items()}
    final_memory = dict(initial_memory)
    clock_update_data: list = []

    initial_registers = (trace[0].pc, trace[0].fp)
    final_registers = (trace[-1].pc, trace[-1].fp)

    # raw per-opcode bundle collection (python lists; packed to numpy below)
    raw: dict[int, list] = {}

    def push(addr, value, clock):
        """Returns (prev_clock_adjusted, prev_value4)."""
        prev = final_memory.get(addr)
        if prev is None:
            prev_value, prev_clk = value, 0
        else:
            prev_value, prev_clk = prev[0], prev[1]
        final_memory[addr] = (value, clock, P - 1)  # mult -1
        if prev_clk == 0:
            im = initial_memory.get(addr)
            if im is not None:
                initial_memory[addr] = (im[0], im[1], 1)
            else:
                initial_memory[addr] = (value, 0, 1)
                prev_value = value
        delta = clock - prev_clk
        limit = rc_limit()
        if delta > limit:
            num_steps = (delta - 1) // limit
            for _ in range(num_steps):
                clock_update_data.append((addr, prev_clk, prev_value))
                prev_clk += limit
        return prev_clk, prev_value

    clock = 1
    n_steps = len(trace) - 1
    for si in range(n_steps):
        st = trace[si]
        try:
            a0, v0 = next(mem_iter)
        except StopIteration:
            raise VmImportError("Unexpected end of memory trace")
        inst_prev_clk, _ = push(a0, v0, clock)
        opcode = v0[0]
        spec = SPECS_BY_OPCODE.get(opcode)
        if spec is None:
            raise VmImportError(f"Invalid opcode {opcode}")
        size = spec.size
        words = list(v0[:size]) if size <= 4 else list(v0)
        if size > 4:
            a1, v1 = next(mem_iter)
            push(a1, v1, clock)
            words += list(v1[: size - 4])
        operands = []
        for _ in range(spec.memory_accesses):
            aa, vv = next(mem_iter)
            pclk, pval = push(aa, vv, clock)
            operands.append((pclk, pval[0], vv[0]))
        raw.setdefault(opcode, []).append(
            (st.pc, st.fp, clock, inst_prev_clk, words, operands)
        )
        clock += 1

    # public-address multiplicity fixups (adapter/memory.rs:427-461)
    for addr in list(public_address_ranges.program) + list(public_address_ranges.input):
        if addr in initial_memory:
            v, c, _ = initial_memory[addr]
            initial_memory[addr] = (v, c, 0)
        if addr in final_memory and final_memory[addr][2] == 0:
            v, c, _ = final_memory[addr]
            final_memory[addr] = (v, c, P - 1)
    for addr in public_address_ranges.output:
        if addr in final_memory:
            v, c, _ = final_memory[addr]
            final_memory[addr] = (v, c, 0)
        if addr in initial_memory:
            v, c, _ = initial_memory[addr]
            initial_memory[addr] = (v, c, 1)

    # pack bundles
    states_by_opcodes = {}
    for opcode, items in raw.items():
        spec = SPECS_BY_OPCODE[opcode]
        n = len(items)
        pc = np.array([it[0] for it in items], dtype=np.uint32)
        fp = np.array([it[1] for it in items], dtype=np.uint32)
        ck = np.array([it[2] for it in items], dtype=np.uint32)
        ipc = np.array([it[3] for it in items], dtype=np.uint32)
        words = np.zeros((n, spec.size), dtype=np.uint32)
        ops = np.zeros((n, spec.memory_accesses, 3), dtype=np.uint32)
        for i, it in enumerate(items):
            words[i, : len(it[4])] = it[4]
            for j, (pclk, pval, val) in enumerate(it[5]):
                ops[i, j] = (pclk, pval, val)
        states_by_opcodes[opcode] = OpcodeBundles(opcode, pc, fp, ck, ipc, ops, words)

    from .merkle import build_partial_merkle_tree

    initial_nodes, initial_root = build_partial_merkle_tree(
        initial_memory, "initial", public_address_ranges
    )
    final_nodes, final_root = build_partial_merkle_tree(
        final_memory, "final", public_address_ranges
    )

    # poseidon2 inputs: [left, right, 0...] per node, both trees in order
    def hash_inputs(nodes):
        n = len(nodes["index"])
        out = np.zeros((n, 16), dtype=np.uint32)
        out[:, 0] = nodes["left_value"]
        out[:, 1] = nodes["right_value"]
        return out

    poseidon2_inputs = np.concatenate(
        [hash_inputs(initial_nodes), hash_inputs(final_nodes)], axis=0
    )

    return ProverInput(
        initial_memory=initial_memory,
        final_memory=final_memory,
        clock_update_data=clock_update_data,
        initial_registers=initial_registers,
        final_registers=final_registers,
        states_by_opcodes=states_by_opcodes,
        merkle_trees=MerkleTreesData(
            initial_nodes, final_nodes, initial_root, final_root
        ),
        poseidon2_inputs=poseidon2_inputs,
        public_address_ranges=public_address_ranges,
        total_steps=n_steps,
    )


def from_reference_prover_input(pi) -> ProverInput:
    """The JAX package's ``ProverInput`` (NumPy fields, same layout) as this
    package's, so both packages can prove the very same input.  Values cross
    as plain data: no object of the other package is kept."""
    mt = pi.merkle_trees
    r = pi.public_address_ranges
    return ProverInput(
        initial_memory=dict(pi.initial_memory),
        final_memory=dict(pi.final_memory),
        clock_update_data=list(pi.clock_update_data),
        initial_registers=tuple(pi.initial_registers),
        final_registers=tuple(pi.final_registers),
        states_by_opcodes={
            op: OpcodeBundles(
                b.opcode, b.pc, b.fp, b.clock, b.inst_prev_clock, b.operands,
                b.instr_words,
            )
            for op, b in pi.states_by_opcodes.items()
        },
        merkle_trees=MerkleTreesData(
            dict(mt.initial_nodes), dict(mt.final_nodes), mt.initial_root,
            mt.final_root,
        ),
        poseidon2_inputs=pi.poseidon2_inputs,
        public_address_ranges=PublicAddressRanges(
            *(range(x.start, x.stop) for x in (r.program, r.input, r.output))
        ),
        total_steps=int(pi.total_steps),
    )
