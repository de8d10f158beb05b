"""Declarative opcode AIR components.

Every opcode component proves, per executed instruction of its opcode
(reference components/opcodes/* — SURVEY.md §2.5):

- registers chain:      -[pc, fp, clk] +[next_pc, next_fp, clk+1]  (Registers)
- instruction fetch:    -[pc, iprev, w0..w3] +[pc, clk, w0..w3]    (Memory)
                        (+ second word pair for 5/6-word instructions,
                        sharing inst_prev_clock — both cells are always
                        fetched together)
- rc20 on clk - iprev - 1
- per operand access (in VM handler order):
    Read:  -[addr, prev_clk, v] +[addr, clk, v];       rc20(clk-prev-1)
    Write: -[addr, prev_clk, prev_v] +[addr, clk, new]; rc20(clk-prev-1)
- opcode-specific hint columns + algebraic constraints.

The DSL: an `OpcodeSpec` lists field names (from the ISA), accesses and
hints as small lambdas over a namespace of Vals; `GenericOpcodeComponent`
derives the trace layout, witness generation (vectorized NumPy from the
adapter's OpcodeBundles) and `evaluate` from it.

Trace column order: enabler, pc, fp, clock, inst_prev_clock,
fields..., per-access (prev_clock [, value|prev_value]), hints...
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield
from typing import Callable, Optional

import numpy as np

from ..instruction import SPECS_BY_OPCODE
from ..air import Component
from .generic import _pad_len, enabler_col

P = (1 << 31) - 1


@dataclass
class Read:
    """A memory read: value column committed; emits same value back."""

    addr: Callable  # ns -> Val address
    name: str  # namespace key for the value ("op0", "cond", ...)


@dataclass
class Write:
    """A memory write: prev_value column committed.

    ``commit_value=False``: the new value expression must be *linear* in
    committed columns (it feeds the Memory relation directly).
    ``commit_value=True``: a value column is committed, constrained
    ``enabler * (value_col - value_expr) = 0`` (expr degree <= 2), and the
    relation uses the linear column — needed for products (mul, div).
    """

    addr: Callable
    value: Callable  # ns -> Val new value
    name: str  # namespace key for prev value ("dst_prev")
    commit_value: bool = False
    value_name: str = ""


@dataclass
class ReadExpr:
    """A memory read whose relation value is an expression over ns (e.g. a
    linear combination of 8-bit hint columns); only prev_clock is committed."""

    addr: Callable
    value: Callable  # ns -> Val


@dataclass
class Hint:
    """Extra witness column; compute(bundle arrays dict) -> np column."""

    name: str
    compute: Callable


@dataclass
class OpcodeSpec:
    name: str
    opcode: int
    accesses: list  # of Read/Write, in VM handler order
    next_pc: Callable  # ns -> Val
    next_fp: Callable  # ns -> Val (default: fp)
    hints: list = dfield(default_factory=list)
    constraints: Callable = None  # (ns, ev, relations) -> None  (extra)


class GenericOpcodeComponent(Component):
    def __init__(self, relations, spec: OpcodeSpec):
        self.relations = relations
        self.spec = spec
        self.name = spec.name
        self.isa = SPECS_BY_OPCODE[spec.opcode]
        self.field_names = [f for f, _ in self.isa.fields]
        n_access_cols = sum(
            1 if isinstance(a, ReadExpr)
            else (3 if isinstance(a, Write) and a.commit_value else 2)
            for a in spec.accesses
        )
        self.n_trace_cols = (
            5 + len(self.field_names) + n_access_cols + len(spec.hints)
        )
        # sanity: access list must cover the ISA memory access count
        assert len(spec.accesses) == self.isa.memory_accesses, (
            spec.name,
            len(spec.accesses),
            self.isa.memory_accesses,
        )

    def n_lookups(self):
        # base formula (registers(2) + instruction pairs(2 per word) +
        # rc20(inst) + per access 2 memory + 1 rc20) undercounts specs whose
        # extra constraints add rc8/rc16/bitwise lookups — count by dry run.
        from ..air import count_lookups

        return count_lookups(self)

    # ------------------------------------------------------------------
    # Witness generation from adapter bundles
    # ------------------------------------------------------------------

    def write_trace(self, prover_input):
        bundles = prover_input.states_by_opcodes.get(self.spec.opcode)
        if bundles is None:
            n = 0
            size = _pad_len(0)
            self.log_size = size.bit_length() - 1
            self.non_padded_length = 0
            self.zero_witness = True
            self.trace_rows = [
                np.zeros(size, dtype=np.uint32) for _ in range(self.n_trace_cols)
            ]
            return self
        n = bundles.n
        size = _pad_len(n)
        self.log_size = size.bit_length() - 1
        self.non_padded_length = n
        self.zero_witness = False

        def pad(col):
            out = np.zeros(size, dtype=np.uint32)
            out[:n] = col
            return out

        cols = [enabler_col(n, size), pad(bundles.pc), pad(bundles.fp),
                pad(bundles.clock), pad(bundles.inst_prev_clock)]
        # operand field columns from instruction words (skip the opcode word)
        for i, _ in enumerate(self.field_names):
            cols.append(pad(bundles.instr_words[:, 1 + i]))
        # access columns
        for j, acc in enumerate(self.spec.accesses):
            prev_clk = bundles.operands[:, j, 0]
            prev_val = bundles.operands[:, j, 1]
            val = bundles.operands[:, j, 2]
            cols.append(pad(prev_clk))
            if isinstance(acc, ReadExpr):
                continue
            cols.append(pad(val if isinstance(acc, Read) else prev_val))
            if isinstance(acc, Write) and acc.commit_value:
                cols.append(pad(val))
        # hints
        ctx = {
            "pc": bundles.pc, "fp": bundles.fp, "clock": bundles.clock,
            "operands": bundles.operands, "words": bundles.instr_words,
        }
        for h in self.spec.hints:
            cols.append(pad(h.compute(ctx).astype(np.uint32)))
        assert len(cols) == self.n_trace_cols
        self.trace_rows = cols
        return self

    # ------------------------------------------------------------------
    # Constraints
    # ------------------------------------------------------------------

    def evaluate(self, ev):
        rel = self.relations
        ns = {}
        enabler = ev.next_trace_mask()
        pc = ev.next_trace_mask()
        fp = ev.next_trace_mask()
        clock = ev.next_trace_mask()
        iprev = ev.next_trace_mask()
        ns.update(enabler=enabler, pc=pc, fp=fp, clock=clock)
        for fname in self.field_names:
            ns[fname] = ev.next_trace_mask()
        acc_cols = []
        for acc in self.spec.accesses:
            prev_clk = ev.next_trace_mask()
            if isinstance(acc, ReadExpr):
                acc_cols.append((acc, prev_clk, None, None))
                continue
            v = ev.next_trace_mask()
            vcol = None
            if isinstance(acc, Write) and acc.commit_value:
                vcol = ev.next_trace_mask()
                ns[acc.value_name] = vcol
            acc_cols.append((acc, prev_clk, v, vcol))
            ns[acc.name] = v
        for h in self.spec.hints:
            ns[h.name] = ev.next_trace_mask()

        ev.add_constraint(enabler * (1 - enabler))

        # registers chain
        size_qm31 = (self.isa.size + 3) // 4
        next_pc = self.spec.next_pc(ns)
        next_fp = self.spec.next_fp(ns) if self.spec.next_fp else fp
        ev.add_to_relation(rel.registers, -enabler, [pc, fp, clock])
        ev.add_to_relation(rel.registers, enabler, [next_pc, next_fp, clock + 1])

        # instruction fetch: word values = [opcode const, fields...]
        w = [ev.const(self.isa.opcode)] + [ns[f] for f in self.field_names]
        first = w[:4] + [ev.const(0)] * (4 - min(4, len(w)))
        ev.add_to_relation(rel.memory, -enabler, [pc, iprev] + first)
        ev.add_to_relation(rel.memory, enabler, [pc, clock] + first)
        if size_qm31 == 2:
            second = w[4:] + [ev.const(0)] * (4 - len(w[4:]))
            ev.add_to_relation(rel.memory, -enabler, [pc + 1, iprev] + second)
            ev.add_to_relation(rel.memory, enabler, [pc + 1, clock] + second)
        ev.add_to_relation(rel.range_check_20, -enabler, [clock - iprev - 1])

        # operand accesses
        for acc, prev_clk, v, vcol in acc_cols:
            addr = acc.addr(ns)
            if isinstance(acc, ReadExpr):
                val = acc.value(ns)
                new_val = val
                prev_val = val
            elif isinstance(acc, Read):
                new_val = v
                prev_val = v
            elif acc.commit_value:
                ev.add_constraint(enabler * (vcol - acc.value(ns)))
                new_val = vcol
                prev_val = v
            else:
                new_val = acc.value(ns)
                prev_val = v
            ev.add_to_relation(rel.memory, -enabler, [addr, prev_clk, prev_val])
            ev.add_to_relation(rel.memory, enabler, [addr, clock, new_val])
            ev.add_to_relation(rel.range_check_20, -enabler, [clock - prev_clk - 1])

        # opcode-specific constraints
        if self.spec.constraints:
            self.spec.constraints(ns, ev, rel)

        ev.finalize_logup_in_pairs()
