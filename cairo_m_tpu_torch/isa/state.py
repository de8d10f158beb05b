"""Execution state types (reference `crates/common/src/{state,execution}.rs`).

``State`` = (pc, fp) register pair; ``MemoryEntry`` = one logged memory
access (addr, QM31 value); ``Segment`` = one continuation unit: snapshot of
initial memory + memory-access log + per-step register trace, serialized with
the same little-endian u32 layout as the reference.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

P = (1 << 31) - 1


@dataclass(frozen=True)
class State:
    pc: int
    fp: int


@dataclass
class Segment:
    # addr -> (qm31 value tuple, clock, multiplicity) — clock/mult start at 0
    initial_memory: dict
    memory_trace: list  # of (addr, (v0, v1, v2, v3))
    trace: list  # of State

    def serialize_trace(self) -> bytes:
        """fp, pc as LE u32 pairs per step (execution.rs:28-41)."""
        out = bytearray()
        for s in self.trace:
            out += struct.pack("<II", s.fp, s.pc)
        return bytes(out)

    def serialize_memory_trace(self) -> bytes:
        """addr + 4 QM31 limbs as LE u32 per entry (execution.rs:43-66)."""
        out = bytearray()
        for addr, v in self.memory_trace:
            out += struct.pack("<5I", addr, *v)
        return bytes(out)
