"""The 8 LogUp relations of the Cairo-M AIR (reference relations.rs:7-47).

Draw order is fixed and replayed identically by prover and verifier.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .air import Relation

INTERACTION_POW_BITS = 2


@dataclass
class Relations:
    range_check_8: Relation = field(default_factory=lambda: Relation("RangeCheck8", 1))
    range_check_16: Relation = field(default_factory=lambda: Relation("RangeCheck16", 1))
    range_check_20: Relation = field(default_factory=lambda: Relation("RangeCheck20", 1))
    memory: Relation = field(default_factory=lambda: Relation("Memory", 6))
    registers: Relation = field(default_factory=lambda: Relation("Registers", 3))
    merkle: Relation = field(default_factory=lambda: Relation("Merkle", 4))
    poseidon2: Relation = field(default_factory=lambda: Relation("Poseidon2", 16))
    bitwise: Relation = field(default_factory=lambda: Relation("Bitwise", 4))

    def draw(self, channel):
        for r in self.all():
            r.draw(channel)

    def all(self):
        return [
            self.range_check_8,
            self.range_check_16,
            self.range_check_20,
            self.memory,
            self.registers,
            self.merkle,
            self.poseidon2,
            self.bitwise,
        ]
