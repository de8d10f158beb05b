"""The components of one proof in commitment order: the generic components
first, then the opcode components by opcode number (the reference's
``Components``, components/mod.rs)."""

from __future__ import annotations

from ..relations import Relations
from ..scale import SCALE
from .generic import (
    BitwiseComponent,
    ClockUpdateComponent,
    MemoryComponent,
    MerkleComponent,
    Poseidon2Component,
    RangeCheckComponent,
)
from .opcodes import make_opcode_components


class ComponentSet:
    def __init__(self, relations: Relations):
        self.relations = relations
        self.all = [
            MemoryComponent(relations),
            MerkleComponent(relations),
            ClockUpdateComponent(relations),
            Poseidon2Component(relations),
            RangeCheckComponent(relations, 8),
            RangeCheckComponent(relations, 16),
            RangeCheckComponent(relations, SCALE.rc_big_bits, "range_check_20"),
            BitwiseComponent(relations),
        ] + make_opcode_components(relations)

    def preprocessed_columns(self):
        """[(log_size, row-order uint32 column)] and, per component that
        has any, (component, first column, count)."""
        cols, owners = [], []
        for comp in self.all:
            if comp.n_preprocessed_cols:
                pcols = comp.preprocessed_columns()
                owners.append((comp, len(cols), len(pcols)))
                cols += [(comp.log_size, c) for c in pcols]
        return cols, owners
