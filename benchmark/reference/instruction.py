"""Cairo-M instruction set: 39 opcodes with typed M31 fields.

Port contract: exact opcode numbering, operand order and kinds, per-opcode
sizes, memory-access counts (explicit Memory operands by limb count plus
implicit operands), and instruction→QM31 packing, all matching the reference
`crates/common/src/instruction.rs:314-607` (see SURVEY.md §2.1).

JSON wire format matches the reference serde: an instruction is an array of
lowercase hex strings `["0x<opcode>", "0x<field>", ...]`
(instruction.rs:610-655).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Tuple

P = (1 << 31) - 1


class Op(Enum):
    IMM = "imm"  # immediate: no memory access
    FELT = "felt"  # memory operand, 1 limb
    U32 = "u32"  # memory operand, 2 limbs


_LIMBS = {Op.IMM: 0, Op.FELT: 1, Op.U32: 2}


@dataclass(frozen=True)
class InstrSpec:
    opcode: int
    name: str
    fields: Tuple[Tuple[str, Op], ...]
    implicit: Tuple[Op, ...] = ()

    @property
    def size(self) -> int:
        """Size in M31 words: opcode + explicit fields."""
        return 1 + len(self.fields)

    @property
    def memory_accesses(self) -> int:
        """Operand memory-log entries: explicit Memory limbs + implicit."""
        return sum(_LIMBS[k] for _, k in self.fields) + sum(
            _LIMBS[k] for k in self.implicit
        )


def _spec(opcode, name, fields, implicit=()):
    return InstrSpec(
        opcode,
        name,
        tuple((f, k) for f, k in fields),
        tuple(implicit),
    )


# The full ISA (reference instruction.rs:314-577).
_SPECS = [
    _spec(0, "StoreAddFpFp", [("src0_off", Op.FELT), ("src1_off", Op.FELT), ("dst_off", Op.FELT)]),
    _spec(1, "StoreSubFpFp", [("src0_off", Op.FELT), ("src1_off", Op.FELT), ("dst_off", Op.FELT)]),
    _spec(2, "StoreMulFpFp", [("src0_off", Op.FELT), ("src1_off", Op.FELT), ("dst_off", Op.FELT)]),
    _spec(3, "StoreDivFpFp", [("src0_off", Op.FELT), ("src1_off", Op.FELT), ("dst_off", Op.FELT)]),
    _spec(4, "StoreAddFpImm", [("src_off", Op.FELT), ("imm", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(6, "StoreMulFpImm", [("src_off", Op.FELT), ("imm", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(48, "StoreLeFpImm", [("src_off", Op.FELT), ("imm", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(50, "AssertEqFpImm", [("src_off", Op.FELT), ("imm", Op.IMM)]),
    _spec(8, "StoreDoubleDerefFp", [("base_off", Op.FELT), ("imm", Op.IMM), ("dst_off", Op.FELT)], [Op.FELT]),
    _spec(42, "StoreDoubleDerefFpFp", [("base_off", Op.FELT), ("offset_off", Op.FELT), ("dst_off", Op.FELT)], [Op.FELT]),
    _spec(9, "StoreImm", [("imm", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(43, "StoreFramePointer", [("imm", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(10, "CallAbsImm", [("frame_off", Op.IMM), ("target", Op.IMM)], [Op.FELT, Op.FELT]),
    _spec(11, "Ret", [], [Op.FELT, Op.FELT]),
    _spec(12, "JmpAbsImm", [("target", Op.IMM)]),
    _spec(13, "JmpRelImm", [("offset", Op.IMM)]),
    _spec(14, "JnzFpImm", [("cond_off", Op.FELT), ("offset", Op.IMM)]),
    _spec(15, "U32StoreAddFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32)]),
    _spec(16, "U32StoreSubFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32)]),
    _spec(17, "U32StoreMulFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32)]),
    _spec(18, "U32StoreDivRemFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32), ("dst_rem_off", Op.U32)]),
    _spec(19, "U32StoreAddFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32)]),
    _spec(21, "U32StoreMulFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32)]),
    _spec(22, "U32StoreDivRemFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32), ("dst_rem_off", Op.U32)]),
    _spec(23, "U32StoreImm", [("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32)]),
    _spec(24, "U32StoreEqFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.FELT)]),
    _spec(28, "U32StoreLtFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.FELT)]),
    _spec(30, "U32StoreEqFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(34, "U32StoreLtFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.FELT)]),
    _spec(36, "U32StoreAndFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32)]),
    _spec(37, "U32StoreOrFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32)]),
    _spec(38, "U32StoreXorFpFp", [("src0_off", Op.U32), ("src1_off", Op.U32), ("dst_off", Op.U32)]),
    _spec(39, "U32StoreAndFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32)]),
    _spec(40, "U32StoreOrFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32)]),
    _spec(41, "U32StoreXorFpImm", [("src_off", Op.U32), ("imm_lo", Op.IMM), ("imm_hi", Op.IMM), ("dst_off", Op.U32)]),
    _spec(44, "StoreToDoubleDerefFpImm", [("base_off", Op.FELT), ("imm", Op.IMM), ("src_off", Op.FELT)], [Op.FELT]),
    _spec(45, "StoreToDoubleDerefFpFp", [("base_off", Op.FELT), ("offset_off", Op.FELT), ("src_off", Op.FELT)], [Op.FELT]),
    _spec(46, "PrintM31", [("offset", Op.FELT)]),
    _spec(47, "PrintU32", [("offset", Op.U32)]),
]

SPECS_BY_OPCODE = {s.opcode: s for s in _SPECS}
SPECS_BY_NAME = {s.name: s for s in _SPECS}
OPCODE_SIZE_TABLE = {op: s.size for op, s in SPECS_BY_OPCODE.items()}
INSTRUCTION_MAX_SIZE = max(s.size for s in _SPECS)  # 6 (U32StoreDivRemFpImm)

# Opcode constants, UPPER_SNAKE names as in the reference macro expansion.
import re as _re


def _snake_upper(name: str) -> str:
    return _re.sub(r"(?<=[a-z0-9])(?=[A-Z])|(?<=[A-Z])(?=[A-Z][a-z])", "_", name).upper()


globals().update({_snake_upper(s.name): s.opcode for s in _SPECS})


@dataclass(frozen=True)
class Instruction:
    """A decoded instruction: opcode plus explicit field values (M31 ints)."""

    opcode: int
    operands: Tuple[int, ...]

    @property
    def spec(self) -> InstrSpec:
        return SPECS_BY_OPCODE[self.opcode]

    @property
    def name(self) -> str:
        return self.spec.name

    def __getattr__(self, item):
        spec = SPECS_BY_OPCODE[object.__getattribute__(self, "opcode")]
        for (fname, _), v in zip(spec.fields, object.__getattribute__(self, "operands")):
            if fname == item:
                return v
        raise AttributeError(item)

    @staticmethod
    def make(name: str, **kwargs) -> "Instruction":
        spec = SPECS_BY_NAME[name]
        vals = []
        for fname, _ in spec.fields:
            if fname not in kwargs:
                raise ValueError(f"{name}: missing field {fname}")
            vals.append(int(kwargs[fname]) % P)
        extra = set(kwargs) - {f for f, _ in spec.fields}
        if extra:
            raise ValueError(f"{name}: unknown fields {extra}")
        return Instruction(spec.opcode, tuple(vals))

    @property
    def size(self) -> int:
        return self.spec.size

    @property
    def memory_accesses(self) -> int:
        return self.spec.memory_accesses

    def to_m31_list(self) -> list[int]:
        return [self.opcode, *self.operands]

    def to_qm31_vec(self) -> list[tuple[int, int, int, int]]:
        """Pack into QM31 words (chunks of 4, zero-padded) — instruction.rs:592-607."""
        words = self.to_m31_list()
        out = []
        for i in range(0, len(words), 4):
            chunk = words[i : i + 4]
            out.append(tuple(chunk + [0] * (4 - len(chunk))))
        return out

    @staticmethod
    def from_m31_list(words) -> "Instruction":
        if not words:
            raise ValueError("Instruction cannot be empty")
        opcode = int(words[0])
        spec = SPECS_BY_OPCODE.get(opcode)
        if spec is None:
            raise ValueError(f"Invalid opcode: {opcode}")
        if len(words) != spec.size:
            raise ValueError(
                f"Size mismatch for {spec.name}: expected {spec.size}, found {len(words)}"
            )
        return Instruction(opcode, tuple(int(w) % P for w in words[1:]))

    # --- JSON wire format (array of hex strings) ---

    def to_json_obj(self) -> list[str]:
        return [f"0x{v:x}" for v in self.to_m31_list()]

    @staticmethod
    def from_json_obj(obj) -> "Instruction":
        words = [int(s, 16) for s in obj]
        return Instruction.from_m31_list(words)


def assemble(instrs) -> list[tuple[int, int, int, int]]:
    """Pack a list of Instructions into the QM31 program image (addr 0..)."""
    out = []
    for ins in instrs:
        out.extend(ins.to_qm31_vec())
    return out
