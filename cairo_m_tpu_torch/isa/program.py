"""Program / ABI metadata layer (reference `crates/common/src/program.rs`).

JSON wire format mirrors the reference serde encoding so compiled programs
are interchangeable:

- unit enum variants as strings (``"Felt"``), data variants externally tagged
  (``{"Pointer": {"element": ..., "len": ...}}``),
- instructions as arrays of hex strings,
- rodata values as QM31 ``[[a, b], [c, d]]``.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from .instruction import Instruction

# ---------------------------------------------------------------------------
# AbiType
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AbiType:
    """Cairo-M ABI type.  kind in {felt,bool,u32,pointer,tuple,struct,array,unit}."""

    kind: str
    element: Optional["AbiType"] = None  # pointer/array
    len: Optional[int] = None  # pointer
    size: Optional[int] = None  # array
    members: tuple = ()  # tuple: (AbiType,...); struct: ((name, AbiType),...)
    name: str = ""  # struct name

    # -- slot accounting (program.rs:34-66) --

    def size_in_slots(self) -> int:
        k = self.kind
        if k in ("felt", "bool", "pointer"):
            return 1
        if k == "u32":
            return 2
        if k == "tuple":
            return sum(t.size_in_slots() for t in self.members)
        if k == "struct":
            return sum(t.size_in_slots() for _, t in self.members)
        if k == "array":
            return self.size * self.element.size_in_slots()
        if k == "unit":
            return 0
        raise ValueError(k)

    def call_slot_size(self) -> int:
        k = self.kind
        if k in ("felt", "bool", "pointer", "array"):
            return 1 if k != "u32" else 2  # array passed by pointer
        if k == "u32":
            return 2
        if k == "tuple":
            return sum(t.call_slot_size() for t in self.members)
        if k == "struct":
            return sum(t.call_slot_size() for _, t in self.members)
        if k == "unit":
            return 0
        raise ValueError(k)

    # -- serde-compatible JSON --

    def to_json_obj(self):
        k = self.kind
        if k == "felt":
            return "Felt"
        if k == "bool":
            return "Bool"
        if k == "u32":
            return "U32"
        if k == "unit":
            return "Unit"
        if k == "pointer":
            return {"Pointer": {"element": self.element.to_json_obj(), "len": self.len}}
        if k == "tuple":
            return {"Tuple": [t.to_json_obj() for t in self.members]}
        if k == "struct":
            return {
                "Struct": {
                    "name": self.name,
                    "fields": [[n, t.to_json_obj()] for n, t in self.members],
                }
            }
        if k == "array":
            return {
                "FixedSizeArray": {
                    "element": self.element.to_json_obj(),
                    "size": self.size,
                }
            }
        raise ValueError(k)

    @staticmethod
    def from_json_obj(obj) -> "AbiType":
        if isinstance(obj, str):
            return {
                "Felt": FELT,
                "Bool": BOOL,
                "U32": U32,
                "Unit": UNIT,
            }[obj]
        (tag, body), = obj.items()
        if tag == "Pointer":
            return AbiType(
                "pointer",
                element=AbiType.from_json_obj(body["element"]),
                len=body.get("len"),
            )
        if tag == "Tuple":
            return AbiType("tuple", members=tuple(AbiType.from_json_obj(t) for t in body))
        if tag == "Struct":
            return AbiType(
                "struct",
                name=body["name"],
                members=tuple((n, AbiType.from_json_obj(t)) for n, t in body["fields"]),
            )
        if tag == "FixedSizeArray":
            return AbiType(
                "array",
                element=AbiType.from_json_obj(body["element"]),
                size=body["size"],
            )
        raise ValueError(tag)


FELT = AbiType("felt")
BOOL = AbiType("bool")
U32 = AbiType("u32")
UNIT = AbiType("unit")


def tuple_of(*ts):
    return AbiType("tuple", members=tuple(ts))


def struct_of(name, fields):
    return AbiType("struct", name=name, members=tuple(fields))


def array_of(element, size):
    return AbiType("array", element=element, size=size)


def pointer_to(element, length=None):
    return AbiType("pointer", element=element, len=length)


# ---------------------------------------------------------------------------
# Entrypoints / Program
# ---------------------------------------------------------------------------


@dataclass
class AbiSlot:
    name: str
    ty: AbiType

    def to_json_obj(self):
        return {"name": self.name, "ty": self.ty.to_json_obj()}

    @staticmethod
    def from_json_obj(obj):
        return AbiSlot(obj["name"], AbiType.from_json_obj(obj["ty"]))


@dataclass
class EntrypointInfo:
    pc: int  # memory address (QM31 cell index) of the function's first word
    params: list = field(default_factory=list)
    returns: list = field(default_factory=list)

    def to_json_obj(self):
        out = {"pc": self.pc}
        if self.params:
            out["params"] = [p.to_json_obj() for p in self.params]
        if self.returns:
            out["returns"] = [r.to_json_obj() for r in self.returns]
        return out

    @staticmethod
    def from_json_obj(obj):
        return EntrypointInfo(
            obj["pc"],
            [AbiSlot.from_json_obj(p) for p in obj.get("params", [])],
            [AbiSlot.from_json_obj(r) for r in obj.get("returns", [])],
        )


@dataclass(frozen=True)
class PublicAddressRanges:
    """program=[0,len), input=[len,len+M), output=[len+M,len+M+K)
    (program.rs:101-123)."""

    program: range = range(0)
    input: range = range(0)
    output: range = range(0)

    @staticmethod
    def new(program_length: int, num_args: int, num_returns: int):
        pe = program_length
        ie = pe + num_args
        oe = ie + num_returns
        return PublicAddressRanges(range(0, pe), range(pe, ie), range(ie, oe))


@dataclass
class Program:
    """Compiled program: linear data (instructions + rodata) + entrypoints."""

    data: list  # of Instruction or ("value", (a,b,c,d))
    entrypoints: dict  # name -> EntrypointInfo
    metadata: dict = field(default_factory=dict)

    def qm31_words(self) -> list[tuple[int, int, int, int]]:
        """Flatten into the QM31 memory image loaded at address 0."""
        out = []
        for item in self.data:
            if isinstance(item, Instruction):
                out.extend(item.to_qm31_vec())
            else:
                out.append(tuple(item[1]))
        return out

    def get_entrypoint(self, name: str) -> EntrypointInfo:
        return self.entrypoints[name]

    # -- JSON --

    def to_json(self) -> str:
        def data_obj(item):
            if isinstance(item, Instruction):
                return {"Instruction": item.to_json_obj()}
            a, b, c, d = item[1]
            return {"Value": [[a, b], [c, d]]}

        return json.dumps(
            {
                "data": [data_obj(i) for i in self.data],
                "entrypoints": {
                    k: v.to_json_obj() for k, v in self.entrypoints.items()
                },
                "metadata": self.metadata,
            }
        )

    @staticmethod
    def from_json(s: str) -> "Program":
        obj = json.loads(s)
        data = []
        for item in obj["data"]:
            (tag, body), = item.items()
            if tag == "Instruction":
                data.append(Instruction.from_json_obj(body))
            else:
                (a, b), (c, d) = body
                data.append(("value", (a, b, c, d)))
        eps = {
            k: EntrypointInfo.from_json_obj(v) for k, v in obj["entrypoints"].items()
        }
        return Program(data, eps, obj.get("metadata", {}))

    @staticmethod
    def from_instructions(instrs) -> "Program":
        return Program(list(instrs), {}, {})
