"""run_cairo_program — compile-output in, return values + segments out.

Behavioral port of `crates/runner/src/lib.rs:384-621`:

- frame layout: [materialized arrays][args (M slots)][returns (K slots)]
  [old_fp][ret_pc], with new_fp after the whole frame;
- FixedSizeArray args materialize inline ascending from the old fp and pass a
  pointer (1 slot); u32 = two 16-bit limb slots;
- returns decoded from ``[fp - K - 2 ..]``, following pointers for arrays;
- ``PublicAddressRanges`` = program/input/output address windows for the
  prover's public data.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..isa.abi_codec import AbiCodecError, CairoMValue, InputValue, m31_from_i64
from ..isa.program import AbiType, Program, PublicAddressRanges
from .vm import DEFAULT_MAX_STEPS, VM, VmError

P = (1 << 31) - 1
U16_MAX = 0xFFFF


class RunnerError(Exception):
    pass


@dataclass
class RunnerOptions:
    max_steps: int = DEFAULT_MAX_STEPS


@dataclass
class RunnerOutput:
    return_values: list  # of CairoMValue
    vm: VM
    public_address_ranges: PublicAddressRanges


def _array_materialization_size(ty: AbiType, val: InputValue) -> int:
    """Cells needed below the arg frame for inline array data (recursively)."""
    k = ty.kind
    if k in ("array", "pointer"):
        if val.kind != "list":
            raise AbiCodecError(f"{k} expects a list value")
        elem = ty.element
        inner = sum(_array_materialization_size(elem, v) for v in val.value)
        return inner + len(val.value) * elem.call_slot_size()
    if k == "tuple":
        return sum(_array_materialization_size(t, v) for t, v in zip(ty.members, val.value))
    if k == "struct":
        return sum(
            _array_materialization_size(t, v)
            for (_, t), v in zip(ty.members, val.value)
        )
    return 0


def _encode_value_for_call(vm: VM, cursor: list, ty: AbiType, val: InputValue, dst: list):
    k = ty.kind
    if k == "felt" and val.kind == "number":
        dst.append(m31_from_i64(val.value))
    elif k == "bool" and val.kind in ("number", "bool"):
        n = int(val.value)
        if n not in (0, 1):
            raise AbiCodecError(f"bool expects 0 or 1, got {n}")
        dst.append(n)
    elif k == "u32" and val.kind == "number":
        n = val.value
        if n < 0 or n > 0xFFFFFFFF:
            raise AbiCodecError(f"u32 out of range: {n}")
        dst.append(n & U16_MAX)
        dst.append(n >> 16)
    elif k == "tuple" and val.kind == "list":
        if len(ty.members) != len(val.value):
            raise AbiCodecError("tuple arity mismatch")
        for t, v in zip(ty.members, val.value):
            _encode_value_for_call(vm, cursor, t, v, dst)
    elif k == "struct" and val.kind == "struct":
        if len(ty.members) != len(val.value):
            raise AbiCodecError("struct field count mismatch")
        for (_, t), v in zip(ty.members, val.value):
            _encode_value_for_call(vm, cursor, t, v, dst)
    elif k in ("array", "pointer") and val.kind == "list":
        expected = ty.size if k == "array" else ty.len
        if expected is not None and expected != len(val.value):
            raise AbiCodecError(
                f"{k} size mismatch: expected {expected} got {len(val.value)}"
            )
        elems: list = []
        for v in val.value:
            _encode_value_for_call(vm, cursor, ty.element, v, elems)
        base = cursor[0]
        for i, m in enumerate(elems):
            vm.memory.insert_no_trace((base + i) % P, (m, 0, 0, 0))
        dst.append(base)
        cursor[0] = (base + len(elems)) % P
    elif k == "unit" and val.kind == "unit":
        pass
    else:
        raise AbiCodecError(f"incompatible type/value pair: {ty.kind}/{val.kind}")


def _decode_from_slots(ty: AbiType, slots: list, pos: int, vm: VM):
    k = ty.kind
    if k == "felt":
        return CairoMValue("felt", slots[pos]), pos + 1
    if k == "bool":
        return CairoMValue("bool", slots[pos] != 0), pos + 1
    if k == "u32":
        lo, hi = slots[pos], slots[pos + 1]
        return CairoMValue("u32", (hi << 16) | lo), pos + 2
    if k == "pointer":
        return CairoMValue("pointer", slots[pos]), pos + 1
    if k == "tuple":
        vals = []
        for t in ty.members:
            v, pos = _decode_from_slots(t, slots, pos, vm)
            vals.append(v)
        return CairoMValue("tuple", tuple(vals)), pos
    if k == "struct":
        vals = []
        for n, t in ty.members:
            v, pos = _decode_from_slots(t, slots, pos, vm)
            vals.append((n, v))
        return CairoMValue("struct", tuple(vals)), pos
    if k == "array":
        ptr = slots[pos]
        elem_slots = ty.element.call_slot_size()
        raw = [
            vm.memory.get_data_no_trace((ptr + i) % P)
            for i in range(ty.size * elem_slots)
        ]
        vals = []
        ipos = 0
        for _ in range(ty.size):
            v, ipos = _decode_from_slots(ty.element, raw, ipos, vm)
            vals.append(v)
        return CairoMValue("array", tuple(vals)), pos + 1
    if k == "unit":
        return CairoMValue("unit"), pos
    raise AbiCodecError(k)


def run_cairo_program(
    program: Program,
    entrypoint: str,
    args: list,
    options: RunnerOptions = None,
) -> RunnerOutput:
    options = options or RunnerOptions()
    info = program.entrypoints.get(entrypoint)
    if info is None:
        raise RunnerError(
            f"Entrypoint {entrypoint!r} not found; have {sorted(program.entrypoints)}"
        )
    if len(info.params) != len(args):
        raise RunnerError(
            f"Argument count mismatch: expected {len(info.params)}, got {len(args)}"
        )

    vm = VM(program)

    arg_slots = sum(p.ty.call_slot_size() for p in info.params)
    array_size = sum(
        _array_materialization_size(p.ty, a) for p, a in zip(info.params, args)
    )
    ret_slots = sum(r.ty.call_slot_size() for r in info.returns)
    total_frame_offset = array_size + arg_slots + ret_slots + 2

    cursor = [vm.fp]
    encoded: list = []
    for p, a in zip(info.params, args):
        _encode_value_for_call(vm, cursor, p.ty, a, encoded)

    vm.run_from_entrypoint(
        info.pc, total_frame_offset, encoded, ret_slots, options.max_steps
    )

    raw_frame = [
        vm.memory.get_data_no_trace((vm.fp - (ret_slots + 2 - i)) % P)
        for i in range(ret_slots)
    ]
    pos = 0
    returns = []
    for r in info.returns:
        v, pos = _decode_from_slots(r.ty, raw_frame, pos, vm)
        returns.append(v)
    if pos != len(raw_frame):
        raise AbiCodecError("Unexpected trailing or insufficient return data")

    ranges = PublicAddressRanges.new(vm.program_length, len(encoded), ret_slots)
    return RunnerOutput(returns, vm, ranges)
