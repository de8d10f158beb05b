"""CASM code generation: typed AST -> Program.

Reference: crates/compiler/codegen (fp-relative ValueLayout/FunctionLayout,
per-category emitters, two-pass label resolution — SURVEY.md §2.3).

Conventions (exact ABI of the runner, vm/runner.py):
- args at [fp - M - K - 2 + i] (call-slot flattening; arrays by pointer);
- returns at [fp - K - 2 + j]; entry cells [fp-2]=old fp, [fp-1]=ret pc;
- locals/temps grow up from [fp + 0]; call frames above the watermark;
- heap: reference-compatible bump allocator over a HEAP_CURSOR rodata cell:
  base = MAX_ADDRESS - (cursor + cells - 1), cursor += cells
  (codegen/generator.rs:89-186).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..isa.instruction import Instruction, SPECS_BY_NAME
from ..isa.program import (
    AbiSlot,
    AbiType,
    BOOL as ABI_BOOL,
    EntrypointInfo,
    FELT as ABI_FELT,
    Program,
    U32 as ABI_U32,
    array_of,
    pointer_to,
    struct_of,
    tuple_of,
)
from . import ast_nodes as A
from .sem import BOOL, FELT, SemanticError, Type, TypedModule, U32, UNIT

P = (1 << 31) - 1
MAX_ADDRESS = (1 << 28) - 1


def abi_of(t: Type) -> AbiType:
    k = t.kind
    if k == "felt":
        return ABI_FELT
    if k == "bool":
        return ABI_BOOL
    if k == "u32":
        return ABI_U32
    if k == "tuple":
        return tuple_of(*(abi_of(m) for m in t.members))
    if k == "struct":
        return struct_of(t.name, [(n, abi_of(ft)) for n, ft in t.members])
    if k == "array":
        return array_of(abi_of(t.element), t.size)
    if k == "pointer":
        return pointer_to(abi_of(t.element))
    if k == "unit":
        from ..isa.program import UNIT as ABI_UNIT

        return ABI_UNIT
    raise ValueError(k)


@dataclass
class PendingInstr:
    name: str
    fields: dict  # values: int, or ("label", name), or ("rel", label)
    label_here: str = None  # label defined at this instruction


class FnCompiler:
    def __init__(self, modgen: "ModuleCompiler", fdef: A.FunctionDef):
        self.mg = modgen
        self.tm = modgen.tm
        self.f = fdef
        self.sig = self.tm.functions[fdef.name]
        self.code: list[PendingInstr] = []
        self.scopes = [{}]
        self.watermark = 0
        self.label_counter = 0
        self.loop_stack = []  # (continue_label, break_label)
        # arg/return layout
        self.M = sum(t.call_slots() for _, t in self.sig.params)
        self.K = self.sig.ret.call_slots()
        off = -(self.M + self.K + 2)
        for name, ty in self.sig.params:
            storage = "pointer" if ty.kind == "array" else "value"
            self.scopes[0][name] = (off, ty, storage)
            off += ty.call_slots()

    # -- emission helpers --

    def emit(self, name, **fields):
        self.code.append(PendingInstr(name, fields))

    def label(self) -> str:
        self.label_counter += 1
        return f"{self.f.name}__L{self.label_counter}"

    def place_label(self, lab: str):
        self.code.append(PendingInstr("__label__", {}, label_here=lab))

    def alloc(self, n: int) -> int:
        off = self.watermark
        self.watermark += n
        return off

    # -- small codegen utilities --

    def copy_slots(self, src: int, dst: int, n: int):
        for i in range(n):
            self.emit("StoreAddFpImm", src_off=src + i, imm=0, dst_off=dst + i)

    def store_imm(self, value: int, dst: int):
        self.emit("StoreImm", imm=value % P, dst_off=dst)

    # ------------------------------------------------------------------
    # statements
    # ------------------------------------------------------------------

    def compile(self):
        for st in self.f.body:
            self.stmt(st)
        if not self.code or self.code[-1].name != "Ret":
            self.emit("Ret")

    def stmt(self, st):
        mark = self.watermark
        if isinstance(st, A.Let):
            self._let(st)
            return  # keep allocated locals
        if isinstance(st, A.Assign):
            self._assign(st)
        elif isinstance(st, A.ExprStmt):
            self.expr(st.expr)
        elif isinstance(st, A.Return):
            self._return(st)
        elif isinstance(st, A.If):
            self._if(st)
        elif isinstance(st, A.While):
            self._while(st)
        elif isinstance(st, A.For):
            self._for(st)
            return
        elif isinstance(st, A.Loop):
            self._loop(st)
        elif isinstance(st, A.Break):
            self.emit("JmpAbsImm", target=("label", self.loop_stack[-1][1]))
        elif isinstance(st, A.Continue):
            self.emit("JmpAbsImm", target=("label", self.loop_stack[-1][0]))
        else:
            raise SemanticError(st.line, f"codegen: bad stmt {type(st).__name__}")
        self.watermark = max(mark, self._protected_watermark(mark))

    def _protected_watermark(self, mark):
        return mark

    def _let(self, st: A.Let):
        ty = st.value.ty
        src = self.expr(st.value)
        # arrays returned from calls arrive as pointers (1 slot)
        if ty.kind == "array" and isinstance(st.value, A.Call):
            dst = self.alloc(1)
            self.copy_slots(src, dst, 1)
            self._bind(st.pattern, dst, ty, storage="pointer")
            return
        n = ty.slots()
        # fresh storage: let must not alias the source variable's slots
        dst = self.alloc(n)
        self.copy_slots(src, dst, n)
        self._bind(st.pattern, dst, ty)

    def _bind(self, pat, off, ty: Type, storage="value"):
        if isinstance(pat, str):
            self.scopes[-1][pat] = (off, ty, storage)
            return
        # tuple destructuring: members laid out consecutively
        cur = off
        for p, mt in zip(pat, ty.members):
            self._bind(p, cur, mt)
            cur += mt.slots()

    def _assign(self, st: A.Assign):
        mark = self.watermark
        ty = st.target.ty
        n = ty.slots() if ty.kind != "array" else ty.slots()
        src = self.expr(st.value)
        place = self.lvalue(st.target)
        if place[0] == "frame":
            self.copy_slots(src, place[1], n)
        else:
            _, addr_slot, extra, _ = place
            for i in range(n):
                self.emit(
                    "StoreToDoubleDerefFpImm",
                    base_off=addr_slot,
                    imm=extra + i,
                    src_off=src + i,
                )
        self.watermark = mark

    def _return(self, st: A.Return):
        if st.value is not None:
            ty = st.value.ty
            src = self.expr(st.value)
            if ty.kind == "array":
                # return by pointer
                ptr = self.alloc(1)
                self.emit("StoreFramePointer", imm=src, dst_off=ptr)
                self.copy_slots(ptr, -(self.K + 2), 1)
            else:
                self.copy_slots(src, -(self.K + 2), ty.call_slots())
        self.emit("Ret")

    def _cond_jump(self, cond: A.Expr, target: str):
        """Jump to target iff cond != 0."""
        c = self.expr(cond)
        self.emit("JnzFpImm", cond_off=c, offset=("rel", target))

    def _if(self, st: A.If):
        then_lab, end_lab = self.label(), self.label()
        mark = self.watermark
        self._cond_jump(st.cond, then_lab)
        self.watermark = mark
        self._block(st.orelse)
        self.emit("JmpAbsImm", target=("label", end_lab))
        self.place_label(then_lab)
        self._block(st.then)
        self.place_label(end_lab)

    def _while(self, st: A.While):
        top, body, end = self.label(), self.label(), self.label()
        self.place_label(top)
        mark = self.watermark
        self._cond_jump(st.cond, body)
        self.watermark = mark
        self.emit("JmpAbsImm", target=("label", end))
        self.place_label(body)
        self.loop_stack.append((top, end))
        self._block(st.body)
        self.loop_stack.pop()
        self.emit("JmpAbsImm", target=("label", top))
        self.place_label(end)

    def _for(self, st: A.For):
        self.scopes.append({})
        self.stmt(st.init)
        top, body, step_lab, end = (
            self.label(), self.label(), self.label(), self.label(),
        )
        self.place_label(top)
        mark = self.watermark
        self._cond_jump(st.cond, body)
        self.watermark = mark
        self.emit("JmpAbsImm", target=("label", end))
        self.place_label(body)
        self.loop_stack.append((step_lab, end))
        self._block(st.body)
        self.loop_stack.pop()
        self.place_label(step_lab)
        self.stmt(st.step)
        self.emit("JmpAbsImm", target=("label", top))
        self.place_label(end)
        self.scopes.pop()

    def _loop(self, st: A.Loop):
        top, end = self.label(), self.label()
        self.place_label(top)
        self.loop_stack.append((top, end))
        self._block(st.body)
        self.loop_stack.pop()
        self.emit("JmpAbsImm", target=("label", top))
        self.place_label(end)

    def _block(self, stmts):
        self.scopes.append({})
        for s in stmts:
            self.stmt(s)
        self.scopes.pop()

    # ------------------------------------------------------------------
    # lvalues
    # ------------------------------------------------------------------

    def lookup(self, name, line):
        for fr in reversed(self.scopes):
            if name in fr:
                return fr[name]
        if name in self.tm.consts:
            off = self.alloc(1)
            self.store_imm(self.tm.consts[name], off)
            return (off, FELT, "value")
        raise SemanticError(line, f"codegen: unknown variable {name}")

    def lvalue(self, e: A.Expr):
        """-> ("frame", off, ty) or ("mem", addr_slot, extra, ty)."""
        if isinstance(e, A.Name):
            off, ty, storage = self.lookup(e.ident, e.line)
            if storage == "pointer":
                return ("mem", off, 0, ty)
            return ("frame", off, ty)
        if isinstance(e, A.Member):
            base = self.lvalue(e.base)
            bty = e.base.ty
            if bty.kind == "pointer":
                bty = bty.element
                if base[0] == "frame":
                    base = ("mem_ptr_frame", base[1], 0, bty)
            if bty.kind == "tuple":
                idx = int(e.field)
                off = sum(m.slots() for m in bty.members[:idx])
            else:
                off, _ = bty.field_offset(e.field)
            return self._advance_place(base, off, e.ty)
        if isinstance(e, A.Index):
            bty = e.base.ty
            esz = e.ty.slots()
            # dynamic index: address arithmetic
            idx_slot = self.expr_as_felt_index(e.index)
            if esz != 1:
                scaled = self.alloc(1)
                self.emit("StoreMulFpImm", src_off=idx_slot, imm=esz, dst_off=scaled)
                idx_slot = scaled
            base_addr = self.address_of(e.base)
            addr = self.alloc(1)
            self.emit(
                "StoreAddFpFp", src0_off=base_addr, src1_off=idx_slot, dst_off=addr
            )
            return ("mem", addr, 0, e.ty)
        raise SemanticError(e.line, f"codegen: bad lvalue {type(e).__name__}")

    def _advance_place(self, base, off, ty):
        kind = base[0]
        if kind == "frame":
            return ("frame", base[1] + off, ty)
        if kind in ("mem", "mem_ptr_frame"):
            if kind == "mem_ptr_frame":
                # base[1] is a frame slot holding the pointer
                return ("mem", base[1], base[2] + off, ty)
            return ("mem", base[1], base[2] + off, ty)
        raise ValueError(kind)

    def address_of(self, e: A.Expr) -> int:
        """Felt address of the first slot of e's storage (for indexing)."""
        ty = e.ty
        if ty.kind == "pointer":
            v = self.expr(e)
            return v
        place = self.lvalue(e)
        if place[0] == "frame":
            a = self.alloc(1)
            self.emit("StoreFramePointer", imm=place[1], dst_off=a)
            return a
        _, addr_slot, extra, _ = place
        if extra == 0:
            return addr_slot
        a = self.alloc(1)
        self.emit("StoreAddFpImm", src_off=addr_slot, imm=extra, dst_off=a)
        return a

    def expr_as_felt_index(self, e: A.Expr) -> int:
        v = self.expr(e)
        if e.ty.kind == "u32":
            # index arithmetic uses the low limb + hi * 2^16 as felt
            out = self.alloc(1)
            t = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=v + 1, imm=1 << 16, dst_off=t)
            self.emit("StoreAddFpFp", src0_off=v, src1_off=t, dst_off=out)
            return out
        return v

    # ------------------------------------------------------------------
    # expressions -> frame slot offset of first slot
    # ------------------------------------------------------------------

    def expr(self, e: A.Expr) -> int:
        ty = e.ty
        if isinstance(e, A.IntLit):
            if ty.kind == "u32":
                off = self.alloc(2)
                self.emit(
                    "U32StoreImm",
                    imm_lo=e.value & 0xFFFF,
                    imm_hi=(e.value >> 16) & 0xFFFF,
                    dst_off=off,
                )
            else:
                off = self.alloc(1)
                self.store_imm(e.value, off)
            return off
        if isinstance(e, A.BoolLit):
            off = self.alloc(1)
            self.store_imm(1 if e.value else 0, off)
            return off
        if isinstance(e, A.Name):
            off, vty, storage = self.lookup(e.ident, e.line)
            if storage == "pointer" and vty.kind == "array":
                return off  # array param used as value = its pointer
            return off
        if isinstance(e, A.Unary):
            return self._unary(e)
        if isinstance(e, A.Binary):
            return self._binary(e)
        if isinstance(e, A.Call):
            return self._call(e)
        if isinstance(e, (A.TupleLit, A.ArrayLit)):
            items = e.items
            total = ty.slots()
            base = self.alloc(total)
            cur = base
            for it in items:
                mark = self.watermark
                src = self.expr(it)
                n = it.ty.slots()
                self.copy_slots(src, cur, n)
                cur += n
                self.watermark = mark
            return base
        if isinstance(e, A.StructLit):
            st = ty
            base = self.alloc(st.slots())
            given = dict(e.fields)
            cur = base
            for n, ft in st.members:
                mark = self.watermark
                src = self.expr(given[n])
                self.copy_slots(src, cur, ft.slots())
                cur += ft.slots()
                self.watermark = mark
            return base
        if isinstance(e, A.Member):
            place = self.lvalue(e)
            return self._load_place(place, ty)
        if isinstance(e, A.Index):
            place = self.lvalue(e)
            return self._load_place(place, ty)
        if isinstance(e, A.Cast):
            return self._cast(e)
        if isinstance(e, A.NewArray):
            return self._new_array(e)
        raise SemanticError(e.line, f"codegen: bad expr {type(e).__name__}")

    def _load_place(self, place, ty: Type) -> int:
        n = ty.slots()
        if place[0] == "frame":
            return place[1]
        _, addr_slot, extra, _ = place
        out = self.alloc(n)
        for i in range(n):
            self.emit(
                "StoreDoubleDerefFp",
                base_off=addr_slot,
                imm=extra + i,
                dst_off=out + i,
            )
        return out

    def _unary(self, e: A.Unary) -> int:
        v = self.expr(e.operand)
        if e.op == "-":
            if e.ty.kind == "u32":
                # 0 - x
                zero = self.alloc(2)
                self.emit("U32StoreImm", imm_lo=0, imm_hi=0, dst_off=zero)
                out = self.alloc(2)
                self.emit(
                    "U32StoreSubFpFp", src0_off=zero, src1_off=v, dst_off=out
                )
                return out
            out = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=v, imm=P - 1, dst_off=out)
            return out
        # !b = 1 - b  via  b*(P-1) + 1
        t = self.alloc(1)
        self.emit("StoreMulFpImm", src_off=v, imm=P - 1, dst_off=t)
        out = self.alloc(1)
        self.emit("StoreAddFpImm", src_off=t, imm=1, dst_off=out)
        return out

    def _binary(self, e: A.Binary) -> int:
        op = e.op
        lt = e.lhs.ty
        if op in ("&&", "||"):
            a = self.expr(e.lhs)
            b = self.expr(e.rhs)
            if op == "&&":
                out = self.alloc(1)
                self.emit("StoreMulFpFp", src0_off=a, src1_off=b, dst_off=out)
                return out
            t = self.alloc(1)
            self.emit("StoreMulFpFp", src0_off=a, src1_off=b, dst_off=t)
            s = self.alloc(1)
            self.emit("StoreAddFpFp", src0_off=a, src1_off=b, dst_off=s)
            out = self.alloc(1)
            self.emit("StoreSubFpFp", src0_off=s, src1_off=t, dst_off=out)
            return out
        if lt.kind == "u32" or (e.rhs.ty and e.rhs.ty.kind == "u32"):
            return self._binary_u32(e)
        return self._binary_felt(e)

    def _binary_felt(self, e: A.Binary) -> int:
        op = e.op
        rhs_lit = isinstance(e.rhs, A.IntLit) and not e.rhs.is_u32
        a = self.expr(e.lhs)
        if op in ("+", "*") and rhs_lit:
            out = self.alloc(1)
            name = "StoreAddFpImm" if op == "+" else "StoreMulFpImm"
            self.emit(name, src_off=a, imm=e.rhs.value % P, dst_off=out)
            return out
        if op == "-" and rhs_lit:
            out = self.alloc(1)
            self.emit(
                "StoreAddFpImm", src_off=a, imm=(P - e.rhs.value) % P, dst_off=out
            )
            return out
        if op == "/" and rhs_lit:
            inv = pow(e.rhs.value % P, P - 2, P)
            out = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=a, imm=inv, dst_off=out)
            return out
        if op == "<=" and rhs_lit:
            out = self.alloc(1)
            self.emit("StoreLeFpImm", src_off=a, imm=e.rhs.value % P, dst_off=out)
            return out
        b = self.expr(e.rhs)
        if op in ("+", "-", "*", "/"):
            out = self.alloc(1)
            name = {
                "+": "StoreAddFpFp", "-": "StoreSubFpFp",
                "*": "StoreMulFpFp", "/": "StoreDivFpFp",
            }[op]
            self.emit(name, src0_off=a, src1_off=b, dst_off=out)
            return out
        if op in ("==", "!="):
            d = self.alloc(1)
            # compare whole values slotwise (felt/bool: 1 slot)
            self.emit("StoreSubFpFp", src0_off=a, src1_off=b, dst_off=d)
            out = self.alloc(1)
            eq_val, neq_val = (1, 0) if op == "==" else (0, 1)
            set_other, end = self.label(), self.label()
            self.store_imm(eq_val, out)
            self.emit("JnzFpImm", cond_off=d, offset=("rel", set_other))
            self.emit("JmpAbsImm", target=("label", end))
            self.place_label(set_other)
            self.store_imm(neq_val, out)
            self.place_label(end)
            return out
        raise SemanticError(e.line, f"codegen: felt op {op} unsupported here")

    def _binary_u32(self, e: A.Binary) -> int:
        op = e.op
        rhs_lit = isinstance(e.rhs, A.IntLit)
        a = self.expr(e.lhs)

        def imm_pair(v):
            return v & 0xFFFF, (v >> 16) & 0xFFFF

        if op in ("+", "*", "&", "|", "^") and rhs_lit:
            lo, hi = imm_pair(e.rhs.value)
            out = self.alloc(2)
            name = {
                "+": "U32StoreAddFpImm", "*": "U32StoreMulFpImm",
                "&": "U32StoreAndFpImm", "|": "U32StoreOrFpImm",
                "^": "U32StoreXorFpImm",
            }[op]
            self.emit(name, src_off=a, imm_lo=lo, imm_hi=hi, dst_off=out)
            return out
        if op in ("/", "%") and rhs_lit:
            lo, hi = imm_pair(e.rhs.value)
            q = self.alloc(2)
            r = self.alloc(2)
            self.emit(
                "U32StoreDivRemFpImm", src_off=a, imm_lo=lo, imm_hi=hi,
                dst_off=q, dst_rem_off=r,
            )
            return q if op == "/" else r
        if op in ("==", "<") and rhs_lit:
            lo, hi = imm_pair(e.rhs.value)
            out = self.alloc(1)
            name = "U32StoreEqFpImm" if op == "==" else "U32StoreLtFpImm"
            self.emit(name, src_off=a, imm_lo=lo, imm_hi=hi, dst_off=out)
            return out
        b = self.expr(e.rhs)
        if op in ("+", "-", "*", "&", "|", "^"):
            out = self.alloc(2)
            name = {
                "+": "U32StoreAddFpFp", "-": "U32StoreSubFpFp",
                "*": "U32StoreMulFpFp", "&": "U32StoreAndFpFp",
                "|": "U32StoreOrFpFp", "^": "U32StoreXorFpFp",
            }[op]
            self.emit(name, src0_off=a, src1_off=b, dst_off=out)
            return out
        if op in ("/", "%"):
            q = self.alloc(2)
            r = self.alloc(2)
            self.emit(
                "U32StoreDivRemFpFp", src0_off=a, src1_off=b,
                dst_off=q, dst_rem_off=r,
            )
            return q if op == "/" else r
        if op in ("==", "!=", "<", "<=", ">", ">="):
            out = self.alloc(1)
            if op == "==":
                self.emit("U32StoreEqFpFp", src0_off=a, src1_off=b, dst_off=out)
                return out
            if op == "<":
                self.emit("U32StoreLtFpFp", src0_off=a, src1_off=b, dst_off=out)
                return out
            if op == ">":
                self.emit("U32StoreLtFpFp", src0_off=b, src1_off=a, dst_off=out)
                return out
            t = self.alloc(1)
            if op == "!=":
                self.emit("U32StoreEqFpFp", src0_off=a, src1_off=b, dst_off=t)
            elif op == "<=":
                self.emit("U32StoreLtFpFp", src0_off=b, src1_off=a, dst_off=t)
            else:  # >=
                self.emit("U32StoreLtFpFp", src0_off=a, src1_off=b, dst_off=t)
            # out = 1 - t
            t2 = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=t, imm=P - 1, dst_off=t2)
            self.emit("StoreAddFpImm", src_off=t2, imm=1, dst_off=out)
            return out
        raise SemanticError(e.line, f"codegen: u32 op {op} unsupported")

    def _call(self, e: A.Call) -> int:
        sig = self.tm.functions[e.func]
        M = sum(t.call_slots() for _, t in sig.params)
        K = sig.ret.call_slots()
        L = self.watermark
        # evaluate args ABOVE the call frame region to keep [L, L+M) clear
        self.watermark = L + M + K
        arg_srcs = []
        for a, (_, pt) in zip(e.args, sig.params):
            if pt.kind == "array" and a.ty.kind == "array":
                src = self.address_of(a)
                arg_srcs.append((src, 1))
            else:
                src = self.expr(a)
                arg_srcs.append((src, pt.call_slots()))
        cur = L
        for src, n in arg_srcs:
            self.copy_slots(src, cur, n)
            cur += n
        frame_off = L + M + K
        self.emit(
            "CallAbsImm", frame_off=frame_off, target=("label", f"__fn_{e.func}")
        )
        self.watermark = L + M + K
        return L + M  # first return slot

    def _cast(self, e: A.Cast) -> int:
        src_ty = e.operand.ty
        v = self.expr(e.operand)
        if src_ty.kind == "u32" and e.ty.kind == "felt":
            # assert value < P, then felt = lo + hi * 2^16
            lt = self.alloc(1)
            self.emit(
                "U32StoreLtFpImm", src_off=v,
                imm_lo=0xFFFF, imm_hi=0x7FFF, dst_off=lt,
            )
            self.emit("AssertEqFpImm", src_off=lt, imm=1)
            t = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=v + 1, imm=1 << 16, dst_off=t)
            out = self.alloc(1)
            self.emit("StoreAddFpFp", src0_off=v, src1_off=t, dst_off=out)
            return out
        return v  # identity / bool->felt

    def _new_array(self, e: A.NewArray) -> int:
        """Reference-compatible bump allocation (generator.rs:89-186)."""
        elem_slots = e.ty.element.slots()
        hp_addr = self.alloc(1)
        self.emit("StoreImm", imm=("label", "__HEAP_CURSOR__"), dst_off=hp_addr)
        cur = self.alloc(1)
        self.emit("StoreDoubleDerefFp", base_off=hp_addr, imm=0, dst_off=cur)
        # cells = count * elem_slots
        cnt = self.expr_as_felt_index(e.count)
        cells = cnt
        if elem_slots != 1:
            cells = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=cnt, imm=elem_slots, dst_off=cells)
        s0 = self.alloc(1)
        self.emit("StoreAddFpFp", src0_off=cur, src1_off=cells, dst_off=s0)
        # never read+write the same cell in one instruction: the memory
        # argument's rc20 on (clk - prev_clk - 1) forbids same-clock reuse
        s = self.alloc(1)
        self.emit("StoreAddFpImm", src_off=s0, imm=P - 1, dst_off=s)
        mx = self.alloc(1)
        self.store_imm(MAX_ADDRESS, mx)
        base = self.alloc(1)
        self.emit("StoreSubFpFp", src0_off=mx, src1_off=s, dst_off=base)
        ncur = self.alloc(1)
        self.emit("StoreAddFpFp", src0_off=cur, src1_off=cells, dst_off=ncur)
        self.emit(
            "StoreToDoubleDerefFpImm", base_off=hp_addr, imm=0, src_off=ncur
        )
        return base


@dataclass
class _CodeHolder:
    code: list


class ModuleCompiler:
    def __init__(self, tm: TypedModule, mir_codes: dict = None):
        """mir_codes: optional {fn name: PendingInstr list} from the MIR
        pipeline (mir_codegen); functions absent from it compile through
        the direct AST path below."""
        self.tm = tm
        self.mir_codes = mir_codes or {}

    def compile(self) -> Program:
        fns = []
        uses_heap = False
        for f in self.tm.module.functions:
            if f.name in self.mir_codes:
                fc = _CodeHolder(self.mir_codes[f.name])
            else:
                fc = FnCompiler(self, f)
                fc.compile()
            fns.append((f, fc))
            for pi in fc.code:
                v = pi.fields.get("imm")
                if isinstance(v, tuple) and v[0] == "label":
                    uses_heap = True
        all_instrs = []
        for f, fc in fns:
            all_instrs.extend(fc.code)
        # first pass: cell addresses for labels and function entrypoints
        fn_starts = {}
        pos = 0
        for f, fc in fns:
            fn_starts[pos] = f.name
            pos += len(fc.code)
        label_cells = {}
        cell = 0
        for k, pi in enumerate(all_instrs):
            if k in fn_starts:
                label_cells[f"__fn_{fn_starts[k]}"] = cell
            if pi.label_here:
                label_cells[pi.label_here] = cell
                continue
            spec = SPECS_BY_NAME[pi.name]
            pi.fields["__cell__"] = cell
            cell += (spec.size + 3) // 4
        code_len = cell
        heap_cursor_cell = code_len if uses_heap else None
        label_cells["__HEAP_CURSOR__"] = heap_cursor_cell or 0

        # second pass: materialize instructions
        instrs = []
        for pi in all_instrs:
            if pi.label_here:
                continue
            fields = {}
            here = pi.fields["__cell__"]
            for k, v in pi.fields.items():
                if k == "__cell__":
                    continue
                if isinstance(v, tuple) and v[0] == "label":
                    fields[k] = label_cells[v[1]]
                elif isinstance(v, tuple) and v[0] == "rel":
                    fields[k] = (label_cells[v[1]] - here) % P
                else:
                    fields[k] = v % P
            instrs.append(Instruction.make(pi.name, **fields))
        data = list(instrs)
        if uses_heap:
            data.append(("value", (0, 0, 0, 0)))
        eps = {}
        for f, fc in fns:
            sig = self.tm.functions[f.name]
            eps[f.name] = EntrypointInfo(
                pc=label_cells[f"__fn_{f.name}"],
                params=[AbiSlot(n, abi_of(t)) for n, t in sig.params],
                returns=(
                    []
                    if sig.ret.kind == "unit"
                    else [AbiSlot("return", abi_of(sig.ret))]
                ),
            )
        return Program(data, eps, {"compiler_version": "cairo_m_tpu-0.1"})
