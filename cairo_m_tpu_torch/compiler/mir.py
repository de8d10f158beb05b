"""SSA mid-level IR: typed AST -> MIR.

Equivalent of `crates/compiler/mir` (MirModule/MirFunction/BasicBlock,
InstructionKind, Terminator — SURVEY.md §2.3), re-designed compactly:
aggregates (tuples/structs) are flattened multi-slot SSA values with
extract/insert, so SROA falls out of construction; variables are lowered
with direct SSA construction for structured control flow (env snapshots +
phi insertion at joins) instead of alloca+mem2reg.

Memory-shaped constructs (arrays, pointers, heap allocation, assignment
through references) lower to explicit memory instructions — `alloca`
(frame storage), `addr`, `slot_read`/`slot_write` (static-offset frame
access), `load`/`store` (computed addresses -> double-deref opcodes), and
`newarr` (reference-compatible heap bump) — mirroring the reference's
Place/Projection + Load/Store MIR (`crates/compiler/mir/src/lowering/`).
The pass pipeline optimizes the scalar SSA around them; the rare construct
still outside the subset raises `Unsupported` and falls back to the direct
AST code generator (tests assert the full mdtest corpus + sha256 lower
through MIR with no fallback).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ast_nodes as A
from .sem import BOOL, FELT, SemanticError, Type, U32, UNIT

P = (1 << 31) - 1


class Unsupported(Exception):
    """Construct outside the MIR subset -> AST-codegen fallback."""


def _has_array(ty: Type) -> bool:
    """True when the type transitively contains a fixed array — such values
    are memory-resident (alloca place), not SSA aggregates."""
    k = ty.kind
    if k == "array":
        return True
    if k == "tuple":
        return any(_has_array(m) for m in ty.members)
    if k == "struct":
        return any(_has_array(t) for _, t in ty.members)
    return False


# ---------------------------------------------------------------------------
# IR
# ---------------------------------------------------------------------------


@dataclass
class Value:
    """SSA value id + type (slots = flattened width)."""

    id: int
    ty: Type

    def __hash__(self):
        return self.id

    def __eq__(self, other):
        return isinstance(other, Value) and self.id == other.id

    def __repr__(self):
        return f"v{self.id}:{self.ty.kind}"


@dataclass
class Instr:
    kind: str  # const|bin|un|cast|call|make|extract|insert|phi|assert_eq
    dst: Value | None
    op: str = ""
    args: list = field(default_factory=list)  # Values
    extra: object = None  # const value / extract offset / call name / phi map

    def __repr__(self):
        return f"{self.dst} = {self.kind}.{self.op} {self.args} {self.extra if self.extra is not None else ''}"


@dataclass
class Terminator:
    kind: str  # jump|br|br_cmp|ret
    args: list = field(default_factory=list)  # cond values / return values
    targets: list = field(default_factory=list)  # block ids
    op: str = ""  # br_cmp: "eq"|"ne"

    def __repr__(self):
        return f"{self.kind}.{self.op} {self.args} -> {self.targets}"


@dataclass
class Block:
    id: int
    instrs: list = field(default_factory=list)
    term: Terminator | None = None

    @property
    def phis(self):
        return [i for i in self.instrs if i.kind == "phi"]


@dataclass
class MirFunction:
    name: str
    params: list  # (name, Value)
    ret_ty: Type
    blocks: list  # of Block
    n_values: int = 0

    def block(self, bid: int) -> Block:
        return self.blocks[bid]

    def preds(self):
        p = {b.id: [] for b in self.blocks}
        for b in self.blocks:
            if b.term:
                for t in b.term.targets:
                    p[t].append(b.id)
        return p

    def dump(self) -> str:
        out = [f"fn {self.name}({', '.join(n for n, _ in self.params)})"]
        for b in self.blocks:
            out.append(f"  bb{b.id}:")
            for i in b.instrs:
                out.append(f"    {i}")
            out.append(f"    {b.term}")
        return "\n".join(out)


@dataclass
class MirModule:
    functions: dict  # name -> MirFunction


# ---------------------------------------------------------------------------
# AST -> MIR lowering
# ---------------------------------------------------------------------------


class _BreakSignal(Exception):
    pass


class FnLowerer:
    def __init__(self, tm, fdef: A.FunctionDef):
        self.tm = tm
        self.f = fdef
        self.sig = tm.functions[fdef.name]
        self.blocks: list[Block] = []
        self.n_values = 0
        self.cur: Block = self.new_block()
        self.env: dict[str, Value] = {}
        # memory-resident variables (types containing arrays, or array
        # params/returns passed as pointers): name -> ("alloca", Value of
        # the frame storage) | ("ptr", felt Value holding the address)
        self.mem_vars: dict[str, tuple] = {}
        self.loop_stack = []  # (continue_target_fn, break_collector)
        self.terminated = False

    # -- helpers --

    def new_value(self, ty: Type) -> Value:
        v = Value(self.n_values, ty)
        self.n_values += 1
        return v

    def new_block(self) -> Block:
        b = Block(len(self.blocks))
        self.blocks.append(b)
        return b

    def emit(self, kind, ty, op="", args=(), extra=None) -> Value:
        dst = self.new_value(ty) if ty is not None else None
        self.cur.instrs.append(Instr(kind, dst, op, list(args), extra))
        return dst

    def seal(self, term: Terminator):
        assert self.cur.term is None
        self.cur.term = term
        self.terminated = True

    def switch(self, b: Block):
        self.cur = b
        self.terminated = False

    def const(self, ty: Type, v: int) -> Value:
        return self.emit("const", ty, extra=v % (1 << 64))

    # -- entry --

    def lower(self) -> MirFunction:
        params = []
        for name, ty in self.sig.params:
            if ty.kind == "array":
                # ABI: arrays arrive as a 1-slot pointer (codegen.py:7)
                v = self.new_value(FELT)
                self.mem_vars[name] = ("ptr", v, ty)
                params.append((name, v))
                continue
            v = self.new_value(ty)
            if _has_array(ty):
                raise Unsupported("array-in-aggregate param")
            self.env[name] = v
            params.append((name, v))
        self.block_stmts(self.f.body)
        if not self.terminated:
            self.seal(Terminator("ret", args=[]))
        fn = MirFunction(self.f.name, params, self.sig.ret, self.blocks,
                         self.n_values)
        return fn

    # -- statements --

    def block_stmts(self, stmts):
        for st in stmts:
            if self.terminated:
                return  # unreachable tail
            self.stmt(st)

    def stmt(self, st):
        if isinstance(st, A.Let):
            ty = st.value.ty
            if _has_array(ty):
                self._let_memory(st, ty)
            else:
                v = self.expr(st.value)
                self._bind(st.pattern, v, ty)
        elif isinstance(st, A.Assign):
            self._assign(st)
        elif isinstance(st, A.ExprStmt):
            self.expr(st.expr)
        elif isinstance(st, A.Return):
            vals = []
            if st.value is not None:
                if st.value.ty.kind == "array":
                    # return by pointer (codegen.py _return)
                    vals = [self._address_of(st.value)]
                else:
                    vals = [self.expr(st.value)]
            self.seal(Terminator("ret", args=vals))
        elif isinstance(st, A.If):
            self._if(st)
        elif isinstance(st, A.While):
            self._while(st)
        elif isinstance(st, A.For):
            self._for(st)
        elif isinstance(st, A.Loop):
            self._loop(st)
        elif isinstance(st, A.Break):
            _, breaks = self.loop_stack[-1]
            breaks.append((self.cur, dict(self.env)))
            # leave the block unterminated: the loop wires the jump later
            self.seal(Terminator("jump", targets=[-1]))  # patched
        elif isinstance(st, A.Continue):
            cont, _ = self.loop_stack[-1]
            cont.append((self.cur, dict(self.env)))
            self.seal(Terminator("jump", targets=[-1]))  # patched
        else:
            raise Unsupported(f"stmt {type(st).__name__}")

    def _bind(self, pat, v: Value, ty: Type):
        if isinstance(pat, str):
            self.env[pat] = v
            return
        off = 0
        for p, mt in zip(pat, ty.members):
            part = self.emit("extract", mt, args=[v], extra=off)
            self._bind(p, part, mt)
            off += mt.slots()

    # -- memory places --------------------------------------------------
    # Values whose type transitively contains an array are memory-resident:
    # locals get an `alloca` (frame storage, reference `Place` semantics —
    # mir/src/lowering), array params arrive as pointers.  A *place* is
    #   ("ssa", name)                       SSA env variable
    #   ("frame", alloca_value, off, ty)    frame storage + static offset
    #   ("mem", addr_value, off, ty)        computed address + static offset

    def _let_memory(self, st: A.Let, ty: Type):
        if not isinstance(st.pattern, str):
            raise Unsupported("destructuring an array-typed value")
        name = st.pattern
        e = st.value
        if isinstance(e, A.Call):
            # arrays returned from calls arrive as pointers (codegen.py:160)
            v = self._call_expr(e, ret_as_ptr=True)
            self.mem_vars[name] = ("ptr", v, ty)
            return
        if isinstance(e, A.Name) and e.ident in self.mem_vars:
            # alias the same storage (AST-codegen parity: codegen.py:396)
            self.mem_vars[name] = self.mem_vars[e.ident]
            return
        alloca = self.emit("alloca", ty)
        self.mem_vars[name] = ("alloca", alloca, ty)
        self._init_frame(alloca, 0, e)

    def _init_frame(self, alloca: Value, off: int, e: A.Expr):
        """Evaluate an array-containing literal into frame storage."""
        ty = e.ty
        if isinstance(e, (A.ArrayLit, A.TupleLit)):
            members = (
                [ty.element] * ty.size if ty.kind == "array" else ty.members
            )
            cur = off
            for item, mt in zip(e.items, members):
                self._init_frame(alloca, cur, item)
                cur += mt.slots()
            return
        if isinstance(e, A.StructLit):
            given = dict(e.fields)
            cur = off
            for n, ft in ty.members:
                self._init_frame(alloca, cur, given[n])
                cur += ft.slots()
            return
        if _has_array(ty):
            # array-valued sub-expression (e.g. whole-array copy)
            src = self._place(e)
            self._copy_place_to_frame(alloca, off, src, ty)
            return
        v = self.expr(e)
        self.emit("slot_write", None, args=[alloca, v], extra=off)

    def _copy_place_to_frame(self, alloca, off, src_place, ty):
        kind = src_place[0]
        n = ty.slots()
        if kind == "frame":
            _, sa, soff, _ = src_place
            v = self.emit("slot_read", ty, args=[sa], extra=soff)
            self.emit("slot_write", None, args=[alloca, v], extra=off)
        elif kind == "mem":
            _, addr, soff, _ = src_place
            v = self.emit("load", ty, args=[addr], extra=soff)
            self.emit("slot_write", None, args=[alloca, v], extra=off)
        else:
            raise Unsupported("array copy from SSA place")

    def _felt_index(self, e: A.Expr) -> Value:
        """Index expression as a felt value (u32 -> lo + hi * 2^16)."""
        v = self.expr(e)
        if e.ty.kind == "u32":
            lo = self.emit("extract", FELT, args=[v], extra=0)
            hi = self.emit("extract", FELT, args=[v], extra=1)
            c = self.const(FELT, 1 << 16)
            t = self.emit("bin", FELT, op="*", args=[hi, c])
            return self.emit("bin", FELT, op="+", args=[lo, t])
        return v

    def _place(self, e: A.Expr):
        if isinstance(e, A.Name):
            if e.ident in self.mem_vars:
                kind, v, ty = self.mem_vars[e.ident]
                if kind == "alloca":
                    return ("frame", v, 0, ty)
                return ("mem", v, 0, ty)
            if e.ident in self.env:
                return ("ssa", e.ident, 0, e.ty)
            raise Unsupported(f"place name {e.ident}")
        if isinstance(e, A.Member):
            bty = e.base.ty
            if bty.kind == "pointer":
                addr = self.expr(e.base)
                base = ("mem", addr, 0, bty.element)
                bty = bty.element
            else:
                base = self._place(e.base)
            if bty.kind == "tuple":
                idx = int(e.field)
                off = sum(m.slots() for m in bty.members[:idx])
            else:
                off, _ = bty.field_offset(e.field)
            return (base[0], base[1], base[2] + off, e.ty)
        if isinstance(e, A.Index):
            bty = e.base.ty
            esz = e.ty.slots()
            if bty.kind == "pointer":
                base_addr = self.expr(e.base)
            else:
                base_addr = self._address_of(e.base)
            idx = self._felt_index(e.index)
            if esz != 1:
                c = self.const(FELT, esz)
                idx = self.emit("bin", FELT, op="*", args=[idx, c])
            addr = self.emit("bin", FELT, op="+", args=[base_addr, idx])
            return ("mem", addr, 0, e.ty)
        raise Unsupported(f"place expr {type(e).__name__}")

    def _address_of(self, e: A.Expr) -> Value:
        """Felt address of the first slot of e's storage."""
        if e.ty.kind == "pointer":
            return self.expr(e)
        place = self._place(e)
        kind = place[0]
        if kind == "frame":
            return self.emit("addr", FELT, args=[place[1]], extra=place[2])
        if kind == "mem":
            _, addr, off, _ = place
            if off == 0:
                return addr
            c = self.const(FELT, off)
            return self.emit("bin", FELT, op="+", args=[addr, c])
        raise Unsupported("address of SSA value")

    def _load_place(self, place) -> Value:
        kind = place[0]
        ty = place[3]
        if kind == "frame":
            return self.emit("slot_read", ty, args=[place[1]], extra=place[2])
        if kind == "mem":
            return self.emit("load", ty, args=[place[1]], extra=place[2])
        raise AssertionError(kind)

    def _assign(self, st: A.Assign):
        tgt = st.target
        if isinstance(tgt, A.Name) and tgt.ident in self.env:
            self.env[tgt.ident] = self.expr(st.value)
            return
        if (
            isinstance(tgt, A.Name)
            or self._root_is_memory(tgt)
            or self._through_pointer(tgt)
        ):
            place = self._place(tgt)
            val = self.expr(st.value)
            if place[0] == "frame":
                self.emit("slot_write", None, args=[place[1], val], extra=place[2])
            elif place[0] == "mem":
                self.emit("store", None, args=[place[1], val], extra=place[2])
            else:
                raise Unsupported("assign to SSA place")
            return
        val = self.expr(st.value)
        # member assignment on scalar-aggregate vars: functional insert
        path = []
        base = tgt
        while isinstance(base, A.Member):
            path.append(base)
            base = base.base
        if not isinstance(base, A.Name) or base.ident not in self.env:
            raise Unsupported("assign through non-variable place")
        off = 0
        bty = base.ty
        for m in reversed(path):
            if bty.kind == "tuple":
                idx = int(m.field)
                off += sum(t.slots() for t in bty.members[:idx])
                bty = bty.members[idx]
            elif bty.kind == "struct":
                o, ft = bty.field_offset(m.field)
                off += o
                bty = ft
            else:
                raise Unsupported("member of non-aggregate")
        agg = self.env[base.ident]
        self.env[base.ident] = self.emit(
            "insert", agg.ty, args=[agg, val], extra=off
        )

    def _root_is_memory(self, e) -> bool:
        base = e
        while isinstance(base, (A.Member, A.Index)):
            base = base.base
        return isinstance(base, A.Name) and base.ident in self.mem_vars

    def _through_pointer(self, e) -> bool:
        base = e
        while isinstance(base, (A.Member, A.Index)):
            if base.base.ty.kind == "pointer":
                return True
            base = base.base
        return False

    # -- control flow --

    def _merge_envs(self, arms):
        """arms: [(block, env)] of every live predecessor.  Starts a merge
        block with phis for names whose values differ; returns it."""
        merge = self.new_block()
        live = [(b, e) for b, e in arms if b is not None]
        for b, _ in live:
            if b.term is None:
                b.term = Terminator("jump", targets=[merge.id])
            else:  # patched break/continue placeholder
                assert b.term.targets == [-1]
                b.term.targets = [merge.id]
        if not live:
            self.switch(merge)
            self.terminated = True  # unreachable
            self.env = {}
            return merge
        names = set(live[0][1])
        for _, e in live[1:]:
            names &= set(e)
        new_env = {}
        for n in sorted(names):
            vals = [e[n] for _, e in live]
            if all(v == vals[0] for v in vals):
                new_env[n] = vals[0]
            else:
                phi = Instr(
                    "phi", self.new_value(vals[0].ty), "",
                    [e[n] for _, e in live],
                    [b.id for b, _ in live],
                )
                merge.instrs.append(phi)
                new_env[n] = phi.dst
        self.switch(merge)
        self.env = new_env
        return merge

    def _branch(self, cond: A.Expr, then_b: Block, else_b: Block):
        c = self.expr(cond)
        self.seal(Terminator("br", args=[c], targets=[then_b.id, else_b.id]))

    def _if(self, st: A.If):
        entry_env = dict(self.env)
        then_b = self.new_block()
        else_b = self.new_block()
        self._branch(st.cond, then_b, else_b)
        saved_mem = dict(self.mem_vars)
        self.switch(then_b)
        self.env = dict(entry_env)
        self.block_stmts(st.then)
        then_end = (None, None) if self.terminated else (self.cur, dict(self.env))
        self.mem_vars = dict(saved_mem)
        self.switch(else_b)
        self.env = dict(entry_env)
        self.block_stmts(st.orelse)
        else_end = (None, None) if self.terminated else (self.cur, dict(self.env))
        self.mem_vars = saved_mem
        self._merge_envs([then_end, else_end])

    def _loop_header(self, assigned):
        """Start a loop header block with phis for every assigned-in-body
        variable currently in the env.  Returns (header, phi_map)."""
        pre = self.cur
        header = self.new_block()
        if not self.terminated:
            self.seal(Terminator("jump", targets=[header.id]))
        self.switch(header)
        phis = {}
        for n in sorted(assigned & set(self.env)):
            ph = Instr(
                "phi", self.new_value(self.env[n].ty), "",
                [self.env[n]], [pre.id],
            )
            header.instrs.append(ph)
            phis[n] = ph
            self.env[n] = ph.dst
        return header, phis

    def _close_loop(self, header: Block, phis: dict, latches):
        """Add each latch's env values to the header phis."""
        for b, env in latches:
            if b.term is None:
                b.term = Terminator("jump", targets=[header.id])
            else:
                assert b.term.targets == [-1]
                b.term.targets = [header.id]
            for n, ph in phis.items():
                ph.args.append(env[n])
                ph.extra.append(b.id)

    def _exit_block(self, live):
        """Build the loop-exit block from [(pred_block, env)] arms whose
        terminators are already wired (or are break placeholders)."""
        exitb = self.new_block()
        for b, e in live:
            if b.term is not None and b.term.targets == [-1]:
                b.term.targets = [exitb.id]
        new_env = {}
        if live:
            names = set(live[0][1])
            for _, e in live[1:]:
                names &= set(e)
            for n in sorted(names):
                vals = [e[n] for _, e in live]
                if all(v == vals[0] for v in vals):
                    new_env[n] = vals[0]
                else:
                    ph = Instr(
                        "phi", self.new_value(vals[0].ty), "",
                        vals, [b.id for b, _ in live],
                    )
                    exitb.instrs.append(ph)
                    new_env[n] = ph.dst
        self.switch(exitb)
        self.env = new_env
        return exitb

    def _while(self, st: A.While):
        assigned = _assigned_names(st.body)
        header, phis = self._loop_header(assigned)
        header_env = dict(self.env)
        body_b = self.new_block()
        # the cond is evaluated in the header block
        c = self.expr(st.cond)
        cond_end = self.cur  # expr may not create blocks (scalar subset)
        cond_exit_env = dict(self.env)
        exit_placeholder = Terminator("br", args=[c], targets=[body_b.id, -1])
        self.seal(exit_placeholder)
        saved_mem = dict(self.mem_vars)
        self.switch(body_b)
        self.env = dict(header_env)
        breaks = []
        conts = []
        self.loop_stack.append((conts, breaks))
        self.block_stmts(st.body)
        self.loop_stack.pop()
        self.mem_vars = saved_mem
        latches = [] if self.terminated else [(self.cur, dict(self.env))]
        latches += conts
        self._close_loop(header, phis, latches)
        exitb = self._exit_block([(cond_end, cond_exit_env)] + breaks)
        exit_placeholder.targets[1] = exitb.id

    def _for(self, st: A.For):
        saved = dict(self.env)
        self.stmt(st.init)
        assigned = _assigned_names(st.body) | _assigned_names([st.step])
        header, phis = self._loop_header(assigned)
        header_env = dict(self.env)
        c = self.expr(st.cond)
        cond_end = self.cur
        cond_exit_env = dict(self.env)
        body_b = self.new_block()
        exit_placeholder = Terminator("br", args=[c], targets=[body_b.id, -1])
        self.seal(exit_placeholder)
        saved_mem = dict(self.mem_vars)
        self.switch(body_b)
        self.env = dict(header_env)
        breaks = []
        conts = []
        self.loop_stack.append((conts, breaks))
        self.block_stmts(st.body)
        self.loop_stack.pop()
        self.mem_vars = saved_mem
        # step block: fallthrough body end + continues
        step_arms = ([] if self.terminated else [(self.cur, dict(self.env))]) + conts
        self._merge_envs(step_arms or [(None, None)])
        if step_arms:
            self.stmt(st.step)
            latches = [(self.cur, dict(self.env))]
        else:
            latches = []
        self._close_loop(header, phis, latches)
        exitb = self._exit_block([(cond_end, cond_exit_env)] + breaks)
        exit_placeholder.targets[1] = exitb.id
        # loop-scoped init vars drop out of the env
        for n in list(self.env):
            if n not in saved:
                del self.env[n]

    def _loop(self, st: A.Loop):
        assigned = _assigned_names(st.body)
        header, phis = self._loop_header(assigned)
        saved_mem = dict(self.mem_vars)
        breaks = []
        conts = []
        self.loop_stack.append((conts, breaks))
        self.block_stmts(st.body)
        self.loop_stack.pop()
        self.mem_vars = saved_mem
        latches = ([] if self.terminated else [(self.cur, dict(self.env))]) + conts
        self._close_loop(header, phis, latches)
        self._exit_block(list(breaks))  # exit: breaks only
        self.terminated = not breaks  # no break -> unreachable exit

    # -- expressions --

    def expr(self, e: A.Expr) -> Value:
        ty = e.ty
        if isinstance(e, A.IntLit):
            return self.const(ty, e.value)
        if isinstance(e, A.BoolLit):
            return self.const(ty, 1 if e.value else 0)
        if isinstance(e, A.Name):
            if e.ident in self.env:
                return self.env[e.ident]
            if e.ident in self.mem_vars:
                kind, v, _ = self.mem_vars[e.ident]
                if ty.kind == "array":
                    # array used as a value = its pointer (codegen.py:396)
                    return v if kind == "ptr" else self.emit(
                        "addr", FELT, args=[v], extra=0
                    )
                return self._load_place(self._place(e))
            if e.ident in self.tm.consts:
                return self.const(FELT, self.tm.consts[e.ident])
            raise Unsupported(f"name {e.ident}")
        if isinstance(e, A.Unary):
            v = self.expr(e.operand)
            return self.emit("un", ty, op=e.op, args=[v])
        if isinstance(e, A.Binary):
            a = self.expr(e.lhs)
            b = self.expr(e.rhs)
            return self.emit("bin", ty, op=e.op, args=[a, b])
        if isinstance(e, A.Call):
            return self._call_expr(e)
        if isinstance(e, (A.TupleLit, A.ArrayLit)):
            if _has_array(ty):
                raise Unsupported("array literal as SSA value")
            items = [self.expr(it) for it in e.items]
            return self.emit("make", ty, args=items)
        if isinstance(e, A.StructLit):
            if _has_array(ty):
                raise Unsupported("array-holding struct as SSA value")
            given = dict(e.fields)
            items = [self.expr(given[n]) for n, _ in ty.members]
            return self.emit("make", ty, args=items)
        if isinstance(e, A.Member):
            base = e.base
            bty = base.ty
            if bty.kind == "pointer" or self._root_is_memory(e):
                return self._load_place(self._place(e))
            v = self.expr(base)
            if bty.kind == "tuple":
                idx = int(e.field)
                off = sum(m.slots() for m in bty.members[:idx])
            else:
                off, _ = bty.field_offset(e.field)
            return self.emit("extract", ty, args=[v], extra=off)
        if isinstance(e, A.Index):
            return self._load_place(self._place(e))
        if isinstance(e, A.NewArray):
            count = self._felt_index(e.count)
            return self.emit(
                "newarr", ty, args=[count], extra=ty.element.slots()
            )
        if isinstance(e, A.Cast):
            v = self.expr(e.operand)
            return self.emit(
                "cast", ty, op=f"{e.operand.ty.kind}->{ty.kind}", args=[v]
            )
        raise Unsupported(f"expr {type(e).__name__}")

    def _call_expr(self, e: A.Call, ret_as_ptr: bool = False) -> Value:
        sig = self.tm.functions[e.func]
        args = []
        for a, (_, pt) in zip(e.args, sig.params):
            if pt.kind == "array":
                args.append(self._address_of(a))  # arrays pass by pointer
            else:
                args.append(self.expr(a))
        ret_ty = sig.ret
        if ret_ty.kind == "array":
            # pointer return (1 slot)
            return self.emit("call", FELT, args=args, extra=e.func)
        return self.emit("call", ret_ty, args=args, extra=e.func)


def _assigned_names(stmts) -> set:
    """Variable names (re)assigned anywhere in a statement list."""
    out = set()

    def walk_stmt(st):
        if isinstance(st, A.Assign):
            t = st.target
            while isinstance(t, (A.Member, A.Index)):
                t = t.base
            if isinstance(t, A.Name):
                out.add(t.ident)
        elif isinstance(st, A.Let):
            pass  # new binding, scoped
        elif isinstance(st, A.If):
            for s in st.then:
                walk_stmt(s)
            for s in st.orelse:
                walk_stmt(s)
        elif isinstance(st, A.While):
            for s in st.body:
                walk_stmt(s)
        elif isinstance(st, A.For):
            walk_stmt(st.init)
            walk_stmt(st.step)
            for s in st.body:
                walk_stmt(s)
        elif isinstance(st, A.Loop):
            for s in st.body:
                walk_stmt(s)

    for st in stmts:
        walk_stmt(st)
    return out


def lower_module(tm) -> MirModule:
    """Lower every function that fits the MIR subset; raise Unsupported per
    function (caller decides fallback)."""
    fns = {}
    for f in tm.module.functions:
        fns[f.name] = FnLowerer(tm, f).lower()
    return MirModule(fns)


def lower_function(tm, fdef) -> MirFunction:
    return FnLowerer(tm, fdef).lower()
