"""WASM (i32 subset) -> Cairo-M SSA MIR -> CASM.

The stack machine lowers by symbolic evaluation: the operand stack holds
SSA `Value`s while decoding, so pushes/pops vanish at compile time (the
womir BlocklessDAG plays this role in the reference `crates/wasm`).
Structured control flow maps onto the compiler's MIR blocks:

- `block` / `if`: a merge block; every `br` to it records a (pred, locals,
  results) arm, merged with phis (the pass pipeline collapses degenerate
  ones);
- `loop`: a header block with one phi per local, back-edges from `br`;
- wasm i32 == the native u32 type (wrapping 32-bit); comparison results
  widen bool -> u32 (i32 0/1) unless they directly feed a branch, where
  the bool is branched on directly.

Dead code after an unconditional `br`/`return` is skipped with nesting
tracked, per the wasm validation rules.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..compiler.mir import Block, Instr, MirFunction, Terminator, Value
from ..compiler.mir_passes import run_pipeline
from ..compiler.sem import BOOL, FELT, FuncSig, Type, U32, UNIT
from . import WasmError, WasmModule

_MAX_ADDRESS = (1 << 28) - 1


def mem_cells(mod: WasmModule) -> int:
    """Heap cells reserved for wasm linear memory: one u32 word = two
    16-bit-limb cells (64 KiB page = 16384 words = 32768 cells)."""
    return mod.mem_min_pages * (65536 // 4) * 2


def membase_cell(mod: WasmModule) -> int:
    """First cell of wasm memory — the top `mem_cells` cells of the heap
    segment (which grows down from MAX_ADDRESS; the wasm frontend emits no
    `newarr`, so nothing else allocates there)."""
    return _MAX_ADDRESS - mem_cells(mod) + 1

_BIN = {
    0x6A: "+", 0x6B: "-", 0x6C: "*", 0x6E: "/", 0x70: "%",
    0x71: "&", 0x72: "|", 0x73: "^",
}
_CMP = {
    0x46: "==", 0x47: "!=", 0x49: "<", 0x4B: ">", 0x4D: "<=", 0x4F: ">=",
}


@dataclass
class _Ctl:
    kind: str  # block | loop | if
    arity: int
    end_block: Block
    arms: list  # (pred Block, locals list, results list)
    entry_stack: list = None  # operand stack below the construct
    header: Block = None  # loop
    phis: list = None  # loop: one per local
    else_block: Block = None  # if
    else_seen: bool = False
    saved_if: tuple = None  # (locals, stack) at `if` entry for the else arm


class FnLowerer:
    def __init__(self, mod: WasmModule, fidx: int, names: list):
        self.mod = mod
        self.fidx = fidx
        self.names = names
        self.f = mod.funcs[fidx]
        self.ty = mod.types[self.f.type_idx]
        self.blocks: list[Block] = []
        self.n_values = 0
        self.cur = self.new_block()
        self.terminated = False
        self.locals: list[Value] = []
        self.stack: list[Value] = []
        self.ctl: list[_Ctl] = []

    # -- helpers (mirror compiler.mir.FnLowerer) --

    def new_value(self, ty) -> Value:
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

    def const_u32(self, v: int) -> Value:
        return self.emit("const", U32, extra=v & 0xFFFFFFFF)

    def seal(self, term):
        assert self.cur.term is None
        self.cur.term = term
        self.terminated = True

    def switch(self, b):
        self.cur = b
        self.terminated = False

    def _widen(self, v: Value) -> Value:
        if v.ty is BOOL or v.ty.kind == "bool":
            return self.emit("cast", U32, op="bool->u32", args=[v])
        return v

    def _cond_bool(self, v: Value) -> Value:
        """Branch condition: use the underlying bool when v is a widened
        comparison, else test v != 0 (both limbs)."""
        d = self._def_of(v)
        if d is not None and d.kind == "cast" and d.op == "bool->u32":
            return d.args[0]
        zero = self.const_u32(0)
        return self.emit("bin", BOOL, op="!=", args=[v, zero])

    def _def_of(self, v):
        for b in self.blocks:
            for i in b.instrs:
                if i.dst is not None and i.dst.id == v.id:
                    return i
        return None

    # -- merges --

    def _merge(self, end_block: Block, arms, arity: int, entry_stack):
        """Wire arms (pred, locals, results) into end_block with phis."""
        live = [(b, lo, res) for b, lo, res in arms if b is not None]
        for b, _, _ in live:
            if b.term is None:
                b.term = Terminator("jump", targets=[end_block.id])
            elif b.term.targets == [-1]:
                b.term.targets = [end_block.id]
        if not live:
            self.switch(end_block)
            self.terminated = True
            return
        n_loc = len(live[0][1])
        new_locals = []
        for li in range(n_loc):
            vals = [lo[li] for _, lo, _ in live]
            if all(v == vals[0] for v in vals):
                new_locals.append(vals[0])
            else:
                ph = Instr(
                    "phi", self.new_value(vals[0].ty), "",
                    vals, [b.id for b, _, _ in live],
                )
                end_block.instrs.append(ph)
                new_locals.append(ph.dst)
        results = []
        for ri in range(arity):
            vals = [res[ri] for _, _, res in live]
            if all(v == vals[0] for v in vals):
                results.append(vals[0])
            else:
                ph = Instr(
                    "phi", self.new_value(vals[0].ty), "",
                    vals, [b.id for b, _, _ in live],
                )
                end_block.instrs.append(ph)
                results.append(ph.dst)
        self.switch(end_block)
        self.locals = new_locals
        self.stack = list(entry_stack) + results

    # -- main decode loop --

    def lower(self) -> MirFunction:
        from . import _Reader

        params = []
        for k, _ in enumerate(self.ty.params):
            v = self.new_value(U32)
            self.locals.append(v)
            params.append((f"p{k}", v))
        for _ in self.f.locals:
            self.locals.append(self.const_u32(0))
        arity = len(self.ty.results)

        r = _Reader(self.f.body)
        while True:
            op = r.u8()
            if self.terminated and op not in (
                0x02, 0x03, 0x04, 0x05, 0x0B,
            ):
                _skip_immediates(r, op)
                continue
            if op == 0x0B:  # end
                if not self.ctl:
                    break  # function end
                self._end()
                continue
            if op == 0x02 or op == 0x03:  # block / loop
                bt = r.sleb()
                a = 0 if bt == -64 else 1  # 0x40 empty / valtype
                if self.terminated:
                    # dead nested structure: track nesting only
                    self.ctl.append(
                        _Ctl("dead", a, None, [])
                    )
                    continue
                if op == 0x02:
                    self.ctl.append(
                        _Ctl(
                            "block", a, self.new_block(), [],
                            entry_stack=list(self.stack),
                        )
                    )
                else:
                    header = self.new_block()
                    self.seal(Terminator("jump", targets=[header.id]))
                    pre = self.blocks[self.cur.id]
                    self.switch(header)
                    phis = []
                    new_locals = []
                    for lv in self.locals:
                        ph = Instr(
                            "phi", self.new_value(lv.ty), "",
                            [lv], [pre.id],
                        )
                        header.instrs.append(ph)
                        phis.append(ph)
                        new_locals.append(ph.dst)
                    self.locals = new_locals
                    self.ctl.append(
                        _Ctl(
                            "loop", a, self.new_block(), [],
                            entry_stack=list(self.stack),
                            header=header, phis=phis,
                        )
                    )
                continue
            if op == 0x04:  # if
                bt = r.sleb()
                a = 0 if bt == -64 else 1
                if self.terminated:
                    self.ctl.append(_Ctl("dead", a, None, []))
                    continue
                cond = self._cond_bool(self.stack.pop())
                then_b = self.new_block()
                else_b = self.new_block()
                self.seal(
                    Terminator(
                        "br", args=[cond], targets=[then_b.id, else_b.id]
                    )
                )
                c = _Ctl(
                    "if", a, self.new_block(), [],
                    entry_stack=list(self.stack), else_block=else_b,
                    saved_if=(list(self.locals), list(self.stack)),
                )
                self.ctl.append(c)
                self.switch(then_b)
                continue
            if op == 0x05:  # else
                c = self.ctl[-1]
                if c.kind == "dead":
                    continue
                if not self.terminated:
                    c.arms.append(
                        (
                            self.cur,
                            list(self.locals),
                            self.stack[len(self.stack) - c.arity :],
                        )
                    )
                    self.seal(Terminator("jump", targets=[-1]))
                c.else_seen = True
                self.locals, self.stack = (
                    list(c.saved_if[0]), list(c.saved_if[1]),
                )
                self.switch(c.else_block)
                continue
            self._op(op, r)
        # function end: implicit return of stack top
        if not self.terminated:
            vals = [self._widen(self.stack[-1])] if arity else []
            self.seal(Terminator("ret", args=vals))
        ret = U32 if arity else UNIT
        return MirFunction(
            self.names[self.fidx], params, ret, self.blocks, self.n_values
        )

    def _end(self):
        c = self.ctl.pop()
        if c.kind == "dead":
            return
        if c.kind == "if" and not c.else_seen:
            # empty else arm falls through with entry state
            c.arms.append((c.else_block, list(c.saved_if[0]), []))
            c.else_block.term = None  # will be wired by _merge
            if c.arity:
                raise WasmError("if with result requires else")
        if not self.terminated:
            res = self.stack[len(self.stack) - c.arity :] if c.arity else []
            c.arms.append((self.cur, list(self.locals), res))
            self.seal(Terminator("jump", targets=[-1]))
        if c.kind == "loop":
            pass  # loop exits only via br to an enclosing label or fallthrough
        self._merge(c.end_block, c.arms, c.arity, c.entry_stack)

    def _br(self, depth: int, conditional_cond=None):
        c = self.ctl[-1 - depth]
        if conditional_cond is not None:
            taken = self.new_block()
            not_taken = self.new_block()
            self.seal(
                Terminator(
                    "br", args=[conditional_cond],
                    targets=[taken.id, not_taken.id],
                )
            )
            self.switch(taken)
            self._br_edge(c)
            self.switch(not_taken)
            return
        self._br_edge(c)

    def _br_edge(self, c: _Ctl):
        if c.kind == "loop":
            # continue: back-edge to header with current locals
            for ph, lv in zip(c.phis, self.locals):
                ph.args.append(lv)
                ph.extra.append(self.cur.id)
            self.seal(Terminator("jump", targets=[c.header.id]))
        else:
            res = self.stack[len(self.stack) - c.arity :] if c.arity else []
            c.arms.append((self.cur, list(self.locals), res))
            self.seal(Terminator("jump", targets=[-1]))

    def _op(self, op: int, r):
        if op == 0x00:  # unreachable
            self.seal(Terminator("ret", args=[]))
            return
        if op == 0x01:  # nop
            return
        if op == 0x0C:  # br
            self._br(r.uleb())
            return
        if op == 0x0D:  # br_if
            depth = r.uleb()
            cond = self._cond_bool(self.stack.pop())
            self._br(depth, conditional_cond=cond)
            return
        if op == 0x0F:  # return
            vals = [self._widen(self.stack[-1])] if self.ty.results else []
            self.seal(Terminator("ret", args=vals))
            return
        if op == 0x10:  # call
            idx = r.uleb()
            callee_ty = self.mod.types[self.mod.funcs[idx].type_idx]
            n = len(callee_ty.params)
            args = self.stack[len(self.stack) - n :]
            del self.stack[len(self.stack) - n :]
            ret = U32 if callee_ty.results else UNIT
            out = self.emit(
                "call", ret, args=[self._widen(a) for a in args],
                extra=self.names[idx],
            )
            if callee_ty.results:
                self.stack.append(out)
            return
        if op == 0x1A:  # drop
            self.stack.pop()
            return
        if op == 0x1B:  # select
            c = self._cond_bool(self.stack.pop())
            b = self._widen(self.stack.pop())
            a = self._widen(self.stack.pop())
            then_b = self.new_block()
            else_b = self.new_block()
            self.seal(Terminator("br", args=[c], targets=[then_b.id, else_b.id]))
            merge = self.new_block()
            then_b.term = Terminator("jump", targets=[merge.id])
            else_b.term = Terminator("jump", targets=[merge.id])
            ph = Instr(
                "phi", self.new_value(U32), "", [a, b],
                [then_b.id, else_b.id],
            )
            merge.instrs.append(ph)
            self.switch(merge)
            self.stack.append(ph.dst)
            return
        if op == 0x20:  # local.get
            self.stack.append(self.locals[r.uleb()])
            return
        if op == 0x21:  # local.set
            self.locals[r.uleb()] = self._widen(self.stack.pop())
            return
        if op == 0x22:  # local.tee
            i = r.uleb()
            self.locals[i] = self._widen(self.stack[-1])
            self.stack[-1] = self.locals[i]
            return
        if op == 0x41:  # i32.const
            self.stack.append(self.const_u32(r.sleb()))
            return
        if op == 0x45:  # i32.eqz
            a = self._widen(self.stack.pop())
            zero = self.const_u32(0)
            b = self.emit("bin", BOOL, op="==", args=[a, zero])
            self.stack.append(
                self.emit("cast", U32, op="bool->u32", args=[b])
            )
            return
        if op in _CMP:
            b = self._widen(self.stack.pop())
            a = self._widen(self.stack.pop())
            v = self.emit("bin", BOOL, op=_CMP[op], args=[a, b])
            self.stack.append(
                self.emit("cast", U32, op="bool->u32", args=[v])
            )
            return
        if op in _BIN:
            b = self._widen(self.stack.pop())
            a = self._widen(self.stack.pop())
            self.stack.append(self.emit("bin", U32, op=_BIN[op], args=[a, b]))
            return
        if op in (0x28, 0x36):  # i32.load / i32.store (4-byte aligned)
            r.uleb()  # align hint (ignored; accesses must be 4-aligned)
            offset = r.uleb()
            if self.mod.mem_min_pages <= 0:
                raise WasmError("memory access but no memory section")
            val = self._widen(self.stack.pop()) if op == 0x36 else None
            cell = self._mem_cell(self._widen(self.stack.pop()), offset)
            base = membase_cell(self.mod)
            if op == 0x28:
                self.stack.append(
                    self.emit("load", U32, args=[cell], extra=base)
                )
            else:
                self.emit("store", None, args=[cell, val], extra=base)
            return
        raise WasmError(f"unsupported opcode 0x{op:02x}")

    def _mem_cell(self, addr: Value, offset: int) -> Value:
        """u32 byte address (+ static offset) -> felt cell offset 2*(a/4)
        relative to membase.  Unaligned low bits truncate (the supported
        subset requires 4-byte-aligned i32 accesses)."""
        if offset:
            addr = self.emit(
                "bin", U32, op="+", args=[addr, self.const_u32(offset)]
            )
        word = self.emit("bin", U32, op="/", args=[addr, self.const_u32(4)])
        idx = self.emit("cast", FELT, op="u32->felt", args=[word])
        two = self.emit("const", FELT, extra=2)
        return self.emit("bin", FELT, op="*", args=[idx, two])


def _skip_immediates(r, op: int):
    """Advance past a dead instruction's immediates."""
    if op in (0x0C, 0x0D, 0x10, 0x20, 0x21, 0x22):
        r.uleb()
    elif op == 0x41:
        r.sleb()
    elif op in (0x28, 0x36):  # memarg: align + offset
        r.uleb()
        r.uleb()
    elif op == 0x0E:  # br_table
        n = r.uleb()
        for _ in range(n + 1):
            r.uleb()


def _make_init_wrapper(mod: WasmModule, name: str, inner: str, sig: FuncSig):
    """Exported entry wrapper: materialize active data segments into linear
    memory (one u32 store per nonzero word — untouched cells read as zero),
    then tail-call the real function."""
    b = Block(0)
    nv = 0

    def val(ty):
        nonlocal nv
        v = Value(nv, ty)
        nv += 1
        return v

    params = []
    for k, (pn, _) in enumerate(sig.params):
        v = val(U32)
        params.append((pn, v))
    base = membase_cell(mod)
    for seg_off, data in mod.data_segments:
        if seg_off % 4:
            raise WasmError("data segment offset must be 4-byte aligned")
        padded = data + b"\x00" * (-len(data) % 4)
        for k in range(0, len(padded), 4):
            w = int.from_bytes(padded[k : k + 4], "little")
            if w == 0:
                continue
            cell = val(FELT)
            b.instrs.append(
                Instr("const", cell, "", [], 2 * ((seg_off + k) // 4))
            )
            wv = val(U32)
            b.instrs.append(Instr("const", wv, "", [], w))
            b.instrs.append(Instr("store", None, "", [cell, wv], base))
    ret = val(sig.ret) if sig.ret is not UNIT else None
    b.instrs.append(
        Instr("call", ret, "", [p[1] for p in params], inner)
    )
    b.term = Terminator("ret", args=[ret] if ret is not None else [])
    return MirFunction(name, params, sig.ret, [b], nv)


def lower_module(mod: WasmModule, options=None):
    """-> CompilerOutput: every wasm function compiles through the MIR pass
    pipeline + MIR codegen; exports become Program entrypoints."""
    from ..compiler import CompilerOutput
    from ..compiler.codegen import PendingInstr, _CodeHolder
    from ..compiler.mir_codegen import MirFnCodegen
    from ..isa.program import AbiSlot, EntrypointInfo, Program, U32 as ABI_U32

    # with data segments, exports become init wrappers (written first into
    # memory, then tail-call the real function); internal calls keep
    # targeting the inner functions so memory is initialized exactly once
    has_init = bool(mod.data_segments)
    names = []
    rev_exports = {v: k for k, v in mod.exports.items()}
    for i in range(len(mod.funcs)):
        names.append(
            f"__wf_{i}" if has_init else rev_exports.get(i, f"__wf_{i}")
        )

    sigs = {}
    for i, f in enumerate(mod.funcs):
        ty = mod.types[f.type_idx]
        sigs[names[i]] = FuncSig(
            names[i],
            [(f"p{k}", U32) for k in range(len(ty.params))],
            U32 if ty.results else UNIT,
        )
    entry_names = {}  # export name -> function label to use
    if has_init:
        for exp, idx in mod.exports.items():
            inner = sigs[names[idx]]
            sigs[exp] = FuncSig(exp, inner.params, inner.ret)
            entry_names[exp] = exp
    else:
        for exp, idx in mod.exports.items():
            entry_names[exp] = names[idx]

    class _TM:  # minimal TypedModule surface for MirFnCodegen
        functions = sigs

    class _MG:
        tm = _TM()

    units = []  # (name, PendingInstr list)
    for i in range(len(mod.funcs)):
        mfn = run_pipeline(FnLowerer(mod, i, names).lower())
        units.append(
            (names[i], MirFnCodegen(_MG(), mfn, sigs[names[i]]).compile())
        )
    if has_init:
        for exp, idx in mod.exports.items():
            mfn = run_pipeline(
                _make_init_wrapper(mod, exp, names[idx], sigs[exp])
            )
            units.append((exp, MirFnCodegen(_MG(), mfn, sigs[exp]).compile()))

    # assemble: reuse ModuleCompiler's two-pass label resolution by
    # mimicking its structure directly (no AST module exists here)
    from ..isa.instruction import Instruction, SPECS_BY_NAME

    all_instrs = []
    fn_starts = {}
    pos = 0
    for fname, code in units:
        fn_starts[pos] = fname
        all_instrs.extend(code)
        pos += len(code)
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
    P = (1 << 31) - 1
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
    eps = {}
    for name, idx in mod.exports.items():
        sig = sigs[names[idx]]
        eps[name] = EntrypointInfo(
            pc=label_cells[f"__fn_{entry_names[name]}"],
            params=[AbiSlot(n, ABI_U32) for n, _ in sig.params],
            returns=(
                [] if sig.ret.kind == "unit" else [AbiSlot("return", ABI_U32)]
            ),
        )
    program = Program(list(instrs), eps, {"frontend": "wasm"})
    return CompilerOutput(program, [])
