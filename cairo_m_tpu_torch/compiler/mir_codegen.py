"""MIR -> CASM code generation.

Equivalent of `crates/compiler/codegen` driven from MIR instead of the AST
(the reference compiles AST -> MIR -> CASM; SURVEY.md §2.3).  Emits the
same `PendingInstr` stream as codegen.FnCompiler, so ModuleCompiler's
two-pass label resolution and the VM ABI are shared between both paths.

Slot discipline: every SSA value owns a fixed fp-relative slot range for
the whole function (no reuse — untouched memory cells are free in the
Cairo-M cost model, where trace length counts *accesses*).  `extract`
values alias into their source's slots (zero instructions).  Phi nodes own
slots; predecessors write them with sequenced parallel copies (cycles
broken through a temp slot) — the PhiElimination stage of the reference
pipeline (mir/passes.rs:93-105).
"""

from __future__ import annotations

from .codegen import PendingInstr
from .mir import MirFunction, Unsupported
from .sem import Type

P = (1 << 31) - 1


class MirFnCodegen:
    def __init__(self, mg, fn: MirFunction, sig):
        self.mg = mg  # ModuleCompiler (for tm.functions)
        self.fn = fn
        self.sig = sig
        self.code: list[PendingInstr] = []
        self.slots: dict[int, int] = {}  # value id -> fp offset of slot 0
        self.widths: dict[int, int] = {}
        self.watermark = 0
        self.M = sum(t.call_slots() for _, t in sig.params)
        self.K = sig.ret.call_slots()
        self._label_n = 0

    # -- emission --

    def emit(self, name, **fields):
        self.code.append(PendingInstr(name, fields))

    def label(self, tag) -> str:
        return f"{self.fn.name}__m{tag}"

    def place_label(self, lab):
        self.code.append(PendingInstr("__label__", {}, label_here=lab))

    def alloc(self, n: int) -> int:
        off = self.watermark
        self.watermark += n
        return off

    def copy_slots(self, src: int, dst: int, n: int):
        for i in range(n):
            if src + i != dst + i:
                self.emit(
                    "StoreAddFpImm", src_off=src + i, imm=0, dst_off=dst + i
                )

    # -- slots --

    def slot(self, v) -> int:
        s = self.slots.get(v.id)
        if s is None:
            s = self.alloc(v.ty.slots())
            self.slots[v.id] = s
        return s

    # -- main --

    def compile(self) -> list:
        fn = self.fn
        # param slots: ABI offsets
        off = -(self.M + self.K + 2)
        for name, v in fn.params:
            self.slots[v.id] = off
            off += v.ty.call_slots()
        # pre-pass: defs, aliasing for extract, const values
        self.defs = {
            i.dst.id: i
            for b in fn.blocks
            for i in b.instrs
            if i.dst is not None
        }
        # block order: natural id order (lowering emits roughly in layout
        # order); unreachable blocks have no term and are skipped
        order = [b for b in fn.blocks if b.term is not None]
        order_ids = {b.id: k for k, b in enumerate(order)}
        # phi coalescing: an incoming value defined in the predecessor whose
        # ONLY use is the phi can be computed directly into the phi's slot,
        # dropping the edge copy — unless the defining instruction also
        # reads the phi (same-cell read+write in one instruction is illegal
        # under the memory argument's clock range-check), or the phi is
        # still read inside the predecessor after the def.
        use_count: dict[int, int] = {}
        used_in_block: dict[int, set] = {}
        has_extract_user: set = set()
        for b in fn.blocks:
            for ins in b.instrs:
                for a in ins.args:
                    use_count[a.id] = use_count.get(a.id, 0) + 1
                    used_in_block.setdefault(b.id, set()).add(a.id)
                    if ins.kind == "extract":
                        has_extract_user.add(a.id)
            if b.term is not None:
                for a in b.term.args:
                    use_count[a.id] = use_count.get(a.id, 0) + 1
                    used_in_block.setdefault(b.id, set()).add(a.id)
        # phi-incoming uses happen ON the edge (end of pred), not in the
        # merge block: a phi dst that feeds another phi from the same pred
        # must not be overwritten mid-pred by a coalesced value
        phi_incoming: set = set()  # (pred_id, value_id)
        for b in order:
            for ph in b.phis:
                for val, pred in zip(ph.args, ph.extra):
                    phi_incoming.add((pred, val.id))
        coalesced: set = set()  # value ids computed straight into phi slots
        for b in order:
            for ph in b.phis:
                for val, pred in zip(ph.args, ph.extra):
                    d = self.defs.get(val.id)
                    if (
                        d is None
                        or d.kind not in ("bin", "un", "make", "insert")
                        or use_count.get(val.id, 0) != 1
                        or val.id in coalesced
                        or ph.dst.id in used_in_block.get(pred, ())
                        or ph.dst.id in has_extract_user
                        or (pred, ph.dst.id) in phi_incoming
                        or any(a.id == ph.dst.id for a in d.args)
                        or not self._defined_in(val, pred)
                    ):
                        continue
                    self.slots[val.id] = self.slot(ph.dst)
                    coalesced.add(val.id)
        # edge copies: (pred, succ) -> [(dst_slot, src_value)]
        self.edge_copies: dict[tuple, list] = {}
        for b in order:
            for ph in b.phis:
                dst_slot = self.slot(ph.dst)
                for val, pred in zip(ph.args, ph.extra):
                    if val.id in coalesced and self.slots[val.id] == dst_slot:
                        continue  # computed in place
                    self.edge_copies.setdefault((pred, b.id), []).append(
                        (dst_slot, val, ph.dst.ty.slots())
                    )
        for k, b in enumerate(order):
            nxt = order[k + 1].id if k + 1 < len(order) else None
            self.place_label(self.label(f"b{b.id}"))
            for i in b.instrs:
                if i.kind != "phi":
                    self.instr(i)
            self.terminator(b, nxt)
        return self.code

    # -- edges --

    def _defined_in(self, v, block_id) -> bool:
        for ins in self.fn.blocks[block_id].instrs:
            if ins.dst is not None and ins.dst.id == v.id:
                return True
        return False

    def _edge_label(self, pred, succ, fallthrough_label=None):
        """Return the jump label for edge pred->succ, materializing an edge
        block (copies + jmp) when the edge carries phi copies."""
        copies = self.edge_copies.get((pred, succ))
        if not copies:
            return self.label(f"b{succ}")
        lab = self.label(f"e{pred}_{succ}")
        return lab

    def _emit_edge_blocks(self, pred, succs):
        """After the branch of `pred`, emit its pending edge blocks."""
        for succ in succs:
            copies = self.edge_copies.get((pred, succ))
            if not copies:
                continue
            self.place_label(self.label(f"e{pred}_{succ}"))
            self._parallel_copies(copies)
            self.emit("JmpAbsImm", target=("label", self.label(f"b{succ}")))

    def _parallel_copies(self, copies):
        """copies: [(dst_slot, src_value, width)] with parallel semantics."""
        pend = []
        for dst, srcv, w in copies:
            src = self.slot(srcv)
            if src != dst:
                pend.append([dst, src, w])
        while pend:
            progressed = False
            for c in list(pend):
                dst, src, w = c
                # safe if no other pending copy reads from [dst, dst+w)
                if not any(
                    o is not c and not (o[1] + o[2] <= dst or dst + w <= o[1])
                    for o in pend
                ):
                    self.copy_slots(src, dst, w)
                    pend.remove(c)
                    progressed = True
            if not progressed:
                # cycle: rotate one through a temp
                dst, src, w = pend[0]
                tmp = self.alloc(w)
                self.copy_slots(src, tmp, w)
                pend[0][1] = tmp
        return

    # -- terminators --

    def terminator(self, b, nxt):
        t = b.term
        if t.kind == "ret":
            if t.args:
                v = t.args[0]
                self.copy_slots(self.slot(v), -(self.K + 2), v.ty.call_slots())
            self.emit("Ret")
            return
        if t.kind == "jump":
            (succ,) = t.targets
            copies = self.edge_copies.get((b.id, succ))
            if copies:
                self._parallel_copies(copies)
            if succ != nxt:
                self.emit(
                    "JmpAbsImm", target=("label", self.label(f"b{succ}"))
                )
            return
        if t.kind == "br":
            cond = t.args[0]
            then_t, else_t = t.targets
            self._cond_branch(self.slot(cond), b, then_t, else_t, nxt)
            return
        if t.kind == "br_cmp":
            a, c = t.args
            then_t, else_t = t.targets
            # d = a - c; ne: jnz d -> then; eq: jnz d -> else
            d = self.alloc(1)
            cb = self._const_of(c)
            ca = self._const_of(a)
            if ca is not None and cb is not None:
                self.emit("StoreImm", imm=(ca - cb) % P, dst_off=d)
            elif cb is not None:
                self.emit(
                    "StoreAddFpImm", src_off=self.slot(a),
                    imm=(P - cb) % P, dst_off=d,
                )
            elif ca is not None:
                self.emit(
                    "StoreAddFpImm", src_off=self.slot(c),
                    imm=(P - ca) % P, dst_off=d,
                )
            else:
                self.emit(
                    "StoreSubFpFp", src0_off=self.slot(a),
                    src1_off=self.slot(c), dst_off=d,
                )
            if t.op == "ne":
                self._cond_branch(d, b, then_t, else_t, nxt)
            else:
                self._cond_branch(d, b, else_t, then_t, nxt)
            return
        raise Unsupported(f"terminator {t.kind}")

    def _cond_branch(self, cond_slot, b, nz_target, z_target, nxt):
        """jnz cond -> nz_target; fallthrough/jmp -> z_target."""
        nz_lab = self._edge_label(b.id, nz_target)
        z_lab = self._edge_label(b.id, z_target)
        self.emit("JnzFpImm", cond_off=cond_slot, offset=("rel", nz_lab))
        z_direct = not self.edge_copies.get((b.id, z_target))
        if not (z_direct and z_target == nxt and not self.edge_copies.get((b.id, nz_target))):
            self.emit("JmpAbsImm", target=("label", z_lab))
        self._emit_edge_blocks(b.id, [nz_target, z_target])

    # -- instructions --

    def _const_of(self, v):
        d = self.defs.get(v.id)
        if d is not None and d.kind == "const":
            return d.extra
        return None

    def instr(self, i):
        k = i.kind
        if k == "const":
            # materialize only when some non-foldable consumer needs a slot
            # (cheap: always materialize; DCE removed unused consts)
            if self._const_needed(i):
                dst = self.slot(i.dst)
                if i.dst.ty.kind == "u32":
                    self.emit(
                        "U32StoreImm",
                        imm_lo=i.extra & 0xFFFF,
                        imm_hi=(i.extra >> 16) & 0xFFFF,
                        dst_off=dst,
                    )
                else:
                    self.emit("StoreImm", imm=i.extra % P, dst_off=dst)
            return
        if k == "bin":
            self._bin(i)
            return
        if k == "un":
            self._un(i)
            return
        if k == "cast":
            self._cast(i)
            return
        if k == "call":
            self._call(i)
            return
        if k == "make":
            dst = self.slot(i.dst)
            cur = dst
            for part in i.args:
                self.copy_slots(self.slot(part), cur, part.ty.slots())
                cur += part.ty.slots()
            return
        if k == "extract":
            # alias into the source's slots: zero instructions
            self.slots[i.dst.id] = self.slot(i.args[0]) + i.extra
            return
        if k == "insert":
            agg, val = i.args
            dst = self.slot(i.dst)
            self.copy_slots(self.slot(agg), dst, agg.ty.slots())
            self.copy_slots(self.slot(val), dst + i.extra, val.ty.slots())
            return
        # -- memory-shaped instructions (arrays / pointers / heap) --
        if k == "alloca":
            self.slot(i.dst)  # reserve the frame storage; no code
            return
        if k == "addr":
            # felt address of frame storage + static offset
            self.emit(
                "StoreFramePointer",
                imm=self.slot(i.args[0]) + i.extra,
                dst_off=self.slot(i.dst),
            )
            return
        if k == "slot_read":
            # copy out of mutable frame storage (value semantics — a later
            # slot_write must not change this value, so no aliasing)
            dst = self.slot(i.dst)
            self.copy_slots(self.slot(i.args[0]) + i.extra, dst, i.dst.ty.slots())
            return
        if k == "slot_write":
            arr, val = i.args
            self.copy_slots(
                self.slot(val), self.slot(arr) + i.extra, val.ty.slots()
            )
            return
        if k == "load":
            addr = self.slot(i.args[0])
            dst = self.slot(i.dst)
            for j in range(i.dst.ty.slots()):
                self.emit(
                    "StoreDoubleDerefFp",
                    base_off=addr, imm=i.extra + j, dst_off=dst + j,
                )
            return
        if k == "store":
            addr, val = i.args
            a = self.slot(addr)
            src = self.slot(val)
            for j in range(val.ty.slots()):
                self.emit(
                    "StoreToDoubleDerefFpImm",
                    base_off=a, imm=i.extra + j, src_off=src + j,
                )
            return
        if k == "newarr":
            self._newarr(i)
            return
        raise Unsupported(f"instr {k}")

    def _newarr(self, i):
        """Reference-compatible heap bump allocation (codegen.py:_new_array,
        generator.rs:89-186): read HEAP_CURSOR, compute the descending base,
        advance the cursor."""
        elem_slots = i.extra
        MAX_ADDRESS = (1 << 28) - 1
        hp_addr = self.alloc(1)
        self.emit("StoreImm", imm=("label", "__HEAP_CURSOR__"), dst_off=hp_addr)
        cur = self.alloc(1)
        self.emit("StoreDoubleDerefFp", base_off=hp_addr, imm=0, dst_off=cur)
        cnt = self.slot(i.args[0])
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
        self.emit("StoreImm", imm=MAX_ADDRESS, dst_off=mx)
        base = self.slot(i.dst)
        self.emit("StoreSubFpFp", src0_off=mx, src1_off=s, dst_off=base)
        ncur = self.alloc(1)
        self.emit("StoreAddFpFp", src0_off=cur, src1_off=cells, dst_off=ncur)
        self.emit(
            "StoreToDoubleDerefFpImm", base_off=hp_addr, imm=0, src_off=ncur
        )

    def _const_needed(self, i):
        """A const needs a frame slot unless every use folds it into an
        immediate field.  Conservative: check every user."""
        uses = self._uses.get(i.dst.id, ())
        return any(not u for u in uses) if uses else False

    @property
    def _uses(self):
        u = getattr(self, "_uses_cache", None)
        if u is not None:
            return u
        u = {}
        for b in self.fn.blocks:
            for ins in b.instrs:
                for a in ins.args:
                    u.setdefault(a.id, []).append(
                        self._use_folds_const(ins, a)
                    )
            if b.term is not None:
                for a in b.term.args:
                    u.setdefault(a.id, []).append(
                        b.term.kind == "br_cmp"
                    )
        self._uses_cache = u
        return u

    def _use_folds_const(self, ins, arg):
        """True if `ins` takes `arg` as an immediate (must exactly mirror
        the folding decisions of `_bin`/`_bin_u32`/`terminator`)."""
        if ins.kind != "bin":
            return False
        a, b = ins.args
        ty = a.ty.kind
        if ty == "u32" or b.ty.kind == "u32":
            return arg is b and ins.op in (
                "+", "-", "*", "&", "|", "^", "/", "%", "==", "<",
            )
        rhs_const = self._const_of(b) is not None
        if arg is b:
            return ins.op in ("+", "-", "*", "/", "==", "!=", "<=")
        # lhs folds only when the rhs isn't a const (rhs takes priority)
        return (not rhs_const) and ins.op in ("+", "*", "-", "==", "!=")

    def _bin(self, i):
        a, b = i.args
        kind = a.ty.kind
        op = i.op
        if kind == "u32" or b.ty.kind == "u32":
            self._bin_u32(i)
            return
        ca, cb = self._const_of(a), self._const_of(b)
        dst = self.slot(i.dst)
        if op in ("&&", "||"):
            sa, sb = self.slot(a), self.slot(b)
            if op == "&&":
                self.emit("StoreMulFpFp", src0_off=sa, src1_off=sb, dst_off=dst)
            else:
                t = self.alloc(1)
                s = self.alloc(1)
                self.emit("StoreMulFpFp", src0_off=sa, src1_off=sb, dst_off=t)
                self.emit("StoreAddFpFp", src0_off=sa, src1_off=sb, dst_off=s)
                self.emit("StoreSubFpFp", src0_off=s, src1_off=t, dst_off=dst)
            return
        if op in ("+", "*", "-", "/"):
            if cb is not None:
                sa = self.slot(a)
                if op == "+":
                    self.emit("StoreAddFpImm", src_off=sa, imm=cb % P, dst_off=dst)
                elif op == "-":
                    self.emit(
                        "StoreAddFpImm", src_off=sa, imm=(P - cb) % P, dst_off=dst
                    )
                elif op == "*":
                    self.emit("StoreMulFpImm", src_off=sa, imm=cb % P, dst_off=dst)
                else:
                    inv = pow(cb % P, P - 2, P)
                    self.emit("StoreMulFpImm", src_off=sa, imm=inv, dst_off=dst)
                return
            if ca is not None and op in ("+", "*"):
                sb = self.slot(b)
                name = "StoreAddFpImm" if op == "+" else "StoreMulFpImm"
                self.emit(name, src_off=sb, imm=ca % P, dst_off=dst)
                return
            if ca is not None and op == "-":
                # c - x = (P-1)*x + c
                sb = self.slot(b)
                t = self.alloc(1)
                self.emit("StoreMulFpImm", src_off=sb, imm=P - 1, dst_off=t)
                self.emit("StoreAddFpImm", src_off=t, imm=ca % P, dst_off=dst)
                return
            sa, sb = self.slot(a), self.slot(b)
            name = {
                "+": "StoreAddFpFp", "-": "StoreSubFpFp",
                "*": "StoreMulFpFp", "/": "StoreDivFpFp",
            }[op]
            self.emit(name, src0_off=sa, src1_off=sb, dst_off=dst)
            return
        if op == "<=" and cb is not None:
            self.emit(
                "StoreLeFpImm", src_off=self.slot(a), imm=cb % P, dst_off=dst
            )
            return
        if op in ("==", "!="):
            # materialized boolean (non-fused): d = a - b; out = [d == 0]
            d = self.alloc(1)
            if cb is not None:
                self.emit(
                    "StoreAddFpImm", src_off=self.slot(a),
                    imm=(P - cb) % P, dst_off=d,
                )
            elif ca is not None:
                self.emit(
                    "StoreAddFpImm", src_off=self.slot(b),
                    imm=(P - ca) % P, dst_off=d,
                )
            else:
                self.emit(
                    "StoreSubFpFp", src0_off=self.slot(a),
                    src1_off=self.slot(b), dst_off=d,
                )
            eq_val, neq_val = (1, 0) if op == "==" else (0, 1)
            self._label_n += 1
            other = self.label(f"x{self._label_n}")
            end = self.label(f"y{self._label_n}")
            self.emit("StoreImm", imm=eq_val, dst_off=dst)
            self.emit("JnzFpImm", cond_off=d, offset=("rel", other))
            self.emit("JmpAbsImm", target=("label", end))
            self.place_label(other)
            self.emit("StoreImm", imm=neq_val, dst_off=dst)
            self.place_label(end)
            return
        raise Unsupported(f"felt op {op}")

    def _bin_u32(self, i):
        a, b = i.args
        op = i.op
        cb = self._const_of(b)
        dst = self.slot(i.dst)

        def ip(v):
            return v & 0xFFFF, (v >> 16) & 0xFFFF

        if cb is not None and op in ("+", "-", "*", "&", "|", "^"):
            imm = cb if op != "-" else ((1 << 32) - cb) & 0xFFFFFFFF
            lo, hi = ip(imm)
            name = {
                "+": "U32StoreAddFpImm", "-": "U32StoreAddFpImm",
                "*": "U32StoreMulFpImm", "&": "U32StoreAndFpImm",
                "|": "U32StoreOrFpImm", "^": "U32StoreXorFpImm",
            }[op]
            self.emit(
                name, src_off=self.slot(a), imm_lo=lo, imm_hi=hi, dst_off=dst
            )
            return
        if cb is not None and op in ("/", "%"):
            lo, hi = ip(cb)
            q = dst if op == "/" else self.alloc(2)
            r = dst if op == "%" else self.alloc(2)
            self.emit(
                "U32StoreDivRemFpImm", src_off=self.slot(a),
                imm_lo=lo, imm_hi=hi, dst_off=q, dst_rem_off=r,
            )
            return
        if cb is not None and op in ("==", "<"):
            lo, hi = ip(cb)
            name = "U32StoreEqFpImm" if op == "==" else "U32StoreLtFpImm"
            self.emit(
                name, src_off=self.slot(a), imm_lo=lo, imm_hi=hi, dst_off=dst
            )
            return
        sa, sb = self.slot(a), self.slot(b)
        if op in ("+", "-", "*", "&", "|", "^"):
            name = {
                "+": "U32StoreAddFpFp", "-": "U32StoreSubFpFp",
                "*": "U32StoreMulFpFp", "&": "U32StoreAndFpFp",
                "|": "U32StoreOrFpFp", "^": "U32StoreXorFpFp",
            }[op]
            self.emit(name, src0_off=sa, src1_off=sb, dst_off=dst)
            return
        if op in ("/", "%"):
            q = dst if op == "/" else self.alloc(2)
            r = dst if op == "%" else self.alloc(2)
            self.emit(
                "U32StoreDivRemFpFp", src0_off=sa, src1_off=sb,
                dst_off=q, dst_rem_off=r,
            )
            return
        if op == "==":
            self.emit("U32StoreEqFpFp", src0_off=sa, src1_off=sb, dst_off=dst)
            return
        if op == "<":
            self.emit("U32StoreLtFpFp", src0_off=sa, src1_off=sb, dst_off=dst)
            return
        if op == ">":
            self.emit("U32StoreLtFpFp", src0_off=sb, src1_off=sa, dst_off=dst)
            return
        t = self.alloc(1)
        if op == "!=":
            self.emit("U32StoreEqFpFp", src0_off=sa, src1_off=sb, dst_off=t)
        elif op == "<=":
            self.emit("U32StoreLtFpFp", src0_off=sb, src1_off=sa, dst_off=t)
        elif op == ">=":
            self.emit("U32StoreLtFpFp", src0_off=sa, src1_off=sb, dst_off=t)
        else:
            raise Unsupported(f"u32 op {op}")
        t2 = self.alloc(1)
        self.emit("StoreMulFpImm", src_off=t, imm=P - 1, dst_off=t2)
        self.emit("StoreAddFpImm", src_off=t2, imm=1, dst_off=dst)

    def _un(self, i):
        v = i.args[0]
        dst = self.slot(i.dst)
        if i.op == "-":
            if i.dst.ty.kind == "u32":
                zero = self.alloc(2)
                self.emit("U32StoreImm", imm_lo=0, imm_hi=0, dst_off=zero)
                self.emit(
                    "U32StoreSubFpFp", src0_off=zero,
                    src1_off=self.slot(v), dst_off=dst,
                )
            else:
                self.emit(
                    "StoreMulFpImm", src_off=self.slot(v), imm=P - 1, dst_off=dst
                )
            return
        # !b = 1 - b
        t = self.alloc(1)
        self.emit("StoreMulFpImm", src_off=self.slot(v), imm=P - 1, dst_off=t)
        self.emit("StoreAddFpImm", src_off=t, imm=1, dst_off=dst)

    def _cast(self, i):
        src, dst_k = i.op.split("->")
        v = i.args[0]
        if src == "u32" and dst_k == "felt":
            sv = self.slot(v)
            lt = self.alloc(1)
            self.emit(
                "U32StoreLtFpImm", src_off=sv,
                imm_lo=0xFFFF, imm_hi=0x7FFF, dst_off=lt,
            )
            self.emit("AssertEqFpImm", src_off=lt, imm=1)
            t = self.alloc(1)
            self.emit("StoreMulFpImm", src_off=sv + 1, imm=1 << 16, dst_off=t)
            self.emit(
                "StoreAddFpFp", src0_off=sv, src1_off=t,
                dst_off=self.slot(i.dst),
            )
            return
        if src == "bool" and dst_k == "u32":
            # widen 0/1 to a u32: lo = bool, hi = 0 (wasm frontend)
            dst = self.slot(i.dst)
            self.copy_slots(self.slot(v), dst, 1)
            self.emit("StoreImm", imm=0, dst_off=dst + 1)
            return
        if src == "felt" and dst_k == "u32":
            raise Unsupported("felt->u32 cast in MIR path")
        # identity-width casts alias
        self.slots[i.dst.id] = self.slot(v)

    def _call(self, i):
        sig = self.mg.tm.functions[i.extra]
        M = sum(t.call_slots() for _, t in sig.params)
        K = sig.ret.call_slots()
        base = self.alloc(M + K)  # per-site region; result aliases into it
        cur = base
        for a in i.args:
            self.copy_slots(self.slot(a), cur, a.ty.call_slots())
            cur += a.ty.call_slots()
        self.emit(
            "CallAbsImm", frame_off=base + M + K,
            target=("label", f"__fn_{i.extra}"),
        )
        if i.dst is not None and i.dst.ty.kind != "unit":
            self.slots[i.dst.id] = base + M


def compile_mir_function(mg, fn: MirFunction, sig) -> list:
    return MirFnCodegen(mg, fn, sig).compile()
