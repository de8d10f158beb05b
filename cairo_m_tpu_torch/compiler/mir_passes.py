"""MIR optimization passes.

The reference pipeline (crates/compiler/mir/src/passes.rs:93-105) is
SROA -> ArithmeticSimplify -> ConstantPropagation -> ConstantFolding ->
CopyPropagation -> LocalCSE -> SimplifyBranches -> FuseCmpBranch -> DCE ->
PhiElimination.  Here SROA is free (aggregates are SSA values by
construction, mir.py) and phi elimination lives in the code generator
(parallel-copy sequencing, mir_codegen.py); the rest:

- simplify_and_fold: arithmetic identities + constant folding (+ const
  propagation: SSA makes it the same pass);
- copy_propagation: extract-of-make / insert-forwarding / identity casts;
- local_cse: per-block value numbering;
- simplify_branches: br(const) -> jump, and FuseCmpBranch — br whose
  condition is a single-use felt ==/!= (or a != 0 test) becomes br_cmp,
  eliminating the 0/1 boolean materialization (6 CASM instructions saved
  per loop iteration in the fib pattern);
- dce: drop dead pure instructions + unreachable blocks + thread
  trivial jump chains.
"""

from __future__ import annotations

from .mir import Block, Instr, MirFunction, Terminator

P = (1 << 31) - 1

# alloca/addr/slot_read/load are droppable when unused (reads have no
# side effect); store/slot_write/newarr/call mutate state and are kept.
_PURE = {
    "const", "bin", "un", "cast", "make", "extract", "insert", "phi",
    "alloca", "addr", "slot_read", "load",
}


def _const_of(defs, v):
    d = defs.get(v.id)
    if d is not None and d.kind == "const":
        return d.extra
    return None


def _defs(fn: MirFunction) -> dict:
    return {
        i.dst.id: i for b in fn.blocks for i in b.instrs if i.dst is not None
    }


def _replace_uses(fn: MirFunction, mapping: dict):
    """mapping: value id -> replacement Value."""
    if not mapping:
        return

    def res(v):
        seen = set()
        while v.id in mapping and v.id not in seen:
            seen.add(v.id)
            v = mapping[v.id]
        return v

    for b in fn.blocks:
        for i in b.instrs:
            i.args = [res(a) for a in i.args]
        if b.term:
            b.term.args = [res(a) for a in b.term.args]


# ---------------------------------------------------------------------------


def simplify_and_fold(fn: MirFunction) -> bool:
    """Constant propagation/folding + arithmetic identities."""
    changed = False
    defs = _defs(fn)
    mapping = {}
    for b in fn.blocks:
        for i in b.instrs:
            if i.kind == "bin":
                ca = _const_of(defs, i.args[0])
                cb = _const_of(defs, i.args[1])
                kind = i.args[0].ty.kind
                v = _fold_bin(i.op, kind, ca, cb)
                if ca is not None and cb is not None and v is not None:
                    i.kind, i.extra, i.args, i.op = "const", v, [], ""
                    defs[i.dst.id] = i
                    changed = True
                    continue
                rep = _identity_bin(i, ca, cb, kind)
                if rep is not None:
                    mapping[i.dst.id] = rep
                    changed = True
            elif i.kind == "un":
                ca = _const_of(defs, i.args[0])
                if ca is not None:
                    kind = i.args[0].ty.kind
                    if i.op == "-":
                        v = (P - ca) % P if kind != "u32" else (-ca) % (1 << 32)
                        i.kind, i.extra, i.args, i.op = "const", v, [], ""
                        defs[i.dst.id] = i
                        changed = True
                    elif i.op == "!":
                        i.kind, i.extra, i.args, i.op = (
                            "const", 0 if ca else 1, [], "",
                        )
                        defs[i.dst.id] = i
                        changed = True
            elif i.kind == "cast":
                src, dst = i.op.split("->")
                if src == dst or (src, dst) in (
                    ("bool", "felt"), ("felt", "bool"),
                ):
                    mapping[i.dst.id] = i.args[0]
                    changed = True
                else:
                    ca = _const_of(defs, i.args[0])
                    if ca is not None and (
                        (src, dst) == ("u32", "felt") and ca < P
                        or (src, dst) == ("bool", "u32")
                    ):
                        i.kind, i.extra, i.args, i.op = "const", ca, [], ""
                        defs[i.dst.id] = i
                        changed = True
            elif i.kind == "phi":
                # phi with all-identical args (after substitution) collapses
                uniq = {a.id for a in i.args if a.id != i.dst.id}
                if len(uniq) == 1:
                    (only,) = uniq
                    mapping[i.dst.id] = next(
                        a for a in i.args if a.id == only
                    )
                    changed = True
    _replace_uses(fn, mapping)
    return changed


def _fold_bin(op, kind, ca, cb):
    if ca is None or cb is None:
        return None
    if kind == "u32":
        M = (1 << 32) - 1
        table = {
            "+": lambda: (ca + cb) & M, "-": lambda: (ca - cb) & M,
            "*": lambda: (ca * cb) & M,
            "/": lambda: ca // cb if cb else None,
            "%": lambda: ca % cb if cb else None,
            "&": lambda: ca & cb, "|": lambda: ca | cb, "^": lambda: ca ^ cb,
            "==": lambda: int(ca == cb), "!=": lambda: int(ca != cb),
            "<": lambda: int(ca < cb), "<=": lambda: int(ca <= cb),
            ">": lambda: int(ca > cb), ">=": lambda: int(ca >= cb),
        }
    else:
        table = {
            "+": lambda: (ca + cb) % P, "-": lambda: (ca - cb) % P,
            "*": lambda: (ca * cb) % P,
            "/": lambda: (ca * pow(cb, P - 2, P)) % P if cb % P else None,
            "==": lambda: int(ca % P == cb % P),
            "!=": lambda: int(ca % P != cb % P),
            "&&": lambda: int(bool(ca) and bool(cb)),
            "||": lambda: int(bool(ca) or bool(cb)),
        }
    f = table.get(op)
    return f() if f else None


def _identity_bin(i: Instr, ca, cb, kind):
    """x+0, 0+x, x-0, x*1, 1*x, x*0 -> replacement value (or None)."""
    a, b = i.args
    if i.op == "+":
        if cb == 0:
            return a
        if ca == 0:
            return b
    elif i.op == "-":
        if cb == 0:
            return a
    elif i.op == "*":
        if cb == 1:
            return a
        if ca == 1:
            return b
    elif i.op == "/" and cb == 1:
        return a
    elif i.op == "&&":
        if cb == 1:
            return a
        if ca == 1:
            return b
    elif i.op == "||":
        if cb == 0:
            return a
        if ca == 0:
            return b
    return None


def copy_propagation(fn: MirFunction) -> bool:
    """extract(make(..)) and extract(insert(..)) forwarding."""
    changed = False
    defs = _defs(fn)
    mapping = {}
    for b in fn.blocks:
        for i in b.instrs:
            if i.kind != "extract":
                continue
            src = defs.get(i.args[0].id)
            off = i.extra
            w = i.dst.ty.slots()
            while src is not None:
                if src.kind == "make":
                    cur = 0
                    hit = None
                    for part in src.args:
                        pw = part.ty.slots()
                        if cur == off and pw == w:
                            hit = part
                            break
                        cur += pw
                    if hit is not None:
                        mapping[i.dst.id] = hit
                        changed = True
                    break
                if src.kind == "insert":
                    ins_off = src.extra
                    ins_w = src.args[1].ty.slots()
                    if ins_off == off and ins_w == w:
                        mapping[i.dst.id] = src.args[1]
                        changed = True
                        break
                    if ins_off + ins_w <= off or off + w <= ins_off:
                        src = defs.get(src.args[0].id)  # disjoint: look through
                        continue
                    break
                if src.kind == "extract":
                    # extract(extract(x, o1), o2) = extract(x, o1+o2)
                    i.args = [src.args[0]]
                    i.extra = src.extra + off
                    off = i.extra
                    src = defs.get(i.args[0].id)
                    changed = True
                    continue
                break
    _replace_uses(fn, mapping)
    return changed


def local_cse(fn: MirFunction) -> bool:
    changed = False
    mapping = {}
    for b in fn.blocks:
        seen = {}
        for i in b.instrs:
            # NOTE: slot_read/load never CSE — frame/heap cells mutate
            if i.kind not in ("bin", "un", "cast", "extract", "make", "const", "addr"):
                continue
            args = tuple(
                mapping.get(a.id, a).id for a in i.args
            )
            # the dst TYPE is part of the value identity: `const felt 0`
            # and `const u32 0` share (kind, extra) but have different
            # slot widths — merging them hands a 1-slot value to 2-slot
            # consumers (phi edge copies read a neighboring slot)
            key = (
                i.kind, i.op, args,
                i.extra if not isinstance(i.extra, list) else tuple(i.extra),
                i.dst.ty.kind if i.dst is not None else None,
            )
            hit = seen.get(key)
            if hit is not None:
                mapping[i.dst.id] = hit.dst
                changed = True
            else:
                seen[key] = i
    _replace_uses(fn, mapping)
    return changed


def simplify_branches(fn: MirFunction) -> bool:
    """br(const) -> jump; FuseCmpBranch: br on single-use felt ==/!= or
    != 0 -> br_cmp / direct br."""
    changed = False
    defs = _defs(fn)
    uses = {}
    for b in fn.blocks:
        for i in b.instrs:
            for a in i.args:
                uses[a.id] = uses.get(a.id, 0) + 1
        if b.term:
            for a in b.term.args:
                uses[a.id] = uses.get(a.id, 0) + 1
    for b in fn.blocks:
        t = b.term
        if t is None or t.kind != "br":
            continue
        cond = t.args[0]
        cd = defs.get(cond.id)
        if cd is None:
            continue
        if cd.kind == "const":
            tgt = t.targets[0] if cd.extra else t.targets[1]
            b.term = Terminator("jump", targets=[tgt])
            changed = True
            continue
        if (
            cd.kind == "bin"
            and cd.op in ("==", "!=")
            and uses.get(cond.id, 0) == 1
            and cd.args[0].ty.kind in ("felt", "bool")
        ):
            then_t, else_t = t.targets
            if cd.op == "==":
                # cond true when equal
                b.term = Terminator(
                    "br_cmp", args=list(cd.args),
                    targets=[then_t, else_t], op="eq",
                )
            else:
                b.term = Terminator(
                    "br_cmp", args=list(cd.args),
                    targets=[then_t, else_t], op="ne",
                )
            changed = True
    return changed


def dce(fn: MirFunction) -> bool:
    """Remove dead pure instructions, unreachable blocks; thread jumps to
    empty jump-only blocks."""
    changed = False
    # liveness
    live = set()
    work = []
    defs = _defs(fn)
    for b in fn.blocks:
        for i in b.instrs:
            if i.kind not in _PURE:  # calls, asserts: side effects
                work += [a.id for a in i.args]
        if b.term:
            work += [a.id for a in b.term.args]
    while work:
        v = work.pop()
        if v in live:
            continue
        live.add(v)
        d = defs.get(v)
        if d is not None:
            work += [a.id for a in d.args]
    for b in fn.blocks:
        before = len(b.instrs)
        b.instrs = [
            i
            for i in b.instrs
            if i.kind not in _PURE or (i.dst is not None and i.dst.id in live)
        ]
        changed |= len(b.instrs) != before

    # unreachable blocks
    reach = set()
    stack = [0]
    while stack:
        bid = stack.pop()
        if bid in reach:
            continue
        reach.add(bid)
        t = fn.blocks[bid].term
        if t:
            stack += [x for x in t.targets if x >= 0]
    for b in fn.blocks:
        if b.id not in reach and (b.instrs or b.term):
            b.instrs = []
            b.term = None
            changed = True
    # drop phi args coming from unreachable preds
    for b in fn.blocks:
        for i in b.instrs:
            if i.kind == "phi":
                pairs = [
                    (a, p) for a, p in zip(i.args, i.extra) if p in reach
                ]
                if len(pairs) != len(i.args):
                    i.args = [a for a, _ in pairs]
                    i.extra = [p for _, p in pairs]
                    changed = True

    # jump threading: a jump to an empty block that only jumps on
    thread = {}
    for b in fn.blocks:
        if (
            b.id in reach
            and not b.instrs
            and b.term is not None
            and b.term.kind == "jump"
            and b.term.targets[0] != b.id
        ):
            # only thread if target has no phis referencing b specifically
            tgt = fn.blocks[b.term.targets[0]]
            if not tgt.phis:
                thread[b.id] = b.term.targets[0]

    def resolve(t):
        seen = set()
        while t in thread and t not in seen:
            seen.add(t)
            t = thread[t]
        return t

    for b in fn.blocks:
        if b.term:
            newt = [resolve(x) for x in b.term.targets]
            if newt != b.term.targets:
                # keep phi pred ids consistent: update any phi in the new
                # target that referenced the threaded block
                for old, new in zip(b.term.targets, newt):
                    if old != new:
                        for i in fn.blocks[new].instrs:
                            if i.kind == "phi":
                                i.extra = [
                                    b.id if p == old else p for p in i.extra
                                ]
                b.term.targets = newt
                changed = True
    return changed


def run_pipeline(fn: MirFunction, max_iters: int = 8) -> MirFunction:
    for _ in range(max_iters):
        changed = False
        changed |= simplify_and_fold(fn)
        changed |= copy_propagation(fn)
        changed |= local_cse(fn)
        changed |= simplify_branches(fn)
        changed |= dce(fn)
        if not changed:
            break
    return fn
