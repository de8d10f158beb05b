"""Wide tape-compiled constraint evaluation.

Counterpart of ``cairo_m_tpu.prover.stark.wtape``.  Constraint programs are
*data*: a component's ``evaluate`` is recorded once per (component,
log_size) into SSA instructions (`WideRecorder`, `WideOps`), list-scheduled
into steps of up to W independent instructions with a register allocation
(`schedule_wide` -> `WidePlan`), and executed over every row of the domain
by one interpreter.  Per-proof scalars (drawn relation parameters, LogUp
shift, composition weights) are runtime constants, so plans are cached.

The recorder, scheduler and plan are the reference's host code, unchanged,
so the plans are identical in both packages.  Execution differs:
`run_wide` prepares the bank rows with plain indexed gathers, and
`run_plan` is the wrapper of the CUDA kernels of ``csrc/wtape.cu``, which
replace both the Pallas kernel ``wtape_pallas._kernel`` and the
``lax.scan`` interpreter ``wtape._wide_kernel``: on the card every plan
goes through them, whatever its step count or domain size.  The plan's
schedule was made for a vector unit 32 slots wide; for one CUDA thread per
lane `kernel_program` drops the NOP slots, re-orders the instructions depth
first and re-allocates the registers, so that the register file fits in
shared memory (the design note is in the CUDA source).  `run_plan_plain`
is the plain torch version: the CPU route and the yardstick of the tests.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import kernels
from ...field import m31
from ...parallel import sharded
from .. import observe

P = (1 << 31) - 1

_ADD, _SUB, _MUL = 0, 1, 2


class WideRecorder:
    """Accumulates SSA instructions, constants (static + dynamic) and bank
    (input column) slots.  API-compatible superset of tape.TapeRecorder."""

    def __init__(self):
        self.instrs = []  # (base_op, src_a, src_b, ssa_dst)
        self.n_ssa = 0
        self.consts = [0]  # slot 0 pinned to 0 (NOP operand)
        self._const_ix = {0: 0}
        self.dyn_keys = {}  # const index -> key
        self.bank = []  # (kind, idx, offset)
        self._bank_ix = {}
        self._cse = {}

    # -- sources --

    def const(self, v) -> tuple:
        v = int(v) % P
        ix = self._const_ix.get(v)
        if ix is None:
            ix = len(self.consts)
            self._const_ix[v] = ix
            self.consts.append(v)
        return ("c", ix)

    def dyn_const(self, key) -> tuple:
        """A constant whose value is supplied at run time (per proof).
        Never constant-folded; deduplicated by key."""
        for ix, k in self.dyn_keys.items():
            if k == key:
                return ("c", ix)
        ix = len(self.consts)
        self.consts.append(None)  # placeholder
        self.dyn_keys[ix] = key
        return ("c", ix)

    def bank_src(self, kind: str, idx: int, offset: int) -> tuple:
        key = (kind, idx, offset)
        ix = self._bank_ix.get(key)
        if ix is None:
            ix = len(self.bank)
            self._bank_ix[key] = ix
            self.bank.append(key)
        return ("b", ix)

    def _static_val(self, s):
        if s[0] != "c" or s[1] in self.dyn_keys:
            return None
        return self.consts[s[1]]

    # -- emission with simplification + hash-consing --

    def emit(self, op: int, a: tuple, b: tuple) -> tuple:
        va, vb = self._static_val(a), self._static_val(b)
        if va is not None and vb is not None:
            if op == _ADD:
                return self.const(va + vb)
            if op == _SUB:
                return self.const(va - vb)
            return self.const(va * vb)
        if op == _ADD:
            if va == 0:
                return b
            if vb == 0:
                return a
            if b < a:
                a, b = b, a
        elif op == _SUB:
            if vb == 0:
                return a
        else:  # MUL
            if va == 0 or vb == 0:
                return self.const(0)
            if va == 1:
                return b
            if vb == 1:
                return a
            if b < a:
                a, b = b, a
        key = (op, a, b)
        hit = self._cse.get(key)
        if hit is not None:
            return hit
        dst = ("r", self.n_ssa)
        self.n_ssa += 1
        self.instrs.append((op, a, b, dst[1]))
        self._cse[key] = dst
        return dst


class WideOps:
    """Backend protocol (stark/air.py) over symbolic sources — identical
    field formulas to tape.TapeOps, plus pass-through of symbolic QM31
    constants (used to inject dynamic relation parameters)."""

    def __init__(self, rec: WideRecorder):
        self.rec = rec

    def badd(self, a, b):
        return self.rec.emit(_ADD, a, b)

    def bsub(self, a, b):
        return self.rec.emit(_SUB, a, b)

    def bmul(self, a, b):
        return self.rec.emit(_MUL, a, b)

    def bneg(self, a):
        return self.rec.emit(_SUB, self.rec.const(0), a)

    def bconst(self, c, like=None):
        return self.rec.const(c)

    def embed(self, b):
        z = self.rec.const(0)
        return (b, z, z, z)

    def econst(self, q):
        return tuple(
            x if _is_src(x) else self.rec.const(int(x)) for x in q
        )

    def eadd(self, x, y):
        return tuple(self.badd(a, b) for a, b in zip(x, y))

    def esub(self, x, y):
        return tuple(self.bsub(a, b) for a, b in zip(x, y))

    def eneg(self, x):
        return tuple(self.bneg(a) for a in x)

    def emul_b(self, x, s):
        return tuple(self.bmul(a, s) for a in x)

    def _cmul(self, p, q):
        return (
            self.bsub(self.bmul(p[0], q[0]), self.bmul(p[1], q[1])),
            self.badd(self.bmul(p[0], q[1]), self.bmul(p[1], q[0])),
        )

    def _cmul_r(self, p):
        return (
            self.bsub(self.badd(p[0], p[0]), p[1]),
            self.badd(p[0], self.badd(p[1], p[1])),
        )

    def emul(self, x, y):
        a_, b_ = (x[0], x[1]), (x[2], x[3])
        c_, d_ = (y[0], y[1]), (y[2], y[3])
        ac = self._cmul(a_, c_)
        bd = self._cmul(b_, d_)
        ad = self._cmul(a_, d_)
        bc = self._cmul(b_, c_)
        rbd = self._cmul_r(bd)
        return (
            self.badd(ac[0], rbd[0]),
            self.badd(ac[1], rbd[1]),
            self.badd(ad[0], bc[0]),
            self.badd(ad[1], bc[1]),
        )

    def etree_sum(self, terms):
        """Balanced QM31 add tree (keeps scheduled depth logarithmic)."""
        terms = list(terms)
        while len(terms) > 1:
            nxt = [
                self.eadd(terms[i], terms[i + 1])
                for i in range(0, len(terms) - 1, 2)
            ]
            if len(terms) % 2:
                nxt.append(terms[-1])
            terms = nxt
        return terms[0]


def _is_src(x):
    return isinstance(x, tuple) and len(x) == 2 and x[0] in ("c", "r", "b")


# ---------------------------------------------------------------------------
# Scheduling + packing
# ---------------------------------------------------------------------------


@dataclass
class WidePlan:
    """A scheduled tape: (S, W) instruction grid + metadata."""

    opc: np.ndarray  # (S, W) int32: op*9 + sa*3 + sb  (NOP = add c0 c0)
    ia: np.ndarray  # (S, W) int32
    ib: np.ndarray  # (S, W) int32
    dst: np.ndarray  # (S, W) int32 (scratch register 0 for NOPs)
    n_regs: int
    out_regs: np.ndarray  # (n_out,) int32
    consts: np.ndarray  # (C,) uint32 with zeros at dynamic slots
    dyn_slots: list  # [(const_index, key)]
    used_bank: list  # [(kind, idx, offset)] in operand-index order
    n_instrs: int

    @property
    def n_steps(self):
        return int(self.opc.shape[0])

    @property
    def width(self):
        return int(self.opc.shape[1])

    def const_values(self, dyn_values) -> np.ndarray:
        """Fill dynamic slots from {key: int} -> runtime const vector."""
        c = self.consts.copy()
        for ix, key in self.dyn_slots:
            c[ix] = int(dyn_values[key]) % P
        return c


def schedule_wide(rec: WideRecorder, outputs, width: int = 32) -> WidePlan:
    """DCE + critical-path list scheduling into W-wide steps + register
    allocation with per-step-unique destinations."""
    outputs = list(outputs)
    # materialize const/bank outputs as copies so every output is an SSA reg
    outs = []
    for o in outputs:
        if o[0] == "r":
            outs.append(o)
        else:
            outs.append(rec.emit(_ADD, o, ("c", 0)))
            if outs[-1][0] != "r":  # folded (static const + 0)
                # force a copy via subtraction with itself trick is wrong;
                # emit unfoldable: add with dyn zero would change semantics.
                # Use a raw instruction append instead.
                dst = ("r", rec.n_ssa)
                rec.n_ssa += 1
                rec.instrs.append((_ADD, o, ("c", 0), dst[1]))
                outs[-1] = dst
    out_ssa = [o[1] for o in outs]

    # DCE
    live = set(out_ssa)
    keep = []
    for op, a, b, d in reversed(rec.instrs):
        if d in live:
            keep.append((op, a, b, d))
            if a[0] == "r":
                live.add(a[1])
            if b[0] == "r":
                live.add(b[1])
    instrs = keep[::-1]
    n = len(instrs)

    # dependency heights (critical path to outputs) for priority
    pos_of = {d: i for i, (_, _, _, d) in enumerate(instrs)}
    users: dict[int, list] = {}
    for i, (op, a, b, d) in enumerate(instrs):
        for s in (a, b):
            if s[0] == "r":
                users.setdefault(s[1], []).append(i)
    height = [0] * n
    for i in range(n - 1, -1, -1):
        d = instrs[i][3]
        h = 0
        for u in users.get(d, ()):
            h = max(h, height[u] + 1)
        height[i] = h

    # list scheduling: ready = all reg deps scheduled in an earlier step
    import heapq

    ndeps = [0] * n
    for i, (op, a, b, d) in enumerate(instrs):
        for s in (a, b):
            if s[0] == "r" and s[1] in pos_of:
                ndeps[i] += 1
    ready = [(-height[i], i) for i in range(n) if ndeps[i] == 0]
    heapq.heapify(ready)
    step_of = [0] * n
    steps: list[list[int]] = []
    pending: list[tuple] = []  # becomes ready next step
    while ready or pending:
        cur = []
        while ready and len(cur) < width:
            _, i = heapq.heappop(ready)
            cur.append(i)
        steps.append(cur)
        s = len(steps) - 1
        newly = []
        for i in cur:
            step_of[i] = s
            d = instrs[i][3]
            for u in users.get(d, ()):
                ndeps[u] -= 1
                if ndeps[u] == 0:
                    newly.append((-height[u], u))
        # leftovers in `ready` stay ready; newly-enabled join for next step
        for item in newly:
            heapq.heappush(ready, item)
    S = len(steps)

    # register allocation: register 0 = scratch; frees apply next step
    last_step_use: dict[int, int] = {}
    for i, (op, a, b, d) in enumerate(instrs):
        for s in (a, b):
            if s[0] == "r":
                last_step_use[s[1]] = max(
                    last_step_use.get(s[1], 0), step_of[i]
                )
    for ssa in out_ssa:
        last_step_use[ssa] = S  # alive to the end
    phys: dict[int, int] = {}
    free: list[int] = []
    next_reg = 1

    # bank compaction
    bank_map: dict[int, int] = {}
    used_bank: list = []

    def bank_ix(i):
        if i not in bank_map:
            bank_map[i] = len(used_bank)
            used_bank.append(rec.bank[i])
        return bank_map[i]

    def src_code(s):
        if s[0] == "r":
            return 0, phys[s[1]]
        if s[0] == "b":
            return 1, bank_ix(s[1])
        return 2, s[1]

    opc = np.zeros((S, width), np.int32)  # default: add c0 c0 -> NOP
    opc[:, :] = _ADD * 9 + 2 * 3 + 2
    ia = np.zeros((S, width), np.int32)
    ib = np.zeros((S, width), np.int32)
    dst = np.zeros((S, width), np.int32)  # scratch

    # values whose last use is in step s free their register before step s+1
    frees_after: dict[int, list] = {}
    for step_idx, bucket in enumerate(steps):
        for ssa, r in frees_after.pop(step_idx - 1, ()):  # noqa: B909
            free.append(r)
        for slot, i in enumerate(bucket):
            op, a, b, d = instrs[i]
            sa, va = src_code(a)
            sb, vb = src_code(b)
            r = free.pop() if free else next_reg
            if r == next_reg:
                next_reg += 1
            phys[d] = r
            ls = last_step_use.get(d, step_idx)
            if ls < S:
                frees_after.setdefault(ls, []).append((d, r))
            opc[step_idx, slot] = op * 9 + sa * 3 + sb
            ia[step_idx, slot] = va
            ib[step_idx, slot] = vb
            dst[step_idx, slot] = r

    out_regs = np.array([phys[s] for s in out_ssa], np.int32)
    consts = np.array(
        [0 if v is None else v for v in rec.consts], np.uint32
    )
    dyn_slots = sorted(rec.dyn_keys.items())
    return WidePlan(
        opc, ia, ib, dst, next_reg, out_regs, consts, dyn_slots, used_bank, n
    )


# ---------------------------------------------------------------------------
# Interpreter
# ---------------------------------------------------------------------------

# The shared-memory kernel: a block may use 232,448 bytes of dynamic shared
# memory of the SM's 233,472, and every resident block reserves 1,024 more.
_SMEM_BLOCK_BYTES = 232448
_SMEM_SM_BYTES = 233472
_SMEM_RESERVED = 1024
_SM_COUNT = 132
_BLOCKS_PER_SM = 32
_CHUNK = 32  # instructions the kernel fetches at a time (csrc/wtape.cu)
_BUNDLE = 4  # independent instructions the kernel runs together
_LANE_CHOICES = (64, 32)  # lanes per block (one warp, 2 or 1 lanes a thread)
# device budget for one launch's register-file scratch (R * tile * 4 bytes)
# of the global-scratch kernel
_SCRATCH_BYTES = 1 << 30


def _real_slots(plan: WidePlan):
    """(op, sa, sb, ia, ib, dst) of the plan's real slots in step order, NOP
    slots (``dst == 0``) dropped.  No slot reads a register written in its
    own step, so any order within a step, this one included, is valid."""
    keep = np.nonzero(plan.dst.reshape(-1) != 0)[0]
    opc = plan.opc.reshape(-1)[keep]
    return (opc // 9, (opc // 3) % 3, opc % 3, plan.ia.reshape(-1)[keep],
            plan.ib.reshape(-1)[keep], plan.dst.reshape(-1)[keep], keep)


def _plan_arrays(plan: WidePlan, n_bank: int, device, drop_nops: bool = False):
    """(instrs (N, 4) int32 = base op, ia, ib, dst with operands remapped
    to file indices — register r -> r, bank b -> R + b, const c -> R + B + c
    — and out_regs (n_out,) int32), cached on the plan per device.  All
    S * W slots in step order, or only the real ones with ``drop_nops``."""
    cache = plan.__dict__.setdefault("_dev_cache", {})
    key = (str(device), n_bank, drop_nops)
    hit = cache.get(key)
    if hit is None:
        R = plan.n_regs
        op, sa, sb, ia, ib, dst, keep = _real_slots(plan)
        if not drop_nops:
            flat = plan.opc.reshape(-1)
            op, sa, sb = flat // 9, (flat // 3) % 3, flat % 3
            ia, ib, dst = (x.reshape(-1) for x in (plan.ia, plan.ib, plan.dst))

        def remap(space, idx):
            out = idx.astype(np.int64).copy()
            out[space == 1] += R
            out[space == 2] += R + n_bank
            return out

        instrs = np.stack(
            [op, remap(sa, ia), remap(sb, ib), dst], axis=-1
        ).reshape(-1, 4).astype(np.int32)
        hit = (
            torch.from_numpy(instrs).to(device),
            torch.from_numpy(plan.out_regs.astype(np.int32)).to(device),
        )
        cache[key] = hit
    return hit


_OUT = 3  # kernel-only op: store register a as output row b
# flag bits of an encoded instruction (csrc/wtape.cu)
_F_A_CONST, _F_B_NO_LOAD, _F_OUT, _F_MUL, _F_SUB = 1, 2, 4, 8, 16


@dataclass
class KernelProgram:
    """A plan as the shared-memory kernel runs it: the plan's real
    instructions re-ordered into bundles of ``width`` independent
    instructions, with registers re-allocated for one thread per lane.  Register operands are register
    numbers, constant operands indices into the run-time constant vector;
    bank row ``b`` is preloaded into register ``bank_reg[b]``; op `_OUT`
    stores register ``a`` as output row ``b``."""

    op: np.ndarray  # (N,) 0 add, 1 sub, 2 mul, 3 out
    a: np.ndarray  # (N,) register number or constant index
    a_const: np.ndarray  # (N,) bool
    b: np.ndarray  # (N,) register number, constant index or output row
    b_const: np.ndarray
    dst: np.ndarray  # (N,) register number
    bank_reg: np.ndarray  # (B,) register of bank row b, -1 if never read
    n_regs: int
    n_out: int
    width: int  # instructions per bundle; len(op) is a multiple of it
    n_fill: int  # NOPs that fill short bundles, counted in len(op)

    def encode(self, lanes: int):
        """(instrs (padded, 4) int32, bank_off (B,) int32) for blocks of
        ``lanes`` lanes, in the layout of ``csrc/wtape.cu``: one flag bit
        per question the kernel asks, register operands as byte offsets
        premultiplied by ``lanes``, zero entries up
        to a whole number of chunks of `_CHUNK` and two chunks more (the
        kernel fetches two chunks ahead)."""
        is_out = self.op == _OUT
        x = (self.a_const * _F_A_CONST + (self.b_const | is_out) * _F_B_NO_LOAD
             + is_out * _F_OUT + (self.op == _MUL) * _F_MUL
             + (self.op == _SUB) * _F_SUB)
        word = 4 * lanes  # bytes between registers
        instrs = np.stack(
            [x, np.where(self.a_const, self.a, self.a * word),
             np.where(self.b_const | is_out, self.b, self.b * word),
             self.dst * word], axis=-1,
        ).reshape(-1, 4)
        pad = -len(instrs) % _CHUNK + 2 * _CHUNK
        instrs = np.concatenate([instrs, np.zeros((pad, 4), np.int64)])
        bank_off = np.where(self.bank_reg >= 0, self.bank_reg * word, -1)
        return instrs.astype(np.int32), bank_off.astype(np.int32)


def kernel_program(plan: WidePlan) -> KernelProgram:
    """Build (and cache on the plan) the `KernelProgram` of ``plan``.

    The plan's schedule keeps 32 slots a step busy and so keeps many
    values alive; one thread per lane has no use for that.  The values are
    recovered from the register grid (value ``b < B`` is bank row ``b``,
    value ``B + i`` the result of real slot ``i``) and ordered depth first
    from the outputs, the operand that needs more registers first
    (Sethi-Ullman).  A list scheduler then packs them, earliest in that
    order first, into bundles of `_BUNDLE` instructions that do not depend
    on each other (the thread overlaps their shared-memory loads); a bundle
    short of ready instructions is filled with NOPs, ``spare = spare +
    spare`` on a register that nothing else reads (no constant operand, so a
    plan without constants never makes the kernel look one up).
    Registers come from a linear scan over the bundles: all of a bundle's
    operands are read before any result is written, so a register is free
    again in the bundle of its value's last reader.  An output is stored
    (op `_OUT`) in a bundle after the one that computes it and holds no
    register afterwards.  The results are those of the plan whatever the
    order: only the register numbering changes."""
    hit = plan.__dict__.get("_kernel_program")
    if hit is None:
        with observe.span("plan_record", kind="kernel_program"):
            hit = plan.__dict__["_kernel_program"] = _build_kernel_program(plan)
    return hit


def _build_kernel_program(plan: WidePlan) -> KernelProgram:
    import heapq

    width = _BUNDLE

    B = len(plan.used_bank)
    op, sa, sb, ia, ib, dst, keep = _real_slots(plan)
    step = keep // plan.width
    n = len(op)
    # operands as (is_const, value id or constant index)
    holder: dict[int, int] = {}
    pending: list = []
    srcs = []
    for i in range(n):
        if i and step[i] != step[i - 1]:
            holder.update(pending)
            pending = []
        pair = []
        for space, idx in ((sa[i], ia[i]), (sb[i], ib[i])):
            idx = int(idx)
            if space == 0:
                if idx not in holder:
                    raise ValueError(f"plan reads register {idx} before it is written")
                pair.append((False, holder[idx]))
            elif space == 1:
                pair.append((False, idx))
            else:
                pair.append((True, idx))
        srcs.append(pair)
        pending.append((int(dst[i]), B + i))
    holder.update(pending)
    out_vals = [holder[int(r)] for r in plan.out_regs]
    if any(v < B for v in out_vals):
        raise ValueError("plan output is a bare bank row, not an instruction")

    def operands(v):
        return [x for c, x in srcs[v - B] if not c and x >= B]

    # registers a value's subtree needs (bank values are resident throughout)
    need = [1] * (B + n)
    for v in range(B, B + n):
        ns = sorted((need[c] for c in operands(v)), reverse=True)
        need[v] = max([1] + [x + k for k, x in enumerate(ns)])
    order, done = [], [False] * (B + n)
    for root in out_vals:
        stack = [(root, False)]
        while stack:
            v, expanded = stack.pop()
            if v < B or done[v]:
                continue
            if expanded:
                done[v] = True
                order.append(v)
                continue
            stack.append((v, True))
            # pushed in ascending need, so the neediest operand is visited first
            for c in sorted(operands(v), key=lambda c: need[c]):
                if not done[c]:
                    stack.append((c, False))

    # nodes: ("v", value) computes a value, ("o", k) stores output k; the
    # priority is the depth-first position, an output right after its value
    pos = {v: k for k, v in enumerate(order)}
    deps = {("v", v): set(operands(v)) for v in order}
    prio = {("v", v): (pos[v], 0) for v in order}
    for k, v in enumerate(out_vals):
        deps[("o", k)] = {v}
        prio[("o", k)] = (pos[v], 1 + k)
    waiting = {node: len(d) for node, d in deps.items()}
    users: dict[int, list] = {}
    for node, d in deps.items():
        for v in d:
            users.setdefault(v, []).append(node)
    ready = [(prio[node], node) for node, w in waiting.items() if w == 0]
    heapq.heapify(ready)
    bundles = []
    while ready:
        cur = [heapq.heappop(ready)[1] for _ in range(min(width, len(ready)))]
        bundles.append(cur)
        for kind, v in cur:
            if kind == "v":
                for node in users.get(v, ()):
                    waiting[node] -= 1
                    if waiting[node] == 0:
                        heapq.heappush(ready, (prio[node], node))

    def reads(node):
        if node[0] == "o":
            return [out_vals[node[1]]]
        return [x for c, x in srcs[node[1] - B] if not c]

    last_reader = {}
    for k, bundle in enumerate(bundles):
        for node in bundle:
            for x in reads(node):
                last_reader[x] = k
    reg = {}
    bank_reg = np.full(B, -1, np.int64)
    next_reg = 0
    for b in range(B):
        if b in last_reader:
            reg[b] = bank_reg[b] = next_reg
            next_reg += 1
    free: list = []
    spare = None  # destination of the NOPs
    n_fill = 0
    rows = []  # (op, a, a_const, b, b_const, dst)
    for k, bundle in enumerate(bundles):
        operand_regs = {x: reg[x] for node in bundle for x in reads(node)}
        for x in operand_regs:
            if last_reader[x] == k:
                heapq.heappush(free, reg.pop(x))
        for kind, v in bundle:
            if kind == "o":
                rows.append((_OUT, operand_regs[out_vals[v]], False, v, False, 0))
                continue
            (ac, ax), (bc, bx) = srcs[v - B]
            if free:
                r = heapq.heappop(free)
            else:
                r, next_reg = next_reg, next_reg + 1
            reg[v] = r
            rows.append((int(op[v - B]), ax if ac else operand_regs[ax], ac,
                         bx if bc else operand_regs[bx], bc, r))
        if len(bundle) < width:
            if spare is None:
                spare, next_reg = next_reg, next_reg + 1
            rows += [(_ADD, spare, False, spare, False, spare)] * (width - len(bundle))
            n_fill += width - len(bundle)
    cols = list(zip(*rows)) if rows else [[]] * 6
    arr = [np.asarray(c, np.int64) for c in cols]
    return KernelProgram(
        op=arr[0], a=arr[1], a_const=arr[2].astype(bool), b=arr[3],
        b_const=arr[4].astype(bool), dst=arr[5],
        bank_reg=bank_reg, n_regs=max(1, next_reg), n_out=len(out_vals),
        width=width, n_fill=n_fill,
    )


def smem_bytes(n_regs: int, lanes: int) -> int:
    """Dynamic shared memory of a block of ``lanes`` lanes: two instruction
    chunks and the register file."""
    return (2 * _CHUNK * 4 + n_regs * lanes) * 4


def pick_lanes(n_regs: int, n: int):
    """Lanes per block (one warp, ``lanes / 32`` lanes a thread) for the
    shared-memory kernel, or None if the register file does not fit a block
    even at 32 lanes.  32 lanes give the most warps for the shared memory
    and spread a short domain over the most SMs.  64 only where an SM's cap
    of 32 resident blocks, not its shared memory, limits the 32-lane block
    (files of up to 41 registers) and the domain is longer than the card
    holds at once under that cap: two lanes a thread then double the lanes
    in flight (measured on an H100 by ``chip_smoke.py --kernels``: 64 lanes
    win there by 4 to 18%, and lose everywhere else)."""
    smem = smem_bytes(n_regs, 32)
    if smem > _SMEM_BLOCK_BYTES:
        return None
    capped = _SMEM_SM_BYTES // (smem + _SMEM_RESERVED) >= _BLOCKS_PER_SM
    return 64 if capped and n > _SM_COUNT * _BLOCKS_PER_SM * 32 else 32


def run_plan_plain(rows, consts, instrs, out_regs, n_regs: int, width: int):
    """Plain torch interpreter of a plan (`_plan_arrays` form): one (W, n)
    gather + op + scatter per scheduled step of ``width`` slots."""
    n = int(rows.shape[1])
    file = torch.cat([
        rows.new_zeros((n_regs, n)),
        rows,
        consts[:, None].expand(-1, n),
    ])
    ins = instrs.long()
    for s in range(0, ins.shape[0], width):
        step = ins[s : s + width]
        va = file.index_select(0, step[:, 1])
        vb = file.index_select(0, step[:, 2])
        op = step[:, 0][:, None]
        vbn = torch.where(op == 1, m31.neg(vb), vb)
        out = torch.where(op == 2, m31.mul(va, vb), m31.add(va, vbn))
        file.index_copy_(0, step[:, 3], out)
    return file.index_select(0, out_regs.long())


def _launch_shape(plan: WidePlan, n: int):
    return (plan.n_steps, plan.n_regs, len(plan.used_bank),
            len(plan.out_regs), n)


def _run_plan_smem(rows, consts, plan: WidePlan, prog: KernelProgram, lanes: int):
    B, n = int(rows.shape[0]), int(rows.shape[1])
    device = rows.device
    cache = plan.__dict__.setdefault("_dev_cache", {})
    key = (str(device), "smem", lanes)
    hit = cache.get(key)
    if hit is None:
        hit = cache[key] = tuple(
            torch.from_numpy(x).to(device) for x in prog.encode(lanes))
    instrs, bank_off = hit
    out = torch.empty((prog.n_out, n), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        err = kernels.lib().cm_wtape_run(
            rows.data_ptr(), consts.data_ptr(), instrs.data_ptr(),
            bank_off.data_ptr(), out.data_ptr(), len(prog.op),
            prog.n_regs, B, n, lanes,
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "wtape_run_plan")
    kernels.count("wtape_run_plan", _launch_shape(plan, n))
    return out


def _run_plan_global(rows, consts, plan: WidePlan):
    B, n = int(rows.shape[0]), int(rows.shape[1])
    device = rows.device
    instrs, out_regs = _plan_arrays(plan, B, device, drop_nops=True)
    R = plan.n_regs
    n_out = int(out_regs.shape[0])
    out = torch.empty((n_out, n), dtype=torch.int64, device=device)
    tile = n
    while tile > 1024 and R * tile * 4 > _SCRATCH_BYTES:
        tile //= 2
    scratch = torch.empty((R, tile), dtype=torch.int32, device=device)
    lib = kernels.lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for lane0 in range(0, n, tile):
            err = lib.cm_wtape_run_global(
                rows.data_ptr(), consts.data_ptr(), instrs.data_ptr(),
                out_regs.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                int(instrs.shape[0]), R, B, n_out, n, lane0, min(tile, n - lane0),
                stream,
            )
            kernels.check(err, "wtape_run_plan_global")
            kernels.count("wtape_run_plan_global", _launch_shape(plan, n))
    return out


def run_plan(rows, const_vals, plan: WidePlan, variant: str | None = None):
    """Execute a WidePlan over prepared (B, n) row-order int64 bank rows.

    ``const_vals``: the plan's runtime constant vector.  Returns (n_out, n)
    int64.  CPU tensors take `run_plan_plain`.  CUDA tensors launch a kernel
    of ``csrc/wtape.cu`` (the kernels allocate nothing: the output and the
    scratch come from here): the shared-memory kernel when the
    `kernel_program`'s register file fits a block (`pick_lanes`), else the
    global-scratch kernel.  The choice is this rule on the register count
    alone; ``variant`` ("smem" or "global") overrides it so that a test can
    hold either kernel to the plain version on any plan.  A launch that
    fails raises: neither kernel stands in for the other."""
    if rows.dim() != 2 or rows.dtype != torch.int64 or not rows.is_contiguous():
        raise ValueError(f"run_plan wants contiguous 2-D int64 rows, got "
                         f"{tuple(rows.shape)} {rows.dtype}")
    B, n = int(rows.shape[0]), int(rows.shape[1])
    if B != len(plan.used_bank):
        raise ValueError(f"run_plan: {B} bank rows for a plan of {len(plan.used_bank)}")
    device = rows.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"run_plan: unsupported device {device}")
    if variant not in (None, "smem", "global"):
        raise ValueError(f"run_plan: unknown variant {variant!r}")
    if isinstance(const_vals, torch.Tensor):  # already where the rows are
        consts = const_vals.to(device=device, dtype=torch.int64)
    else:
        consts = observe.push(np.asarray(const_vals, np.int64), device)
    if device.type == "cpu":
        instrs, out_regs = _plan_arrays(plan, B, device)
        return run_plan_plain(rows, consts, instrs, out_regs, plan.n_regs,
                              plan.width)
    if variant != "global":
        prog = kernel_program(plan)
        lanes = pick_lanes(prog.n_regs, n)
        if lanes is not None:
            return _run_plan_smem(rows, consts, plan, prog, lanes)
        if variant == "smem":
            raise ValueError(
                f"run_plan: {prog.n_regs} registers do not fit shared memory")
    return _run_plan_global(rows, consts, plan)


# values of the bank rows `run_wide` gathers at a time
_GATHER_VALUES = 1 << 26


def run_wide(stacks, src, sh, const_vals, plan: WidePlan, elog: int,
             fft_order: bool = True):
    """Execute a scheduled plan over (K, 2^elog) device column stacks.

    ``src``/``sh``: (B,) bank source rows into the stack concatenation and
    row shifts; ``const_vals``: runtime const vector (dynamic slots filled).
    Returns (n_out, n) row-order int64 limbs (n_out = len(plan.out_regs)).

    Bank prep: each used row is gathered from its own stack (never
    concatenating whole stacks), then one index gather per distinct shift
    applies the fft->row reorder and the circular shift together: row j's
    lane i holds the row-order value at position (i + sh[j]) mod n.
    """
    from . import domain

    n = 1 << elog
    B = len(src)
    assert len(src) == len(plan.used_bank), (len(src), len(plan.used_bank))
    assert len(sh) == len(plan.used_bank)
    src = np.asarray(src, np.int64)
    shifts = np.asarray(sh, np.int64) % n
    if sharded.active_mesh() is not None:
        if not fft_order:
            raise ValueError("run_wide: under a row mesh stacks are in FFT order")
        if sharded.is_share(stacks[0], elog):
            return _run_wide_share(stacks, src, shifts, const_vals, plan, n)
    sizes = [int(s.shape[0]) for s in stacks]
    bounds = np.cumsum([0] + sizes)
    device = stacks[0].device
    rows = torch.empty((B, n), dtype=torch.int64, device=device)
    pos = np.arange(n, dtype=np.int64)
    perm = domain.to_fft_order(pos) if fft_order else pos
    # row-order position p lives at fft position inv[p]
    inv = np.empty(n, np.int64)
    inv[perm] = pos
    # the gathers' temporaries hold a block of rows, not the bank
    step = max(1, _GATHER_VALUES // n)
    for v in np.unique(shifts):
        lane_src = observe.push(inv[(pos + int(v)) % n], device)
        for j, s in enumerate(stacks):
            sel = np.nonzero(
                (shifts == v) & (src >= bounds[j]) & (src < bounds[j + 1])
            )[0]
            if sel.size == 0:
                continue
            r = observe.push(src[sel] - bounds[j], device)
            dst = observe.push(sel, device)
            for a in range(0, sel.size, step):
                rows[dst[a : a + step]] = (
                    s.index_select(0, r[a : a + step]).index_select(1, lane_src)
                )
    out = run_plan(rows, const_vals, plan)
    if sharded.active_mesh() is not None:
        # every rank computed the whole (small) domain; under a mesh the
        # outputs are FFT order, as those of a split domain are
        out = domain.to_fft_order(out)
    return out


def _run_wide_share(stacks, src, shifts, const_vals, plan: WidePlan, n: int):
    """`run_wide` on cyclic FFT-order shares of a row mesh
    (parallel/sharded.py): this rank's lanes are its FFT indices, so the
    outputs come out as this rank's share of the FFT-order outputs.  A bank
    row of shift 0 is local; the rows of each other shift are fetched from
    their owners in one routed all-to-all (`sharded.shift_rows`)."""
    sizes = [int(s.shape[0]) for s in stacks]
    bounds = np.cumsum([0] + sizes)
    device = stacks[0].device
    nl = int(stacks[0].shape[-1])
    rows = torch.empty((len(src), nl), dtype=torch.int64, device=device)
    for v in np.unique(shifts):
        sels, parts = [], []
        for j, s in enumerate(stacks):
            sel = np.nonzero(
                (shifts == v) & (src >= bounds[j]) & (src < bounds[j + 1])
            )[0]
            if sel.size == 0:
                continue
            r = observe.push(src[sel] - bounds[j], device)
            sels.append(sel)
            parts.append(s.index_select(0, r))
        part = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        if v:
            part = sharded.shift_rows(part, n, int(v))
        rows[observe.push(np.concatenate(sels), device)] = part
    return run_plan(rows, const_vals, plan)


def _bucket(x: int, floor: int = 16) -> int:
    """Round to powers of two to maximize kernel reuse."""
    return max(floor, 1 << (max(1, x) - 1).bit_length())
