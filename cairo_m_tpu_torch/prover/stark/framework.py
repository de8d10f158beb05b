"""Runs components through the three evaluation modes.

- `gen_interaction_trace`: LogUp interaction columns + claimed sum (host,
  vectorized NumPy over trace rows).
- `compute_composition`: the random-linear-combination quotient polynomial
  over the extended domain (device).
- `evaluate_at_point`: the same combination at the OODS point from sampled
  mask values (host scalars) — the verifier's composition check.
- `assert_constraints`: raw-trace constraint evaluation pinpointing failing
  (component, constraint, row) — the host debug tool behind
  `prover/debug_tools.py`.

Counterpart of ``cairo_m_tpu.prover.stark.framework`` on torch tensors;
the plans are recorded by the same host code, so they are identical.

Composition convention (prover & verifier): with global random coeff
``alpha`` and components in commitment order,

  composition = sum_c alpha^{after_c} * V_c^{-1} * sum_k alpha^{n_c-1-k} C_{c,k}

where ``after_c`` = number of constraints of all later components and V_c
the vanishing polynomial of c's trace domain.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...field import m31
from ...field.qm31 import qinv, qinv_np, qmul, qmul_np
from ...parallel import sharded
from . import domain, fft
from .air import (
    Component,
    EvalAtRow,
    HostArrayOps,
    Val,
    logup_shift_scalar,
)
from .fri import QONE, QZERO, qscalar_add, qscalar_mul

P = (1 << 31) - 1


# ---------------------------------------------------------------------------
# Interaction trace generation (host, vectorized)
# ---------------------------------------------------------------------------


def _entries_host(component, trace_rows, preprocessed_rows=()):
    """Run evaluate() in NumPy-array mode to collect relation entries."""
    n = 1 << component.log_size

    def trace_getter(idx, offset):
        col = trace_rows[idx]
        # offset -1 = previous row = roll forward by +1
        return Val(np.roll(col, -offset) if offset else col, False, HostArrayOps)

    def pp_getter(idx, offset):
        return Val(preprocessed_rows[idx], False, HostArrayOps)

    def interaction_getter(idx, offset):
        z = np.zeros(n, dtype=np.uint32)
        return Val((z, z, z, z), True, HostArrayOps)

    shift = Val(
        tuple(np.zeros(n, dtype=np.uint32) for _ in range(4)), True, HostArrayOps
    )
    ev = EvalAtRow(HostArrayOps, trace_getter, interaction_getter, shift, pp_getter)
    ev.collect_only = True
    component.evaluate(ev)
    return ev.relation_entries


def gen_interaction_trace(component: Component, trace_rows, preprocessed_rows=()):
    """-> (interaction QM31 columns [n_pairs][4] np arrays row order,
           claimed_sum QM31 tuple)."""
    entries = _entries_host(component, trace_rows, preprocessed_rows)
    n = 1 << component.log_size
    # numerators (QM31 arrays) and denominators per entry
    numers, denoms = [], []
    for e in entries:
        mv = e.multiplicity.as_ext().v
        numers.append(tuple(np.broadcast_to(np.asarray(x), (n,)).copy() for x in mv))
        d = e.relation.combine(e.values).v
        denoms.append(tuple(np.broadcast_to(np.asarray(x), (n,)).copy() for x in d))
    inv_denoms = [qinv_np(d) for d in denoms]
    # per-pair fractions
    n_pairs = (len(entries) + 1) // 2
    fracs = []
    for k in range(n_pairs):
        if 2 * k + 1 < len(entries):
            t0 = qmul_np(numers[2 * k], inv_denoms[2 * k])
            t1 = qmul_np(numers[2 * k + 1], inv_denoms[2 * k + 1])
            fracs.append(tuple(m31.add_np(a, b) for a, b in zip(t0, t1)))
        else:
            fracs.append(qmul_np(numers[2 * k], inv_denoms[2 * k]))
    # claimed sum = total of all fractions over all rows
    total = QZERO
    for f in fracs:
        total = qscalar_add(total, tuple(int(np.sum(x.astype(np.uint64)) % P) for x in f))
    # columns: within-row prefix sums; last column cumulative over rows
    cols = []
    running = None
    for k in range(n_pairs - 1):
        running = fracs[k] if running is None else tuple(
            m31.add_np(a, b) for a, b in zip(running, fracs[k])
        )
        cols.append(running)
    row_total = fracs[-1] if running is None else tuple(
        m31.add_np(a, b) for a, b in zip(running, fracs[-1])
    )
    shift = logup_shift_scalar(total, component.log_size)
    shifted = tuple(
        m31.sub_np(x, np.uint32(s)) for x, s in zip(row_total, shift)
    )
    last_col = tuple(_cumsum_mod(x) for x in shifted)
    cols.append(last_col)
    return cols, total


def _cumsum_mod(x: np.ndarray) -> np.ndarray:
    # values < 2^31, n <= 2^24 -> sum < 2^55 fits in uint64
    return (np.cumsum(x, dtype=np.uint64) % P).astype(np.uint32)


# ---------------------------------------------------------------------------
# Interaction trace generation (device, wide-tape-compiled)
# ---------------------------------------------------------------------------
# The host path above is kept as the golden reference; the prover uses this
# device path: entry numerators/denominators evaluate via the wide tape
# interpreter (stark/wtape.py) on the base domain, then batched QM31
# inversion, pair fractions, within-row prefix columns and the shifted
# row-cumulative last column.  The prefix sums are exact: int64 cumsum of
# values < 2^31 over < 2^32 terms, then % P.  Tapes are
# recorded once per (component, log_size): per-proof relation parameters
# enter as *dynamic constants*.

from .wtape import WideOps, WideRecorder, run_wide, schedule_wide

_WIDE_W = 32  # instruction slots per scheduled step

_PLAN_CACHE: dict = {}


def _record_with_dyn_relations(relations, build):
    """Record with every relation's (z, alpha_powers) replaced by dynamic
    const slots, so the resulting plan is proof-independent."""
    rec = WideRecorder()
    ops = WideOps(rec)
    saved = [(r, r.z, r.alpha_powers) for r in relations.all()]
    for r in relations.all():
        r.z = tuple(rec.dyn_const(("relz", r.name, k)) for k in range(4))
        r.alpha_powers = [
            tuple(rec.dyn_const(("rela", r.name, j, k)) for k in range(4))
            for j in range(r.arity)
        ]
    try:
        outputs = build(rec, ops)
    finally:
        for r, z, ap in saved:
            r.z, r.alpha_powers = z, ap
    return schedule_wide(rec, outputs, width=_WIDE_W)


class _DynResolver:
    """dict-like: resolves dynamic-const keys to per-proof values."""

    def __init__(self, relations, shift=None, apows=None):
        self.rel = {r.name: r for r in relations.all()}
        self.shift = shift
        self.apows = apows  # list of QM31 tuples, index = exponent

    def __getitem__(self, key):
        tag = key[0]
        if tag == "relz":
            return self.rel[key[1]].z[key[2]]
        if tag == "rela":
            return self.rel[key[1]].alpha_powers[key[2]][key[3]]
        if tag == "shift":
            return self.shift[key[1]]
        if tag == "apow":
            return self.apows[key[1]][key[2]]
        raise KeyError(key)


def interaction_plan(comp, relations):
    """Cached wide plan computing, per relation entry: numerator limbs 0-3
    then denominator limbs 0-3 (8 outputs per entry)."""
    from ...prover.config import SCALE

    key = ("interaction", comp.name, comp.log_size, SCALE.key(),
           getattr(comp, "plan_key_extra", ""))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit

    def build(rec, ops):
        def tg(idx, offset):
            return Val(rec.bank_src("t", idx, offset), False, ops)

        def pg(idx, offset):
            return Val(rec.bank_src("p", idx, offset), False, ops)

        def ig(idx, offset):  # pragma: no cover - collect_only skips finalize
            raise AssertionError("interaction columns unavailable while recording")

        shift = Val(ops.econst((0, 0, 0, 0)), True, ops)
        ev = EvalAtRow(ops, tg, ig, shift, pg)
        ev.collect_only = True
        comp.evaluate(ev)
        outs = []
        for e in ev.relation_entries:
            outs += list(e.multiplicity.as_ext().v)
            outs += list(e.relation.combine(e.values).v)
        n_e = len(ev.relation_entries)
        # pad the entry count to a power of two with 0/1 fractions so the
        # logup kernels bucket by shape (the extra zero fractions change no
        # committed column: prefix sums are sliced to the true pair count)
        from .wtape import _bucket

        for _ in range(_bucket(n_e, 2) - n_e):
            outs += [ops.bconst(0)] * 4 + [ops.bconst(1)] + [ops.bconst(0)] * 3
        return outs, n_e

    n_entries_box = []

    def build2(rec, ops):
        outs, n_e = build(rec, ops)
        n_entries_box.append(n_e)
        return outs

    plan = _record_with_dyn_relations(relations, build2)
    result = (plan, n_entries_box[0])
    _PLAN_CACHE[key] = result
    return result


def _logup_prefix(outs, E: int, n: int):
    """(8E, n) entry numer/denom rows -> (ceil(E/2), 4, n) within-row
    prefix sums of the pair fractions."""
    x = outs.reshape(E, 2, 4, n)
    numer = tuple(x[:, 0, k, :] for k in range(4))
    denom = tuple(x[:, 1, k, :] for k in range(4))
    fr = torch.stack(qmul(numer, qinv(denom)), dim=1)  # (E, 4, n)
    if E % 2:
        fr = torch.cat([fr, fr.new_zeros((1, 4, n))], dim=0)
    pairs = m31.add(fr[0::2], fr[1::2])
    return torch.cumsum(pairs, dim=0) % P


def _logup_last(row_total, log_size: int):
    """(4, n) row totals -> (shifted cumulative last column (4, n),
    claimed sum (4,)).

    Under a row mesh the row totals are in FFT order (parallel/sharded.py):
    a cyclic share sums to the global total with `psum_mod` and takes its
    prefix sums along the rows with `row_cumsum_mod`; a whole domain goes
    to row order and back."""
    n = 1 << log_size
    inv2n = pow(n, P - 2, P)
    total = m31.sum_mod(row_total, dim=1)
    mesh = sharded.active_mesh()
    share = sharded.is_share(row_total, log_size)
    if share:
        total = sharded.psum_mod(total)
    shift = m31.mul(total, inv2n)
    shifted = m31.sub(row_total, shift[:, None])
    if share:
        return sharded.row_cumsum_mod(shifted, n), total
    if mesh is not None:
        rows = torch.cumsum(domain.from_fft_order(shifted), dim=1) % P
        return domain.to_fft_order(rows), total
    return torch.cumsum(shifted, dim=1) % P, total


def gen_interaction_trace_device(comp, trace_stack, pre_stack):
    """Device path of gen_interaction_trace.

    ``trace_stack``/``pre_stack``: (k, 2^log_size) int64 device stacks of
    the component's trace / preprocessed rows (row order; FFT order, and
    this rank's share where the domain is split, under a row mesh).
    -> (stacked interaction limb columns (4*n_pairs, n) device, in the
        stacks' order,
        claimed_sum (4,) device tensor — NOT pulled to host here, so callers
        can batch all components' sums into one transfer).
    """
    l = comp.log_size
    n = 1 << l
    plan, E = interaction_plan(comp, comp.relations)
    Epad = len(plan.out_regs) // 8
    kt = int(trace_stack.shape[0])
    src = np.zeros(len(plan.used_bank), np.int64)
    sh = np.zeros(len(plan.used_bank), np.int64)
    for j, (kind, idx, off) in enumerate(plan.used_bank):
        src[j] = idx if kind == "t" else kt + idx
        sh[j] = off % n
    consts = plan.const_values(_DynResolver(comp.relations))
    outs = run_wide(
        (trace_stack, pre_stack), src, sh, consts, plan, l,
        fft_order=sharded.active_mesh() is not None,
    )
    nl = int(outs.shape[-1])
    prefix = _logup_prefix(outs, Epad, nl)
    n_pairs = (E + 1) // 2
    last, total = _logup_last(prefix[n_pairs - 1], l)
    # stacked interaction limb columns: pair0 limb0-3, pair1 limb0-3, ...
    stacked = torch.cat(
        [prefix[: n_pairs - 1].reshape((n_pairs - 1) * 4, nl), last], dim=0
    )
    return stacked, total


# ---------------------------------------------------------------------------
# Device-side table multiplicity counting
# ---------------------------------------------------------------------------
# The rayon-atomics role of the reference's range-check/bitwise counting
# (`preprocessed/range_check/range_check_macro.rs:72-84`) mapped to TPU as
# one-hot scatter-adds (SURVEY.md §2.10): every component's table-relation
# entries are extracted by a wide-tape plan from its already-uploaded trace
# stack and histogrammed into device accumulators, replacing the host
# re-derivation + np.add.at pass that serialized the trace phase.

_TCOUNT_TABLES = ("RangeCheck8", "RangeCheck16", "RangeCheck20", "Bitwise")


def table_count_plan(comp, relations):
    """Cached wide plan extracting, per table-relation entry of ``comp``:
    the multiplicity (limb 0), then the index values (1 for range checks,
    op/in1/in2 for bitwise).  -> (plan, meta) with meta the table name per
    entry in output order (empty if the component consumes no table)."""
    from ...prover.config import SCALE

    key = ("tcount", comp.name, comp.log_size, SCALE.key(),
           getattr(comp, "plan_key_extra", ""))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit

    meta_box = []

    def build(rec, ops):
        def tg(idx, offset):
            return Val(rec.bank_src("t", idx, offset), False, ops)

        def pg(idx, offset):
            return Val(rec.bank_src("p", idx, offset), False, ops)

        def ig(idx, offset):  # pragma: no cover - collect_only skips finalize
            raise AssertionError("interaction columns unavailable while recording")

        shift = Val(ops.econst((0, 0, 0, 0)), True, ops)
        ev = EvalAtRow(ops, tg, ig, shift, pg)
        ev.collect_only = True
        comp.evaluate(ev)
        outs, meta = [], []
        for e in ev.relation_entries:
            nm = e.relation.name
            if nm not in _TCOUNT_TABLES:
                continue
            outs.append(e.multiplicity.as_ext().v[0])
            n_vals = 3 if nm == "Bitwise" else 1
            for v in e.values[:n_vals]:
                outs.append(v.v if not v.ext else v.v[0])
            meta.append(nm)
        meta_box.append(tuple(meta))
        return outs

    if not _touches_tables(comp):
        result = (None, ())
    else:
        # plain recording — no relation z/alpha dyn consts: entries are
        # collected raw (no combine), so the plan has no per-proof
        # constants and can run before relations.draw
        rec = WideRecorder()
        ops = WideOps(rec)
        outs = build(rec, ops)
        plan = schedule_wide(rec, outs, width=_WIDE_W)
        result = (plan, meta_box[0])
    _PLAN_CACHE[key] = result
    return result


def _touches_tables(comp) -> bool:
    from ..components.registry import _touched_relations

    return bool(_touched_relations(comp) & set(_TCOUNT_TABLES))


def _tcount(meta, outs, accs):
    """Scatter-add one component's table consumptions into the accumulators
    (``_TCOUNT_TABLES`` order).  Weights are the consumptions ``-mult``
    (padding rows have mult 0 and contribute 0); index values outside a
    table (possible only on zero-weight padding rows) are masked to a
    zero-weight add at index 0, as the reference's scatter drops them."""
    per = {nm: ([], []) for nm in _TCOUNT_TABLES}
    off = 0
    for nm in meta:
        w = m31.neg(outs[off])
        if nm == "Bitwise":
            idx = (outs[off + 1] << 16) + (outs[off + 2] << 8) + outs[off + 3]
            off += 4
        else:
            idx = outs[off + 1]
            off += 2
        per[nm][0].append(idx)
        per[nm][1].append(w)
    for ti, nm in enumerate(_TCOUNT_TABLES):
        idxs, ws = per[nm]
        if not idxs:
            continue
        idx = torch.cat(idxs)
        w = torch.cat(ws)
        valid = (idx >= 0) & (idx < accs[ti].shape[0])
        accs[ti].index_add_(
            0, torch.where(valid, idx, 0), torch.where(valid, w, 0)
        )


class TableCounter:
    """Device accumulators for the four preprocessed tables' multiplicity
    columns, in int64: `finalize` checks that every count stays below P, so
    a count can never wrap silently."""

    def __init__(self, relations, rc_big_bits: int, bitwise_log: int, device):
        self.relations = relations
        self._logs = (8, 16, rc_big_bits, bitwise_log)
        self.acc = [
            torch.zeros(1 << b, dtype=torch.int64, device=device)
            for b in self._logs
        ]
        self.touched = [False] * 4

    def add(self, comp, trace_stack):
        """Fold one non-zero-witness component's table consumptions in.

        Under a row mesh each rank counts its share of the lanes (FFT
        order); a domain every rank holds whole is counted by rank 0."""
        plan, meta = table_count_plan(comp, self.relations)
        if not meta:
            return
        mesh = sharded.active_mesh()
        if (mesh is not None and mesh.rank
                and not sharded.is_share(trace_stack, comp.log_size)):
            for nm in set(meta):
                self.touched[_TCOUNT_TABLES.index(nm)] = True
            return
        for nm in set(meta):
            self.touched[_TCOUNT_TABLES.index(nm)] = True
        n = 1 << comp.log_size
        assert not comp.n_preprocessed_cols, comp.name
        pre_stack = trace_stack.new_zeros((0, trace_stack.shape[-1]))
        src = np.zeros(len(plan.used_bank), np.int64)
        sh = np.zeros(len(plan.used_bank), np.int64)
        kt = int(trace_stack.shape[0])
        for j, (kind, idx, off) in enumerate(plan.used_bank):
            src[j] = idx if kind == "t" else kt + idx
            sh[j] = off % n
        consts = plan.const_values(_DynResolver(self.relations))
        outs = run_wide(
            (trace_stack, pre_stack), src, sh, consts, plan,
            comp.log_size, fft_order=mesh is not None,
        )
        _tcount(meta, outs, self.acc)

    def finalize(self):
        """-> (mult column per table (device, (n,) int64), touched flags).

        Under a row mesh the ranks' histograms are summed first (one
        all-reduce each) and each column is returned as the uploads are: in
        FFT order, this rank's share where the domain is split."""
        acc = self.acc
        if sharded.active_mesh() is not None:
            acc = [sharded.psum(a) for a in acc]
        for a in acc:
            if int(a.max()) >= P:
                raise OverflowError("table multiplicity count reached P")
        if sharded.active_mesh() is not None:
            acc = [sharded.maybe_shard(domain.to_fft_order(a)).contiguous()
                   for a in acc]
        return tuple(acc), tuple(self.touched)


# ---------------------------------------------------------------------------
# Composition (device, wide-tape-compiled)
# ---------------------------------------------------------------------------
# Each component's constraints are *recorded* once per (component,
# log_size) into a wide-scheduled instruction plan executed by the generic
# interpreter (stark/wtape.py).  The constraints are combined as the weighted sum
# sum_k alpha^{n-1-k} * C_k (== the verifier's Horner chain) with the alpha
# powers as dynamic constants and a *balanced add tree*, keeping the
# schedulable depth logarithmic instead of serial in #constraints.

_COUNT_CACHE: dict = {}


def count_constraints(comp) -> int:
    # comp.name (not just the class) — all opcode components share one class
    from ...prover.config import SCALE

    key = (type(comp).__name__, comp.name, comp.log_size, SCALE.key(),
           getattr(comp, "plan_key_extra", ""))
    if key in _COUNT_CACHE:
        return _COUNT_CACHE[key]
    rel = comp.relations
    saved = {r.name: (r.z, r.alpha_powers) for r in rel.all()}
    for r in rel.all():
        r.z = (0, 0, 0, 0)
        r.alpha_powers = [(1, 0, 0, 0)] * r.arity
    try:
        z1 = np.zeros(1, np.uint32)
        ev = EvalAtRow(
            HostArrayOps,
            lambda i, o: Val(z1, False, HostArrayOps),
            lambda i, o: Val((z1, z1, z1, z1), True, HostArrayOps),
            Val((z1, z1, z1, z1), True, HostArrayOps),
            lambda i, o: Val(z1, False, HostArrayOps),
        )
        comp.evaluate(ev)
        n = len(ev.constraints)
    finally:
        for r in rel.all():
            r.z, r.alpha_powers = saved[r.name]
    _COUNT_CACHE[key] = n
    return n


def composition_plan(comp, relations):
    """Cached wide plan: comp.evaluate() + weighted constraint combination
    + the vanishing division.  Bank kinds: 't' trace, 'i' interaction limb,
    'p' preprocessed, 'v' vanishing-inverse row.  Per-proof scalars (drawn
    relation parameters, logup shift, alpha powers) are dynamic consts."""
    from ...prover.config import SCALE

    key = ("composition", comp.name, comp.log_size, SCALE.key(),
           getattr(comp, "plan_key_extra", ""))
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit

    def build(rec, ops):
        def tg(idx, offset):
            return Val(rec.bank_src("t", idx, offset), False, ops)

        def ig(idx, offset):
            return Val(
                tuple(rec.bank_src("i", 4 * idx + k, offset) for k in range(4)),
                True,
                ops,
            )

        def pg(idx, offset):
            return Val(rec.bank_src("p", idx, offset), False, ops)

        shift = Val(
            tuple(rec.dyn_const(("shift", k)) for k in range(4)), True, ops
        )
        ev = EvalAtRow(ops, tg, ig, shift, pg)
        comp.evaluate(ev)
        ncon = len(ev.constraints)
        terms = []
        for k, c in enumerate(ev.constraints):
            w = tuple(rec.dyn_const(("apow", ncon - 1 - k, j)) for j in range(4))
            terms.append(ops.emul(c.as_ext().v, w))
        acc = ops.etree_sum(terms)
        vinv = rec.bank_src("v", 0, 0)
        return list(ops.emul_b(acc, vinv))

    plan = _record_with_dyn_relations(relations, build)
    _PLAN_CACHE[key] = plan
    return plan


def _evals_to_coeffs(evals, elog: int, max_elog: int):
    """Row-order 4-limb evaluations on the 2^elog domain -> coefficients
    embedded in the 2^max_elog basis, as one (4, n) batched transform.
    Under a row mesh the evaluations are already in FFT order."""
    stacked = torch.stack(evals)
    if sharded.active_mesh() is None:
        stacked = domain.to_fft_order(stacked)
    co = fft.embed_coeffs(fft.ifft(stacked, elog), elog, max_elog)
    return tuple(co[k] for k in range(4))


@lru_cache(maxsize=None)
def _vanishing_row(l: int, elog: int, device: torch.device):
    _, vinv = domain.vanishing_on_domain(l, elog)
    return torch.from_numpy(domain.to_fft_order(vinv)[None].astype(np.int64)).to(device)


def compute_composition(
    components, relations, pre_phase, trace_phase, inter_phase,
    pre_owner_map, claimed_sums, random_coeff, blowup=1, observer=None,
):
    """-> (composition 4-limb tuple in fft order, log size max+blowup).

    The three phases are `pcs.CommitmentPhase` objects whose FFT-order
    extended column stacks (``stacked_ext``, computed once during commit)
    are reused directly — no per-component LDE.  ``pre_owner_map``:
    ``{id(comp): (global pre column start, count)}``.  ``observer``: see
    `prove.prove_cairo_m`; ``end`` gets each live component's weighted
    contribution.
    """
    counts = [count_constraints(c) for c in components]
    max_elog = max(c.log_size for c in components) + blowup
    # alpha powers 0..max(counts)-1 for the in-component weighted sums
    apows = [QONE]
    for _ in range(max(counts)):
        apows.append(qscalar_mul(apows[-1], random_coeff))
    ti = ii = 0
    by_elog: dict = {}
    for i, comp in enumerate(components):
        l = comp.log_size
        elog = l + blowup
        n = 1 << elog
        if comp.zero_witness:
            # every constraint is enabler-guarded or a product of (all-zero)
            # trace columns, and the interaction columns + claimed sum are 0
            # -> the component's composition contribution is identically 0.
            ti += comp.n_trace_cols
            ii += 4 * comp.n_interaction_cols()
            continue
        if observer is not None:
            observer.begin("composition", comp)
        plan = composition_plan(comp, relations)
        consts = plan.const_values(
            _DynResolver(
                relations,
                shift=logup_shift_scalar(claimed_sums[i], l),
                apows=apows,
            )
        )
        text = trace_phase.stacked_ext[elog]
        iext = inter_phase.stacked_ext[elog]
        pext = pre_phase.stacked_ext.get(elog)
        if pext is None:
            pext = text.new_zeros((0, text.shape[-1]))
        Kt, Ki, Kp = int(text.shape[0]), int(iext.shape[0]), int(pext.shape[0])
        pre_start = pre_owner_map.get(id(comp), (0, 0))[0]
        roll = 1 << blowup
        src = np.zeros(len(plan.used_bank), np.int64)
        sh = np.zeros(len(plan.used_bank), np.int64)
        for j, (kind, idx, offset) in enumerate(plan.used_bank):
            if kind == "t":
                _, pos = trace_phase.group_index[ti + idx]
                src[j] = pos
            elif kind == "i":
                _, pos = inter_phase.group_index[ii + idx]
                src[j] = Kt + pos
            elif kind == "p":
                _, pos = pre_phase.group_index[pre_start + idx]
                src[j] = Kt + Ki + pos
            else:  # vanishing inverse row
                src[j] = Kt + Ki + Kp
            sh[j] = (roll * offset) % n
        # the cached row is whole; under a row mesh this rank's share
        vrow = sharded.maybe_shard(_vanishing_row(l, elog, text.device))
        out = run_wide((text, iext, pext, vrow), src, sh, consts, plan, elog)
        contrib = tuple(out[k] for k in range(4))
        after = sum(counts[i + 1 :])
        w4 = tuple(int(x) for x in _qpow_scalar(random_coeff, after))
        # accumulate weighted contributions per evaluation domain; the
        # ifft+embed runs ONCE per elog instead of once per component
        weighted = qmul(contrib, w4)
        if observer is not None:
            observer.end("composition", comp, weighted)
        acc = by_elog.get(elog)
        by_elog[elog] = (
            weighted if acc is None
            else tuple(m31.add(a, b) for a, b in zip(acc, weighted))
        )
        ti += comp.n_trace_cols
        ii += 4 * comp.n_interaction_cols()
    return composition_from_sums(by_elog, max_elog), max_elog


def composition_from_sums(by_elog: dict, max_elog: int):
    """The weighted contributions summed per evaluation domain
    ``{elog: 4-limb evaluations}`` -> the composition's 4-limb evaluations
    on the 2^max_elog domain (FFT order): one ifft + embed per domain, one
    fft of the sum."""
    total = None
    for elog in sorted(by_elog, reverse=True):
        co = _evals_to_coeffs(by_elog[elog], elog, max_elog)
        total = co if total is None else tuple(
            m31.add(a, b) for a, b in zip(total, co)
        )
    ev4 = fft.fft(torch.stack(total), max_elog)
    return tuple(ev4[k] for k in range(4))


def _qpow_scalar(a, e: int):
    from .fri import QONE

    r = QONE
    base = a
    while e > 0:
        if e & 1:
            r = qscalar_mul(r, base)
        base = qscalar_mul(base, base)
        e >>= 1
    return r


# ---------------------------------------------------------------------------
# OODS evaluation (host scalars) — verifier side
# ---------------------------------------------------------------------------


def evaluate_at_point(
    components,
    sampled_trace,
    sampled_interaction,
    claimed_sums,
    random_coeff,
    z_values,
    sampled_preprocessed=None,
):
    """Recompute the composition value at z from sampled mask values.

    sampled_trace: per component, per trace column, [value_at_z]
    sampled_interaction: per component, per limb column, [v(z_prev), v(z)]
    z_values: per component, V_l(z) (QM31) for its trace log size.
    Returns QM31 scalar.
    """
    counts = []
    contribs = []
    if sampled_preprocessed is None:
        sampled_preprocessed = [[] for _ in components]

    def arr1(q):
        return tuple(np.array([x], np.uint32) for x in q)

    for ci, comp in enumerate(components):
        def tg(idx, offset, _ci=ci):
            assert offset == 0
            return Val(arr1(sampled_trace[_ci][idx][0]), True, HostArrayOps)

        def pg(idx, offset, _ci=ci):
            assert offset == 0
            return Val(arr1(sampled_preprocessed[_ci][idx][0]), True, HostArrayOps)

        def ig(idx, offset, _ci=ci):
            limbs = []
            for limb in range(4):
                col = sampled_interaction[_ci][4 * idx + limb]
                limbs.append(col[1] if offset == 0 else col[0])
            # limbs are QM31 samples of base-limb polys; recombine:
            acc = QZERO
            basis = [(1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]
            for limb, b in zip(limbs, basis):
                acc = qscalar_add(acc, qscalar_mul(tuple(limb), b))
            return Val(arr1(acc), True, HostArrayOps)

        shift = Val(
            arr1(logup_shift_scalar(claimed_sums[ci], comp.log_size)),
            True,
            HostArrayOps,
        )
        ev = EvalAtRow(HostArrayOps, tg, ig, shift, pg)
        comp.evaluate(ev)
        acc = None
        for c in ev.constraints:
            ce_limbs = c.as_ext().v
            ce = tuple(int(np.asarray(x).reshape(-1)[0]) for x in ce_limbs)
            acc = ce if acc is None else qscalar_add(
                qscalar_mul(acc, random_coeff), ce
            )
        counts.append(len(ev.constraints))
        vinv = _qscalar_inv(z_values[ci])
        contribs.append(qscalar_mul(acc, vinv))
    total = QZERO
    for i, c in enumerate(contribs):
        after = sum(counts[i + 1 :])
        total = qscalar_add(total, qscalar_mul(c, _qpow_scalar(random_coeff, after)))
    return total


def _qscalar_inv(v):
    from .fri import qscalar_inv

    return qscalar_inv(v)


def vanishing_at_qpoint(log_size: int, z):
    """V_l(z) = pi^(l-1)(z.x) for a QM31 point z (host scalar)."""
    x = z[0]
    for _ in range(log_size - 1):
        x2 = qscalar_mul(x, x)
        x = qscalar_sub_c(qscalar_add(x2, x2), 1)
    return x


def qscalar_sub_c(a, c):
    return ((a[0] - c) % P,) + tuple(a[1:])


# ---------------------------------------------------------------------------
# Trace-check debug tool
# ---------------------------------------------------------------------------


def assert_constraints(component, trace_rows, interaction_cols, claimed_sum,
                       preprocessed_rows=()):
    """Evaluate all constraints on the raw trace; returns list of
    (constraint_index, first_bad_row) for any violations."""
    n = 1 << component.log_size

    def tg(idx, offset):
        col = trace_rows[idx]
        return Val(np.roll(col, -offset) if offset else col, False, HostArrayOps)

    def pg(idx, offset):
        return Val(preprocessed_rows[idx], False, HostArrayOps)

    def ig(idx, offset):
        limbs = interaction_cols[idx]
        if offset:
            limbs = tuple(np.roll(x, -offset) for x in limbs)
        return Val(limbs, True, HostArrayOps)

    shift = Val(
        tuple(
            np.full(n, s, dtype=np.uint32)
            for s in logup_shift_scalar(claimed_sum, component.log_size)
        ),
        True,
        HostArrayOps,
    )
    ev = EvalAtRow(HostArrayOps, tg, ig, shift, pg)
    component.evaluate(ev)
    failures = []
    for k, c in enumerate(ev.constraints):
        v = c.as_ext().v
        bad = np.nonzero(
            (v[0] != 0) | (v[1] != 0) | (v[2] != 0) | (v[3] != 0)
        )
        if bad[0].size:
            failures.append((k, int(bad[-1][0])))
    return failures
