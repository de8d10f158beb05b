"""Debug & observability tools (reference crates/prover/src/debug_tools).

Counterpart of ``cairo_m_tpu.prover.debug_tools``; both tools run on the
host (NumPy) and need no device.

- `assert_constraints(prover_input)`: the mock-commitment-scheme equivalent —
  evaluates every component's constraints on raw trace rows (no FFT, no
  commitment) and pinpoints failing (component, constraint index, row); also
  checks the global LogUp balance (public sum + claimed sums == 0).
- `relation_tracker(prover_input)`: counts every relation emission/
  consumption across components + public data and returns unbalanced entries.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from .stark.channel import Blake2sChannel

from ..hash.poseidon2 import TREE_HEIGHT
from .components.registry import ComponentSet
from .public_data import PublicData
from .relations import Relations
from .stark import framework
from .stark.fri import QZERO, qscalar_add

P = (1 << 31) - 1


class ConstraintError(AssertionError):
    pass


def _build(prover_input, seed=b"assert"):
    relations = Relations()
    comps = ComponentSet(relations)
    comps.write_traces(prover_input)
    ch = Blake2sChannel()
    ch.mix_bytes(seed)
    relations.draw(ch)
    claimed = []
    inter = []
    for comp in comps.all:
        pp = comp.preprocessed_columns() if comp.n_preprocessed_cols else ()
        cols, cs = framework.gen_interaction_trace(comp, comp.trace_rows, pp)
        inter.append(cols)
        claimed.append(cs)
    return relations, comps, inter, claimed


def assert_constraints(prover_input, raise_on_failure=True):
    """Returns [] on success, else a list of failure descriptions."""
    relations, comps, inter, claimed = _build(prover_input)
    failures = []
    for comp, cols, cs in zip(comps.all, inter, claimed):
        pp = comp.preprocessed_columns() if comp.n_preprocessed_cols else ()
        bad = framework.assert_constraints(comp, comp.trace_rows, cols, cs, pp)
        for k, row in bad:
            failures.append(f"{comp.name}: constraint {k} fails at row {row}")
    total = PublicData.new(prover_input).initial_logup_sum(relations)
    for cs in claimed:
        total = qscalar_add(total, cs)
    if total != QZERO:
        failures.append(f"global LogUp sum != 0: {total}")
    if failures and raise_on_failure:
        raise ConstraintError("; ".join(failures))
    return failures


def relation_tracker(prover_input):
    """-> dict relation name -> {entry tuple: net multiplicity} (non-zero
    entries only).  The protocol observability oracle: every entry should
    net to zero once public data is accounted."""
    relations, comps, inter, claimed = _build(prover_input)
    counts = defaultdict(lambda: defaultdict(int))
    for comp in comps.all:
        pp = comp.preprocessed_columns() if comp.n_preprocessed_cols else ()
        entries = framework._entries_host(comp, comp.trace_rows, pp)
        n = 1 << comp.log_size
        for e in entries:
            mult = np.broadcast_to(e.multiplicity.as_ext().v[0], (n,))
            vals = [np.broadcast_to(v.as_ext().v[0], (n,)) for v in e.values]
            for i in range(n):
                m = int(mult[i])
                if m == 0:
                    continue
                signed = m if m < P // 2 else m - P
                key = tuple(int(v[i]) for v in vals)
                key = key + (0,) * (e.relation.arity - len(key))
                counts[e.relation.name][key] += signed
    # public data contributions
    pd = PublicData.new(prover_input)
    counts["Registers"][
        (pd.initial_registers[0], pd.initial_registers[1], 1)
    ] += 1
    counts["Registers"][
        (pd.final_registers[0], pd.final_registers[1], pd.clock + 1)
    ] -= 1
    counts["Merkle"][(0, 0, pd.initial_root, pd.initial_root)] += 1
    counts["Merkle"][(0, 0, pd.final_root, pd.final_root)] += 1
    for entries, sign, root in (
        (pd.program, 1, pd.initial_root),
        (pd.input, 1, pd.initial_root),
        (pd.output, -1, pd.final_root),
    ):
        for e in entries:
            if e is None:
                continue
            addr, v, clock = e
            counts["Memory"][(addr, clock, v[0], v[1], v[2], v[3])] += sign
            for k in range(4):
                counts["Merkle"][(4 * addr + k, TREE_HEIGHT, v[k], root)] -= 1
    out = {}
    for rel, entries in counts.items():
        bad = {k: v for k, v in entries.items() if v != 0}
        if bad:
            out[rel] = bad
    return out
