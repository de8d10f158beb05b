"""The AIR's evaluation context at one point: values, relations, the
constraint collector and the component base.

Host-only: a value is a uint32 NumPy array (M31) or a 4-tuple of them
(QM31).  The components (``components/``) call this interface from their
``evaluate``; the verifier calls it once per component at the out-of-domain
point.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import field as f

P = f.P
QONE, QZERO = f.QONE, f.QZERO


class HostArrayOps:
    """Values: base = uint32 NumPy array; ext = 4-tuple of arrays."""

    badd = staticmethod(f.add_np)
    bsub = staticmethod(f.sub_np)
    bmul = staticmethod(f.mul_np)
    bneg = staticmethod(f.neg_np)

    @staticmethod
    def eadd(a, b):
        return tuple(f.add_np(x, y) for x, y in zip(a, b))

    @staticmethod
    def esub(a, b):
        return tuple(f.sub_np(x, y) for x, y in zip(a, b))

    @staticmethod
    def emul(a, b):
        return f.qmul_np(a, b)

    @staticmethod
    def eneg(a):
        return tuple(f.neg_np(x) for x in a)

    @staticmethod
    def emul_b(a, s):
        return tuple(f.mul_np(x, s) for x in a)

    @staticmethod
    def bconst(c, like):
        return np.full_like(like, c % P)

    @staticmethod
    def embed(b):
        z = np.zeros_like(b)
        return (b, z, z, z)

    @staticmethod
    def econst(q):
        return tuple(np.uint32(int(x)) for x in q)


class Val:
    """Field value: base (M31) or extension (QM31)."""

    __slots__ = ("v", "ext", "ops")

    def __init__(self, v, ext: bool, ops):
        self.v = v
        self.ext = ext
        self.ops = ops

    def _lift(self, other):
        if isinstance(other, Val):
            return other
        if isinstance(other, int):
            return Val(self.ops.bconst(other, self._like()), False, self.ops)
        raise TypeError(type(other))

    def _like(self):
        return self.v if not self.ext else self.v[0]

    def as_ext(self):
        if self.ext:
            return self
        return Val(self.ops.embed(self.v), True, self.ops)

    def __add__(self, other):
        o = self._lift(other)
        ops = self.ops
        if self.ext or o.ext:
            return Val(ops.eadd(self.as_ext().v, o.as_ext().v), True, ops)
        return Val(ops.badd(self.v, o.v), False, ops)

    __radd__ = __add__

    def __sub__(self, other):
        o = self._lift(other)
        ops = self.ops
        if self.ext or o.ext:
            return Val(ops.esub(self.as_ext().v, o.as_ext().v), True, ops)
        return Val(ops.bsub(self.v, o.v), False, ops)

    def __rsub__(self, other):
        return self._lift(other).__sub__(self)

    def __mul__(self, other):
        o = self._lift(other)
        ops = self.ops
        if self.ext and o.ext:
            return Val(ops.emul(self.v, o.v), True, ops)
        if self.ext:
            return Val(ops.emul_b(self.v, o.v), True, ops)
        if o.ext:
            return Val(ops.emul_b(o.v, self.v), True, ops)
        return Val(ops.bmul(self.v, o.v), False, ops)

    __rmul__ = __mul__

    def __neg__(self):
        if self.ext:
            return Val(self.ops.eneg(self.v), True, self.ops)
        return Val(self.ops.bneg(self.v), False, self.ops)


@dataclass
class Relation:
    """A named LogUp relation of fixed arity; draws (z, alpha) per proof."""

    name: str
    arity: int
    z: tuple = QZERO
    alpha_powers: list = field(default_factory=list)

    def draw(self, channel):
        self.z = channel.draw_felt()
        alpha = channel.draw_felt()
        pw = [QONE]
        for _ in range(self.arity - 1):
            pw.append(f.qmul(pw[-1], alpha))
        self.alpha_powers = pw

    def combine(self, values):
        """sum_j alpha^j v_j - z."""
        ops = values[0].ops
        acc = None
        for j, v in enumerate(values):
            term = v * Val(ops.econst(self.alpha_powers[j]), True, ops)
            acc = term if acc is None else acc + term
        return acc - Val(ops.econst(self.z), True, ops)


@dataclass
class RelationEntry:
    relation: Relation
    multiplicity: Val
    values: list


class EvalAtRow:
    """The context a component's ``evaluate`` fills with constraints and
    relation entries."""

    def __init__(self, ops, trace_getter, interaction_getter, logup_cumsum_shift,
                 preprocessed_getter=None):
        self.ops = ops
        self._trace = trace_getter
        self._interaction = interaction_getter
        self._preprocessed = preprocessed_getter
        self._trace_idx = 0
        self._preprocessed_idx = 0
        self.constraints = []
        self.relation_entries = []
        self._logup_shift = logup_cumsum_shift  # claimed_sum / 2^n
        self._like = None
        self.collect_only = False

    def next_trace_mask(self) -> Val:
        v = self._trace(self._trace_idx, 0)
        self._trace_idx += 1
        self._like = v
        return v

    def const(self, c: int) -> Val:
        return Val(self.ops.bconst(c, self._like._like()), False, self.ops)

    def next_trace_masks(self, n: int):
        return [self.next_trace_mask() for _ in range(n)]

    def next_preprocessed_mask(self) -> Val:
        v = self._preprocessed(self._preprocessed_idx, 0)
        self._preprocessed_idx += 1
        return v

    def add_constraint(self, v: Val):
        self.constraints.append(v)

    def add_to_relation(self, relation: Relation, multiplicity: Val, values):
        self.relation_entries.append(RelationEntry(relation, multiplicity, list(values)))

    def finalize_logup_in_pairs(self):
        """Emit the LogUp constraints over the interaction columns: entries
        in pairs, one cumulative column a pair, the last column closing the
        running sum with claimed_sum / 2^n a row."""
        entries = self.relation_entries
        if not entries or self.collect_only:
            return
        prev_col = None
        n_pairs = (len(entries) + 1) // 2
        for k in range(n_pairs):
            pair = entries[2 * k : 2 * k + 2]
            cur = self._interaction(k, 0)
            is_last = k == n_pairs - 1
            if len(pair) == 2:
                e0, e1 = pair
                d0 = e0.relation.combine(e0.values)
                d1 = e1.relation.combine(e1.values)
                numer = e0.multiplicity * d1 + e1.multiplicity * d0
                denom = d0 * d1
            else:
                (e0,) = pair
                d0 = e0.relation.combine(e0.values)
                numer = e0.multiplicity.as_ext()
                denom = d0
            delta = cur if prev_col is None else cur - prev_col
            if is_last:
                prev_row = self._interaction(k, -1)
                delta = delta - prev_row + self._logup_shift
            self.add_constraint(delta * denom - numer)
            prev_col = cur


class Component:
    """One AIR component: ``name``, ``n_trace_cols``,
    ``n_preprocessed_cols``, ``log_size`` and ``evaluate(ev)``."""

    name = "component"
    log_size: int = 0
    n_trace_cols: int = 0
    n_preprocessed_cols: int = 0
    zero_witness: bool = False

    def n_lookups(self) -> int:
        raise NotImplementedError

    def n_interaction_cols(self) -> int:
        return (self.n_lookups() + 1) // 2

    def evaluate(self, ev: EvalAtRow):
        raise NotImplementedError


def logup_shift_scalar(claimed_sum, log_size: int):
    """claimed_sum / 2^log_size."""
    return f.qmul_m31(claimed_sum, pow(1 << log_size, P - 2, P))


_LOOKUP_COUNT_CACHE: dict = {}


def count_lookups(comp) -> int:
    """Number of relation entries ``comp.evaluate`` emits (a dry run)."""
    from .scale import SCALE

    key = (type(comp).__name__, comp.name, SCALE.key())
    if key in _LOOKUP_COUNT_CACHE:
        return _LOOKUP_COUNT_CACHE[key]
    rel = comp.relations
    saved = {id(r): (r.z, r.alpha_powers) for r in rel.all()}
    for r in rel.all():
        r.z = QZERO
        r.alpha_powers = [QONE] * r.arity
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
        n = len(ev.relation_entries)
    finally:
        for r in rel.all():
            r.z, r.alpha_powers = saved[id(r)]
    _LOOKUP_COUNT_CACHE[key] = n
    return n
