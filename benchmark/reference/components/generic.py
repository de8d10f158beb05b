"""Generic (non-opcode) AIR components: memory, merkle, clock_update,
poseidon2, range checks, bitwise.

Column layouts and constraint/lookup structure follow the reference
components one-to-one (SURVEY.md §2.5; per-file docs cited inline).  Each
component builds its trace rows as NumPy arrays in row order; constraints
live in ``evaluate`` (mode-polymorphic, see stark/air.py).
"""

from __future__ import annotations

import numpy as np

from .. import field as m31
from ..scale import TREE_HEIGHT
from ..poseidon2_params import FULL_ROUNDS, PARTIAL_ROUNDS, T, active_params
from ..scale import rc_limit
from ..air import Component

P = (1 << 31) - 1
MIN_LOG_SIZE = 4


def _pad_len(n: int) -> int:
    return max(1 << MIN_LOG_SIZE, 1 << (max(n, 1) - 1).bit_length())


def _pad(col, size):
    out = np.zeros(size, dtype=np.uint32)
    out[: len(col)] = col
    return out


def enabler_col(non_padded, size):
    out = np.zeros(size, dtype=np.uint32)
    out[:non_padded] = 1
    return out


class MemoryComponent(Component):
    """components/memory.rs — 9 cols: enabler, addr, clock, v0-3, mult, root.

    Lookups: +mult*Memory[addr, clock, v0..v3]; -enabler*Merkle leaf x4.
    """

    name = "memory"
    n_trace_cols = 9

    def __init__(self, relations):
        self.relations = relations

    def n_lookups(self):
        return 5

    def write_trace(self, prover_input):
        pi = prover_input
        rows = []
        for mem, root in (
            (pi.initial_memory, pi.merkle_trees.initial_root or 0),
            (pi.final_memory, pi.merkle_trees.final_root or 0),
        ):
            for addr in sorted(mem):
                v, clock, mult = mem[addr]
                rows.append((addr, clock, v[0], v[1], v[2], v[3], mult, root))
        n = len(rows)
        size = _pad_len(n)
        arr = np.zeros((size, 8), dtype=np.uint32)
        if rows:
            arr[:n] = np.array(rows, dtype=np.uint32)
        self.log_size = size.bit_length() - 1
        self.non_padded_length = n
        self.zero_witness = n == 0
        self.trace_rows = [enabler_col(n, size)] + [arr[:, i] for i in range(8)]
        return self

    def evaluate(self, ev):
        enabler = ev.next_trace_mask()
        address = ev.next_trace_mask()
        clock = ev.next_trace_mask()
        v0 = ev.next_trace_mask()
        v1 = ev.next_trace_mask()
        v2 = ev.next_trace_mask()
        v3 = ev.next_trace_mask()
        multiplicity = ev.next_trace_mask()
        root = ev.next_trace_mask()
        ev.add_constraint(enabler * (1 - enabler))
        ev.add_to_relation(
            self.relations.memory, multiplicity, [address, clock, v0, v1, v2, v3]
        )
        th = ev.const(TREE_HEIGHT)
        for k, v in enumerate((v0, v1, v2, v3)):
            ev.add_to_relation(
                self.relations.merkle, -enabler, [address * 4 + k, th, v, root]
            )
        ev.finalize_logup_in_pairs()


class MerkleComponent(Component):
    """components/merkle.rs — 10 cols; emits children, consumes parent,
    emits poseidon2 input state / consumes digest."""

    name = "merkle"
    n_trace_cols = 10

    def __init__(self, relations):
        self.relations = relations

    def n_lookups(self):
        return 5

    def write_trace(self, prover_input):
        mt = prover_input.merkle_trees
        fields = [
            "index",
            "depth",
            "left_value",
            "right_value",
            "parent_value",
            "left_mult",
            "right_mult",
            "parent_mult",
        ]
        cols = {
            f: np.concatenate([mt.initial_nodes[f], mt.final_nodes[f]])
            for f in fields
        }
        n_init = len(mt.initial_nodes["index"])
        n_fin = len(mt.final_nodes["index"])
        root = np.concatenate(
            [
                np.full(n_init, mt.initial_root or 0, dtype=np.uint32),
                np.full(n_fin, mt.final_root or 0, dtype=np.uint32),
            ]
        )
        n = n_init + n_fin
        size = _pad_len(n)
        self.log_size = size.bit_length() - 1
        self.non_padded_length = n
        self.zero_witness = n == 0
        self.trace_rows = (
            [enabler_col(n, size)]
            + [_pad(cols[f], size) for f in fields[:5]]
            + [_pad(cols[f], size) for f in fields[5:]]
            + [_pad(root, size)]
        )
        return self

    def evaluate(self, ev):
        inv2 = pow(2, P - 2, P)
        enabler = ev.next_trace_mask()
        index = ev.next_trace_mask()
        depth = ev.next_trace_mask()
        left = ev.next_trace_mask()
        right = ev.next_trace_mask()
        parent = ev.next_trace_mask()
        lmult = ev.next_trace_mask()
        rmult = ev.next_trace_mask()
        pmult = ev.next_trace_mask()
        root = ev.next_trace_mask()
        ev.add_constraint(enabler * (1 - enabler))
        for mult in (lmult, rmult, pmult):
            ev.add_constraint(mult * (mult - 1) * (mult - 2))
        rel = self.relations.merkle
        ev.add_to_relation(rel, lmult, [index, depth, left, root])
        ev.add_to_relation(rel, rmult, [index + 1, depth, right, root])
        ev.add_to_relation(rel, -pmult, [index * inv2, depth - 1, parent, root])
        ev.add_to_relation(self.relations.poseidon2, enabler, [left, right])
        ev.add_to_relation(self.relations.poseidon2, -enabler, [parent])
        ev.finalize_logup_in_pairs()


class ClockUpdateComponent(Component):
    """components/clock_update.rs — 7 cols: enabler, addr, prev_clk, v0-3."""

    name = "clock_update"
    n_trace_cols = 7

    def __init__(self, relations):
        self.relations = relations

    def n_lookups(self):
        return 2

    def write_trace(self, prover_input):
        data = prover_input.clock_update_data
        n = len(data)
        size = _pad_len(n)
        arr = np.zeros((size, 6), dtype=np.uint32)
        for i, (addr, prev_clk, v) in enumerate(data):
            arr[i] = (addr, prev_clk, v[0], v[1], v[2], v[3])
        self.log_size = size.bit_length() - 1
        self.non_padded_length = n
        self.zero_witness = n == 0
        self.trace_rows = [enabler_col(n, size)] + [arr[:, i] for i in range(6)]
        return self

    def evaluate(self, ev):
        enabler = ev.next_trace_mask()
        addr = ev.next_trace_mask()
        prev_clk = ev.next_trace_mask()
        vs = ev.next_trace_masks(4)
        ev.add_constraint(enabler * (1 - enabler))
        rel = self.relations.memory
        ev.add_to_relation(rel, -enabler, [addr, prev_clk] + vs)
        ev.add_to_relation(rel, enabler, [addr, prev_clk + rc_limit()] + vs)
        ev.finalize_logup_in_pairs()


def _sym_apply_m4(x):
    t0 = x[0] + x[1]
    t02 = t0 + t0
    t1 = x[2] + x[3]
    t12 = t1 + t1
    t2 = x[1] + x[1] + t1
    t3 = x[3] + x[3] + t0
    t4 = t12 + t12 + t3
    t5 = t02 + t02 + t2
    t6 = t3 + t5
    t7 = t2 + t4
    return [t6, t5, t7, t4]


def _sym_external_matrix(state):
    out = list(state)
    for i in range(4):
        out[4 * i : 4 * i + 4] = _sym_apply_m4(out[4 * i : 4 * i + 4])
    for j in range(4):
        s = out[j] + out[j + 4] + out[j + 8] + out[j + 12]
        for i in range(4):
            out[4 * i + j] = out[4 * i + j] + s
    return out


def _sym_internal_matrix(state, diag):
    total = state[0]
    for s in state[1:]:
        total = total + s
    return [state[i] * int(diag[i]) + total for i in range(T)]


class Poseidon2Component(Component):
    """components/poseidon2.rs — 443 cols; proves every Merkle hash.

    Trace layout: enabler, initial_state(16), per full-round half 1:
    sq1(16), sq2(16), out(16); partial rounds: sq1, sq2, sbox; half 2 like
    half 1.  Lookups: -enabler*[initial state], +enabler*[digest].
    """

    name = "poseidon2"
    n_trace_cols = 1 + T * (1 + FULL_ROUNDS * 3) + 3 * PARTIAL_ROUNDS

    def __init__(self, relations, params=None):
        self.relations = relations
        self.params = params or active_params()
        # constraint plans bake the round constants -> cache by instance
        self.plan_key_extra = self.params.name

    def n_lookups(self):
        return 2

    def write_trace(self, prover_input):
        inputs = prover_input.poseidon2_inputs  # (n, 16)
        n = len(inputs)
        size = _pad_len(n)
        states = np.zeros((size, T), dtype=np.uint32)
        if n:
            states[:n] = inputs
        cols = [enabler_col(n, size)]
        add, mul = m31.add_np, m31.mul_np
        state = [states[:, i].copy() for i in range(T)]
        for s in state:
            cols.append(s)

        def ext_matrix(st):
            out = list(st)
            for i in range(4):
                x = out[4 * i : 4 * i + 4]
                t0 = add(x[0], x[1])
                t02 = add(t0, t0)
                t1 = add(x[2], x[3])
                t12 = add(t1, t1)
                t2 = add(add(x[1], x[1]), t1)
                t3 = add(add(x[3], x[3]), t0)
                t4 = add(add(t12, t12), t3)
                t5 = add(add(t02, t02), t2)
                out[4 * i : 4 * i + 4] = [add(t3, t5), t5, add(t2, t4), t4]
            for j in range(4):
                s = add(add(out[j], out[j + 4]), add(out[j + 8], out[j + 12]))
                for i in range(4):
                    out[4 * i + j] = add(out[4 * i + j], s)
            return out

        prm = self.params
        state = ext_matrix(state)
        for half in range(2):
            for r in range(FULL_ROUNDS // 2):
                rc = prm.external_rc[half * (FULL_ROUNDS // 2) + r]
                state = [add(state[i], np.uint32(rc[i])) for i in range(T)]
                pre = state
                sq1 = [mul(s, s) for s in state]
                cols.extend(sq1)
                sq2 = [mul(s, s) for s in sq1]
                cols.extend(sq2)
                state = [mul(sq2[i], pre[i]) for i in range(T)]
                state = ext_matrix(state)
                cols.extend(state)
            if half == 0:
                for r in range(PARTIAL_ROUNDS):
                    s0 = add(state[0], np.uint32(prm.internal_rc[r]))
                    sq1 = mul(s0, s0)
                    cols.append(sq1)
                    sq2 = mul(sq1, sq1)
                    cols.append(sq2)
                    sbox = mul(sq2, s0)
                    cols.append(sbox)
                    state = [sbox] + state[1:]
                    total = state[0]
                    for s in state[1:]:
                        total = add(total, s)
                    state = [
                        add(mul(state[i], np.uint32(prm.internal_diag[i])), total)
                        for i in range(T)
                    ]
        assert len(cols) == self.n_trace_cols, (len(cols), self.n_trace_cols)
        self.log_size = size.bit_length() - 1
        self.non_padded_length = n
        self.zero_witness = n == 0
        self.trace_rows = cols
        return self

    def evaluate(self, ev):
        """Per-lane symbolic evaluation (pure Val DSL).

        Runs unchanged in every backend mode — host scalars (OODS), host
        arrays (trace check / interaction gen) and tape recording (device
        composition).  Graph size no longer matters: the tape interpreter
        executes recorded instructions, so the 443-column component costs
        tape *length*, not XLA compile time."""
        prm = self.params
        enabler = ev.next_trace_mask()
        ev.add_constraint(enabler * (1 - enabler))
        initial_masks = ev.next_trace_masks(T)
        ev.add_to_relation(self.relations.poseidon2, -enabler, initial_masks)
        state = _sym_external_matrix(initial_masks)
        for half in range(2):
            for r in range(FULL_ROUNDS // 2):
                rc = prm.external_rc[half * (FULL_ROUNDS // 2) + r]
                state = [state[i] + int(rc[i]) for i in range(T)]
                pre = state
                sq1 = ev.next_trace_masks(T)
                for i in range(T):
                    ev.add_constraint(enabler * (pre[i] * pre[i] - sq1[i]))
                sq2 = ev.next_trace_masks(T)
                for i in range(T):
                    ev.add_constraint(enabler * (sq1[i] * sq1[i] - sq2[i]))
                expected = _sym_external_matrix(
                    [sq2[i] * pre[i] for i in range(T)]
                )
                out = ev.next_trace_masks(T)
                for i in range(T):
                    ev.add_constraint(enabler * (expected[i] - out[i]))
                state = out
            if half == 0:
                for r in range(PARTIAL_ROUNDS):
                    s0 = state[0] + int(prm.internal_rc[r])
                    sq1 = ev.next_trace_mask()
                    ev.add_constraint(enabler * (s0 * s0 - sq1))
                    sq2 = ev.next_trace_mask()
                    ev.add_constraint(enabler * (sq1 * sq1 - sq2))
                    sbox = ev.next_trace_mask()
                    ev.add_constraint(enabler * (sq2 * s0 - sbox))
                    state = _sym_internal_matrix(
                        [sbox] + state[1:], prm.internal_diag
                    )
        ev.add_to_relation(self.relations.poseidon2, enabler, [state[0]])
        ev.finalize_logup_in_pairs()


class RangeCheckComponent(Component):
    """preprocessed/range_check — preprocessed enumeration + multiplicity col."""

    n_trace_cols = 1
    n_preprocessed_cols = 1

    def __init__(self, relations, bits: int, rel_name: str = None):
        self.relations = relations
        self.bits = bits
        self.name = rel_name or f"range_check_{bits}"
        self.log_size = bits
        self.rel = getattr(relations, self.name)

    def n_lookups(self):
        return 1

    def preprocessed_columns(self):
        return [np.arange(1 << self.bits, dtype=np.uint32)]

    def write_trace(self, multiplicities: np.ndarray):
        assert len(multiplicities) == 1 << self.bits
        self.non_padded_length = 1 << self.bits
        self.zero_witness = not multiplicities.any()
        self.trace_rows = [multiplicities.astype(np.uint32)]
        return self

    def write_trace_device(self, dev_col, touched: bool):
        """Multiplicity column from the device histogram
        (framework.TableCounter); ``touched=False`` marks a provably
        all-zero table (no counted component consumes the relation)."""
        self.non_padded_length = 1 << self.bits
        self.zero_witness = not touched
        self.trace_rows = None
        self.device_stack = None if not touched else dev_col[None, :]
        return self

    def evaluate(self, ev):
        value = ev.next_preprocessed_mask()
        mult = ev.next_trace_mask()
        ev.add_to_relation(self.rel, mult, [value])
        ev.finalize_logup_in_pairs()


BITWISE_LOG_SIZE = 18  # production: 3 * 2^16 rounded up (preprocessed/bitwise.rs:25-100)


def bitwise_log_size() -> int:
    from ..scale import SCALE

    return SCALE.bitwise_log


class BitwiseComponent(Component):
    """preprocessed/bitwise.rs — stacked AND/OR/XOR 8x8-bit table + mult col.

    Row layout: index = op*2^16 + a*2^8 + b for op in {0: AND, 1: OR, 2: XOR};
    rows >= 3*2^16 are zero with multiplicity 0.
    """

    name = "bitwise"
    n_trace_cols = 1
    n_preprocessed_cols = 4

    def __init__(self, relations):
        self.relations = relations
        self.log_size = bitwise_log_size()

    def n_lookups(self):
        return 1

    @staticmethod
    def table_index(op: int, a, b):
        return (op << 16) + (a << 8) + b

    def preprocessed_columns(self):
        n = 1 << self.log_size
        idx = np.arange(n, dtype=np.uint32)
        op = idx >> 16
        a = (idx >> 8) & 0xFF
        b = idx & 0xFF
        out = np.select(
            [op == 0, op == 1, op == 2], [a & b, a | b, a ^ b], default=0
        ).astype(np.uint32)
        valid = op < 3
        return [
            np.where(valid, op, 0).astype(np.uint32),
            np.where(valid, a, 0).astype(np.uint32),
            np.where(valid, b, 0).astype(np.uint32),
            np.where(valid, out, 0).astype(np.uint32),
        ]

    def write_trace(self, multiplicities: np.ndarray):
        assert len(multiplicities) == 1 << self.log_size
        self.non_padded_length = min(3 << 16, 1 << self.log_size)
        self.zero_witness = not multiplicities.any()
        self.trace_rows = [multiplicities.astype(np.uint32)]
        return self

    def write_trace_device(self, dev_col, touched: bool):
        """See RangeCheckComponent.write_trace_device."""
        self.non_padded_length = min(3 << 16, 1 << self.log_size)
        self.zero_witness = not touched
        self.trace_rows = None
        self.device_stack = None if not touched else dev_col[None, :]
        return self

    def evaluate(self, ev):
        op = ev.next_preprocessed_mask()
        a = ev.next_preprocessed_mask()
        b = ev.next_preprocessed_mask()
        out = ev.next_preprocessed_mask()
        mult = ev.next_trace_mask()
        ev.add_to_relation(self.relations.bitwise, mult, [op, a, b, out])
        ev.finalize_logup_in_pairs()
