"""Stwo-layout mixed-degree Merkle commitment (BLAKE2s compress framing).

Counterpart of ``cairo_m_tpu.prover.stark.stwo_merkle``: the commitment
layout of stwo's ``MerkleProver``/``MerkleVerifier`` with
``Blake2sMerkleHasher``.  ONE tree commits all columns of a phase regardless
of length.  Selected by ``PcsConfig(framing="stwo")``; the native backend
keeps one dense tree per (phase, log_size) group (`merkle.py`).

Layout and framing (stwo conventions):

- the tree has ``max_log + 1`` layers; layer ``log`` holds ``2^log`` nodes;
  every column of length ``2^log`` *injects* its values into layer ``log``;
- ``hash_node(children, values)``: raw BLAKE2s *compression function* with
  an all-zero initial state, t = 0 and no finalization flag (NOT the full
  hash, so the BLAKE2s leaf kernel, which computes the full hash, does not
  apply):
    state = 0
    if children: state = compress(state, left_digest_words ‖ right_digest_words)
    for each 16-word chunk of values (zero-padded to a multiple of 16):
        state = compress(state, chunk)
    digest = state;
- columns keep their commit order; within a layer they inject in their
  original relative order (stwo sorts by length with a stable sort);
- decommitment = ``hash_witness`` (digests the verifier cannot recompute,
  consumed left-child-first, positions ascending, layers largest-first) +
  ``column_witness`` (values at non-queried positions the verifier still
  needs, same traversal order); queried positions' values travel separately
  as ``queried_values`` per column (stwo ``MerkleDecommitment``).

Layers are built on the host with the vectorized NumPy compress
(`hash.blake2s._compress_np`), as in the reference: callers pull the
committed columns once and hand NumPy arrays in.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ...hash.blake2s import _compress_np


def _hash_layer_np(children: np.ndarray | None, cols: list[np.ndarray], n: int):
    """(n, 8) digest words for one layer.

    children: (2n, 8) digests of the layer below (or None for the largest
    layer); cols: this layer's injected columns, (n,) uint32 each.
    """
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        state = [np.zeros(n, np.uint32) for _ in range(8)]
        if children is not None:
            pairs = children.reshape(n, 16)
            msg = [pairs[:, w] for w in range(16)]
            state = _compress_np(state, msg, 0, False)
        if cols:
            k = len(cols)
            kp = -(-k // 16) * 16
            padded = list(cols) + [np.zeros(n, np.uint32)] * (kp - k)
            for c in range(0, kp, 16):
                state = _compress_np(state, padded[c : c + 16], 0, False)
        return np.stack(state, axis=1)  # (n, 8)


def _digest_bytes(words8: np.ndarray) -> bytes:
    return words8.astype("<u4").tobytes()


def hash_node(children: tuple[bytes, bytes] | None, values: list[int]) -> bytes:
    """Scalar hash_node (verifier-side golden path)."""
    with np.errstate(over="ignore"):  # uint32 wraparound is the algorithm
        state = [np.zeros((), np.uint32) for _ in range(8)]
        if children is not None:
            l = np.frombuffer(children[0], dtype="<u4")
            r = np.frombuffer(children[1], dtype="<u4")
            msg = [l[w].astype(np.uint32) for w in range(8)] + [
                r[w].astype(np.uint32) for w in range(8)
            ]
            state = _compress_np(state, msg, 0, False)
        if values:
            k = len(values)
            kp = -(-k // 16) * 16
            padded = [np.uint32(v) for v in values] + [np.uint32(0)] * (kp - k)
            for c in range(0, kp, 16):
                state = _compress_np(state, padded[c : c + 16], 0, False)
        return np.stack(state).astype("<u4").tobytes()


@dataclass
class StwoDecommitment:
    """stwo ``MerkleDecommitment``: path digests + non-queried values."""

    hash_witness: list = field(default_factory=list)  # 32-byte digests
    column_witness: list = field(default_factory=list)  # ints

    def to_json_obj(self):
        return {
            "hash_witness": [h.hex() for h in self.hash_witness],
            "column_witness": [int(v) for v in self.column_witness],
        }

    @staticmethod
    def from_json_obj(o):
        return StwoDecommitment(
            [bytes.fromhex(h) for h in o["hash_witness"]],
            [int(v) for v in o["column_witness"]],
        )


@dataclass
class StwoPhaseOpening:
    """One committed structure's query opening under stwo framing:
    per-column values at the sorted opened positions + the witness."""

    queried: list  # per column (commit order): [values at sorted positions]
    dec: StwoDecommitment

    def to_json_obj(self):
        return {
            "format": "stwo",
            "queried": [[int(v) for v in col] for col in self.queried],
            "dec": self.dec.to_json_obj(),
        }

    @staticmethod
    def from_json_obj(o):
        return StwoPhaseOpening(
            [[int(v) for v in col] for col in o["queried"]],
            StwoDecommitment.from_json_obj(o["dec"]),
        )


class StwoMerkleTree:
    """One mixed-degree tree over uint32 columns of power-of-two lengths."""

    def __init__(self, columns):
        """columns: list of 1-D NumPy arrays (values < 2^32) in commit order."""
        self.columns = [np.asarray(c, dtype=np.uint32) for c in columns]
        self.column_logs = [
            int(c.shape[0]).bit_length() - 1 for c in self.columns
        ]
        for c, l in zip(self.columns, self.column_logs):
            if c.shape[0] != 1 << l:
                raise ValueError("column length must be a power of two")
        self.max_log = max(self.column_logs)
        # layers[log] = (2^log, 8) digest words
        self.layers: dict[int, np.ndarray] = {}
        below = None
        for log in range(self.max_log, -1, -1):
            cols_here = [
                c for c, l in zip(self.columns, self.column_logs) if l == log
            ]
            below = _hash_layer_np(below, cols_here, 1 << log)
            self.layers[log] = below
        self._root = _digest_bytes(self.layers[0][0])

    def root(self) -> bytes:
        return self._root

    def decommit(self, queries_per_log: dict[int, list]):
        """-> (queried_values per column in commit order, StwoDecommitment).

        queries_per_log: layer log -> positions to open (the verifier
        derives the same set from the global queries).
        """
        dec = StwoDecommitment()
        queried_values = [[] for _ in self.columns]
        prev_positions: list[int] = []
        for log in range(self.max_log, -1, -1):
            layer_q = sorted(set(int(p) for p in queries_per_log.get(log, [])))
            layer_q_set = set(layer_q)
            positions = sorted(
                layer_q_set | {p >> 1 for p in prev_positions}
            )
            prev_set = set(prev_positions)
            col_ids = [
                ci for ci, l in enumerate(self.column_logs) if l == log
            ]
            for p in positions:
                if log < self.max_log:
                    for child in (2 * p, 2 * p + 1):
                        if child not in prev_set:
                            dec.hash_witness.append(
                                _digest_bytes(self.layers[log + 1][child])
                            )
                for ci in col_ids:
                    v = int(self.columns[ci][p])
                    if p in layer_q_set:
                        queried_values[ci].append(v)
                    else:
                        dec.column_witness.append(v)
            prev_positions = positions
        return queried_values, dec


def verify_decommitment(
    root: bytes,
    column_logs: list[int],
    queries_per_log: dict[int, list],
    queried_values: list[list[int]],
    dec: StwoDecommitment,
) -> bool:
    """Replay the witness traversal and check the root (stwo
    ``MerkleVerifier::verify``)."""
    if len(queried_values) != len(column_logs):
        return False
    max_log = max(column_logs) if column_logs else 0
    hash_iter = iter(dec.hash_witness)
    col_iter = iter(dec.column_witness)
    queried_iters = [iter(v) for v in queried_values]
    prev_hashes: dict[int, bytes] = {}
    try:
        for log in range(max_log, -1, -1):
            layer_q = sorted(set(int(p) for p in queries_per_log.get(log, [])))
            layer_q_set = set(layer_q)
            positions = sorted(layer_q_set | {p >> 1 for p in prev_hashes})
            col_ids = [ci for ci, l in enumerate(column_logs) if l == log]
            cur: dict[int, bytes] = {}
            for p in positions:
                children = None
                if log < max_log:
                    l = prev_hashes.get(2 * p)
                    if l is None:
                        l = next(hash_iter)
                    r = prev_hashes.get(2 * p + 1)
                    if r is None:
                        r = next(hash_iter)
                    children = (l, r)
                vals = []
                for ci in col_ids:
                    if p in layer_q_set:
                        vals.append(int(next(queried_iters[ci])))
                    else:
                        vals.append(int(next(col_iter)))
                cur[p] = hash_node(children, vals)
            prev_hashes = cur
    except StopIteration:
        return False
    # witness must be fully consumed and the root must match
    if next(hash_iter, None) is not None or next(col_iter, None) is not None:
        return False
    for it in queried_iters:
        if next(it, None) is not None:
            return False
    return prev_hashes == {0: root}
