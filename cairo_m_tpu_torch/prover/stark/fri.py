"""FRI low-degree test over circle/line domains (blowup 2, fold step 1).

Equivalent of stwo's `core::fri` with the reference configuration
(`FriConfig { log_last_layer_degree_bound: 0, log_blowup_factor: 1,
n_queries: 80 }`, reference `prover_config.rs:13-20`).  All columns are QM31
limb-tuples in **commit order** (bit-reversed FFT order), so folds are
adjacent-pair butterflies; see `domain.fri_twiddles_bitrev`.

Protocol (documented; prover and verifier in this module):

1. ``alpha_0 = draw``; running layer (log k = max_log - 1) =
   ``fold_circle(combine(largest cols, alpha_0^2), alpha_0)``.
2. While k > log_last_layer_size: commit the layer's 4 limb columns in one
   Merkle tree, ``mix_root``; ``alpha = draw``;
   ``layer = fold_line(layer, alpha)``; k -= 1; then for input circle
   columns of size k+1: ``layer = layer*alpha^2 + fold_circle(combine(cols,
   alpha^2), alpha)``.
3. Send the last layer's evaluations; ``mix_felts``.

Folds (y/x = inverse twiddles at the pair):
  circle->line: g[q] = (a+b)/2 + alpha*(a-b)/(2 y_q)
  line->line:   g[q] = (a+b)/2 + alpha*(a-b)/(2 x_q)

Query p (position in the 2^max_log domain) opens pairs
``((p >> (max_log - l)) & ~1, | 1)`` in every committed structure of log
size l; the verifier re-folds layer by layer and checks each opened layer
value and finally the sent last layer, whose interpolation must respect the
degree bound.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...field import m31
from ...field.qm31 import qadd, qmul, qmul_m31, qmul_np
from ...parallel import sharded
from .. import observe
from . import domain, merkle, stwo_merkle

P = (1 << 31) - 1
INV2 = (P + 1) // 2


@dataclass
class FriConfig:
    log_blowup_factor: int = 1
    log_last_layer_degree_bound: int = 0
    n_queries: int = 80

    @property
    def log_last_layer_size(self) -> int:
        return self.log_last_layer_degree_bound + self.log_blowup_factor


# ---------------------------------------------------------------------------
# scalar QM31 helpers (host, Python-int tuples)
#
# Pure-int formulas (QM31 = CM31[u]/(u^2 - (2+i)), CM31 = M31[i]/(i^2+1)):
# the verifier evaluates ~80 queries x ~20 layers x dozens of openings of
# these per proof, so they must not allocate numpy arrays per operation
# (held to the reference by the byte-identical proofs of tests/test_torch_prove*.py).
# ---------------------------------------------------------------------------


def _cmul(p0, p1, q0, q1):
    return (p0 * q0 - p1 * q1) % P, (p0 * q1 + p1 * q0) % P


def qscalar_mul(a, b):
    a0, a1, a2, a3 = (int(x) for x in a)
    b0, b1, b2, b3 = (int(x) for x in b)
    ac0, ac1 = _cmul(a0, a1, b0, b1)
    bd0, bd1 = _cmul(a2, a3, b2, b3)
    ad0, ad1 = _cmul(a0, a1, b2, b3)
    bc0, bc1 = _cmul(a2, a3, b0, b1)
    # (2+i) * bd
    rbd0, rbd1 = (2 * bd0 - bd1) % P, (bd0 + 2 * bd1) % P
    return (
        (ac0 + rbd0) % P,
        (ac1 + rbd1) % P,
        (ad0 + bc0) % P,
        (ad1 + bc1) % P,
    )


def qscalar_inv(a):
    """QM31 scalar inverse: (b + c*u)^-1 = (b - c*u) / (b^2 - (2+i) c^2)."""
    b0, b1, c0, c1 = (int(x) for x in a)
    s0, s1 = _cmul(b0, b1, b0, b1)
    t0, t1 = _cmul(c0, c1, c0, c1)
    d0, d1 = (s0 - (2 * t0 - t1)) % P, (s1 - (t0 + 2 * t1)) % P
    n = (d0 * d0 + d1 * d1) % P
    ninv = pow(n, P - 2, P)
    di0, di1 = (d0 * ninv) % P, (P - d1) * ninv % P
    o0, o1 = _cmul(b0, b1, di0, di1)
    o2, o3 = _cmul(P - c0, P - c1, di0, di1)
    return (o0, o1, o2, o3)


def qscalar_add(a, b):
    return tuple((x + y) % P for x, y in zip(a, b))


def qscalar_sub(a, b):
    return tuple((x - y) % P for x, y in zip(a, b))


def qscalar_mul_m31(a, s):
    return tuple((x * s) % P for x in a)


QONE = (1, 0, 0, 0)
QZERO = (0, 0, 0, 0)


def _combine(cols, weight):
    """sum_j weight^(m-1-j) * cols[j], pointwise (device); ``weight`` is a
    host QM31 tuple."""
    acc = cols[0]
    w = tuple(int(x) for x in weight)
    for c in cols[1:]:
        acc = qadd(qmul(acc, w), c)
    return acc


def _fold_pairs_dev(col, inv_twiddle, alpha):
    """Fold an FFT-order (natural) layer: pairs are the CONTIGUOUS halves
    (u, u + n/2) — commit-order index 2t,2t+1 maps to natural u, u + n/2
    with u = rev(t), so the natural fold result IS the natural order of the
    next layer."""
    half = int(col[0].shape[-1]) // 2
    a = tuple(c[..., :half] for c in col)
    b = tuple(c[..., half:] for c in col)
    f0 = qmul_m31(qadd(a, b), INV2)
    diff = tuple(m31.sub(x, y) for x, y in zip(a, b))
    f1 = qmul_m31(qmul_m31(diff, inv_twiddle), INV2)
    return qadd(f0, qmul(f1, tuple(int(x) for x in alpha)))


from functools import lru_cache as _lru_cache


@_lru_cache(maxsize=None)
def _fri_tw_dev(log_size: int, j: int, device: torch.device):
    """Device NATURAL-order (FFT-order) inverse fold twiddles: level j of
    `domain.fft_twiddles(log_size)` inverses — the natural-order counterpart
    of `fri_twiddles_bitrev` (which the host-side verifier keeps using,
    since it indexes by commit position).  Uploaded once per process."""
    return torch.from_numpy(
        domain.fft_twiddles(log_size)[1][j].astype(np.int64)
    ).to(device)


def _fri_tw_nat_np(log_size: int, j: int):
    """Host natural-order inverse fold twiddles (FRI tail layers)."""
    return domain.fft_twiddles(log_size)[1][j]


def _first_fold(stack, y_inv, a_sq, alpha):
    """(n_cols, 4, 2^log) stacked cols -> (4, 2^(log-1)) folded layer."""
    cols = [tuple(stack[i, k] for k in range(4)) for i in range(stack.shape[0])]
    return torch.stack(_fold_pairs_dev(_combine(cols, a_sq), y_inv, alpha))


def _fold_line(layer, x_inv, alpha, fold_in=None):
    """One line fold (+ optional circle fold-in of new columns):
    (4, 2^log) layer -> (4, 2^(log-1))."""
    folded = _fold_pairs_dev(tuple(layer[k] for k in range(4)), x_inv, alpha)
    if fold_in is not None:
        stack, y_inv_k, a_sq = fold_in
        cols = [
            tuple(stack[i, k] for k in range(4)) for i in range(stack.shape[0])
        ]
        fin = _fold_pairs_dev(_combine(cols, a_sq), y_inv_k, alpha)
        folded = qadd(qmul(folded, tuple(int(x) for x in a_sq)), fin)
    return torch.stack(folded)


def _fold_pair_host(v0, v1, inv_tw, alpha):
    """Host fold of one pair: ((v0+v1)/2 + alpha*(v0-v1)*inv_tw/2)."""
    f0 = qscalar_mul_m31(qscalar_add(v0, v1), INV2)
    f1 = qscalar_mul_m31(qscalar_mul_m31(qscalar_sub(v0, v1), inv_tw), INV2)
    return qscalar_add(f0, qscalar_mul(f1, alpha))


# Layers at or below this log size run ENTIRELY on host (NumPy folds +
# hashlib Merkle trees): the FRI loop is serial through the Fiat-Shamir
# channel (root -> mix -> draw -> fold), so each small layer costs a full
# device round trip for microseconds of math.  One layer pull at the
# boundary replaces ~_FRI_HOST_LOG round trips.
_FRI_HOST_LOG = 11


def _fold_pairs_np(col4, inv_tw, alpha):
    """Host vectorized fold of a NATURAL-order layer (contiguous halves,
    matching `_fold_pairs_dev`): col4 tuple of 4 (n,) uint32 -> 4 x (n/2,)."""
    from ...field import m31 as m31f

    half = col4[0].shape[-1] // 2
    a = tuple(c[:half] for c in col4)
    b = tuple(c[half:] for c in col4)
    f0 = tuple(m31f.mul_np(m31f.add_np(x, y), np.uint32(INV2)) for x, y in zip(a, b))
    diff = tuple(m31f.sub_np(x, y) for x, y in zip(a, b))
    f1 = tuple(
        m31f.mul_np(m31f.mul_np(d, inv_tw), np.uint32(INV2)) for d in diff
    )
    aw = tuple(np.uint32(int(x)) for x in alpha)
    t = qmul_np(f1, tuple(np.full_like(f1[0], w) for w in aw))
    return tuple(m31f.add_np(x, y) for x, y in zip(f0, t))


def _combine_np(cols, weight):
    """Host combine: sum_j weight^(m-1-j) * cols[j]."""
    from ...field import m31 as m31f

    acc = cols[0]
    w = tuple(np.full_like(cols[0][0], int(x)) for x in weight)
    for c in cols[1:]:
        acc = tuple(
            m31f.add_np(x, y) for x, y in zip(qmul_np(acc, w), c)
        )
    return acc


def pair_positions(queries, max_log: int, l: int):
    """Opened pair positions in a size-2^l structure for top-level queries."""
    return sorted({q for p in queries for q in ((p >> (max_log - l)) & ~1, (p >> (max_log - l)) | 1)})


# ---------------------------------------------------------------------------
# Prover
# ---------------------------------------------------------------------------


@dataclass
class FriLayerProof:
    root: bytes
    decommitment: merkle.MerkleDecommitment

    def to_json_obj(self):
        return {"root": self.root.hex(), "dec": self.decommitment.to_json_obj()}

    @staticmethod
    def from_json_obj(o):
        return FriLayerProof(
            bytes.fromhex(o["root"]), merkle.MerkleDecommitment.from_json_obj(o["dec"])
        )


@dataclass
class FriProof:
    inner_roots: list  # committed line-layer roots, outermost first
    inner_decommitments: list  # MerkleDecommitment per inner layer (query phase)
    last_layer: list  # QM31 evals (4-tuples of ints), commit order

    def to_json_obj(self):
        return {
            "inner_roots": [r.hex() for r in self.inner_roots],
            "inner_decommitments": [d.to_json_obj() for d in self.inner_decommitments],
            "last_layer": [[int(x) for x in q] for q in self.last_layer],
        }

    @staticmethod
    def from_json_obj(o):
        def _dec(d):
            if isinstance(d, dict) and d.get("format") == "stwo":
                return stwo_merkle.StwoPhaseOpening.from_json_obj(d)
            return merkle.MerkleDecommitment.from_json_obj(d)

        return FriProof(
            [bytes.fromhex(r) for r in o["inner_roots"]],
            [_dec(d) for d in o["inner_decommitments"]],
            [tuple(q) for q in o["last_layer"]],
        )


class FriProver:
    def __init__(self, channel, columns, config: FriConfig, framing="native"):
        """columns: list of (circle_log_size, qm31 limb-tuple, FFT/natural
        order), any order; sorted internally descending.  All folding runs
        in natural order (contiguous-half pairs); every committed layer and
        the last layer are bit-reversed into commit order, so the emitted
        proof bytes are identical to a commit-order prover.  Layers at or
        below ``_FRI_HOST_LOG`` run on the host.

        ``framing="stwo"``: each committed layer is a mixed-degree stwo
        tree over its 4 limb columns (stwo_merkle.py), built on the host
        from a bit-reversed host copy; folds and transcript order are
        unchanged."""
        self.config = config
        by_log: dict[int, list] = {}
        for l, c in columns:
            by_log.setdefault(int(l), []).append(c)
        self.column_order = sorted(by_log, reverse=True)
        self.max_log = self.column_order[0]
        last = config.log_last_layer_size
        assert last < self.max_log

        self.inner_trees = []  # list of (log_k, MerkleTree)
        alpha0 = channel.draw_felt()
        a0sq = qscalar_mul(alpha0, alpha0)
        top = torch.stack([torch.stack(c) for c in by_log[self.max_log]])
        device = top.device
        # under a row mesh (parallel/sharded.py) a layer is a cyclic share:
        # the fold pairs (u, u + n/2) stay on one rank and meet every D-th
        # twiddle
        y_inv = sharded.share_of(_fri_tw_dev(self.max_log, 0, device), top,
                                 self.max_log)
        with observe.span("first_fold", cols=int(top.shape[0]), log=self.max_log,
                          micro=("fri", "first fold {cols} cols @ {log}")):
            layer = _first_fold(top, y_inv, a0sq, alpha0)  # (4, n/2)
        k = self.max_log - 1
        while k > last:
            # the layers at or below _FRI_HOST_LOG are folded on the host
            on_host = k <= _FRI_HOST_LOG
            with observe.span("layer", k=k, host=on_host,
                              micro=("fri", "layer k={k} host={host}")):
                layer = self._layer(channel, layer, k, on_host, framing,
                                    by_log.get(k), device)
            k -= 1

        # last layer is sent in commit order (the verifier's convention)
        with observe.span("last_layer"):
            if not isinstance(layer, np.ndarray):
                layer = observe.pull(sharded.whole(layer, k))
            host = domain.bit_reverse(layer, last)
            self.last_layer = [
                tuple(int(host[j][i]) for j in range(4))
                for i in range(host.shape[1])
            ]
            channel.mix_felts(self.last_layer)

    def _layer(self, channel, layer, k, on_host, framing, fold_in, device):
        """Commit the layer of log size ``k``, mix its root, draw its alpha
        and fold it (with the columns entering at that size, ``fold_in``)
        -> the next layer: a device tensor, or a NumPy array from the first
        layer folded on the host (ONE pull at the boundary)."""
        if on_host and not isinstance(layer, np.ndarray):
            layer = observe.pull(sharded.whole(layer, k)).astype(np.uint32)
        # layers live in NATURAL (fft) order; each commit bit-reverses its
        # own copy so the committed bytes stay protocol-identical
        commit_layer = domain.bit_reverse(layer, k)
        if framing == "stwo":
            if not on_host:
                commit_layer = sharded.whole_commit(commit_layer, k)
                commit_layer = observe.pull(commit_layer.to(torch.int32))
            with observe.phase("stwo_host_tree"):
                tree = stwo_merkle.StwoMerkleTree(list(commit_layer))
        else:
            with observe.span("merkle", log=k):
                tree = merkle.commit(commit_layer, log_size=k)
        self.inner_trees.append((k, tree))
        channel.mix_root(tree.root())
        alpha = channel.draw_felt()
        with observe.span("fold", host=on_host):
            return self._fold(layer, k, on_host, alpha, fold_in, device)

    def _fold(self, layer, k, on_host, alpha, fold_in, device):
        """-> ``layer`` folded by ``alpha``, the columns of ``fold_in``
        folded in: on the host (NumPy) or on the device."""
        if on_host:
            x_inv_np = _fri_tw_nat_np(self.max_log, self.max_log - k)
            l4 = tuple(np.asarray(layer[j]) for j in range(4))
            folded = _fold_pairs_np(l4, x_inv_np, alpha)
            if fold_in:
                asq = qscalar_mul(alpha, alpha)
                y_inv_np = _fri_tw_nat_np(k, 0)
                # one pull for all entering columns (vs 4 per column)
                pulled = observe.pull(sharded.whole(
                    torch.stack([torch.stack(c) for c in fold_in]), k)
                ).astype(np.uint32)
                cols = [
                    tuple(pulled[i][j] for j in range(4))
                    for i in range(len(fold_in))
                ]
                fin = _fold_pairs_np(
                    _combine_np(cols, asq), y_inv_np, alpha
                )
                aw = tuple(np.full_like(folded[0], int(x)) for x in asq)
                folded = tuple(
                    m31.add_np(x, y)
                    for x, y in zip(qmul_np(folded, aw), fin)
                )
            return np.stack(folded)
        x_inv = sharded.share_of(
            _fri_tw_dev(self.max_log, self.max_log - k, device), layer, k
        )
        extra = None
        if fold_in:
            asq = qscalar_mul(alpha, alpha)
            stack = torch.stack([torch.stack(c) for c in fold_in])
            extra = (stack,
                     sharded.share_of(_fri_tw_dev(k, 0, device), stack, k),
                     asq)
        return _fold_line(layer, x_inv, alpha, extra)

    def stwo_decommit(self, queries):
        """(roots, StwoPhaseOpenings) for the stwo framing."""
        roots, openings = [], []
        for log_k, tree in self.inner_trees:
            pairs = pair_positions(queries, self.max_log, log_k)
            roots.append(tree.root())
            queried, dec = tree.decommit({log_k: pairs})
            openings.append(stwo_merkle.StwoPhaseOpening(queried, dec))
        return roots, openings

    def decommit_plans(self, queries):
        """(roots, DecommitPlans) — callers batch these with the phase
        trees' plans into ONE device->host pull (merkle.finish_plans)."""
        roots = []
        plans = []
        for log_k, tree in self.inner_trees:
            pairs = pair_positions(queries, self.max_log, log_k)
            roots.append(tree.root())
            plans.append(merkle.DecommitPlan(tree, pairs))
        return roots, plans


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


class FriVerifier:
    def __init__(
        self, channel, config: FriConfig, column_logs, proof: FriProof,
        framing="native",
    ):
        """column_logs: log sizes of the input columns (same multiset as the
        prover's).  Replays the channel, recording folding alphas."""
        self.config = config
        self.framing = framing
        self.column_logs = sorted(set(int(l) for l in column_logs), reverse=True)
        self.counts = {
            l: sum(1 for x in column_logs if x == l) for l in self.column_logs
        }
        self.max_log = self.column_logs[0]
        self.proof = proof
        last = config.log_last_layer_size
        self.alpha0 = channel.draw_felt()
        self.layer_alphas = []
        expected_layers = self.max_log - 1 - last
        if len(proof.inner_roots) != expected_layers:
            raise ValueError("FRI: wrong number of inner layers")
        for root in proof.inner_roots:
            channel.mix_root(root)
            self.layer_alphas.append(channel.draw_felt())
        if len(proof.last_layer) != 1 << last:
            raise ValueError("FRI: wrong last layer size")
        channel.mix_felts(proof.last_layer)

    def check_last_layer_degree(self) -> bool:
        """Interpolate the sent last layer and check the degree bound."""
        cfg = self.config
        s = cfg.log_last_layer_size
        # host line-ifft on commit order (adjacent pairs per level)
        vals = [tuple(int(x) for x in q) for q in self.proof.last_layer]
        # un-bitrev to fft order
        rev = domain.bitrev_indices(s)
        vals = [vals[rev[i]] for i in range(1 << s)]
        inv_levels = domain.fft_twiddles(self.max_log)[1]
        for j in range(s):
            # level twiddles: size 2^(s-1-j) -> index (max_log - s + j + ...)
            lvl = inv_levels[self.max_log - s + j]
            half = len(vals) // 2
            assert len(lvl) == half
            out0, out1 = [], []
            for i in range(half):
                a, b = vals[i], vals[i + half]
                out0.append(qscalar_mul_m31(qscalar_add(a, b), INV2))
                out1.append(
                    qscalar_mul_m31(
                        qscalar_mul_m31(qscalar_sub(a, b), int(lvl[i])), INV2
                    )
                )
            vals = out0 + out1
        bound = cfg.log_last_layer_degree_bound
        for i, c in enumerate(vals):
            if i % (1 << (s - bound)) != 0 and c != QZERO:
                return False
        return True

    def verify_queries(self, queries, column_values) -> bool:
        """column_values: dict log_size -> list over columns of that size of
        {position: qm31 tuple} — the FRI input column values at
        ``pair_positions`` (computed by the PCS verifier from openings).

        Checks fold consistency through all layers for every query.
        """
        if not self.check_last_layer_degree():
            return False
        cfg = self.config
        last = cfg.log_last_layer_size

        # verify inner layer decommitments first
        layer_values = []  # per inner layer: {pos: qm31}
        for (root, dec, idx) in zip(
            self.proof.inner_roots, self.proof.inner_decommitments, range(len(self.proof.inner_roots))
        ):
            log_k = self.max_log - 1 - idx
            pairs = pair_positions(queries, self.max_log, log_k)
            if self.framing == "stwo":
                if not isinstance(dec, stwo_merkle.StwoPhaseOpening):
                    return False
                if not stwo_merkle.verify_decommitment(
                    root, [log_k] * 4, {log_k: pairs}, dec.queried, dec.dec
                ):
                    return False
                layer_values.append({
                    p: tuple(dec.queried[j][i] for j in range(4))
                    for i, p in enumerate(pairs)
                })
                continue
            if not merkle.verify_decommitment(root, log_k, 4, pairs, dec):
                return False
            vals = {}
            for p in pairs:
                vals[p] = tuple(dec.values[j][p] for j in range(4))
            layer_values.append(vals)

        def col_combined(l, pos):
            cols = column_values.get(l, [])
            if len(cols) != self.counts.get(l, 0):
                raise ValueError("FRI: wrong column count")
            acc = None
            w = self._alpha_for_size(l)
            wsq = qscalar_mul(w, w)
            for cv in cols:
                v = cv[pos]
                acc = v if acc is None else qscalar_add(qscalar_mul(acc, wsq), v)
            return acc

        for p in queries:
            # first circle fold
            pr = (p >> 0) & ~1
            y_inv = int(domain.fri_twiddles_bitrev(self.max_log)[0][pr >> 1])
            v0 = col_combined(self.max_log, pr)
            v1 = col_combined(self.max_log, pr | 1)
            cur = _fold_pair_host(v0, v1, y_inv, self.alpha0)
            k = self.max_log - 1
            li = 0
            while k > last:
                q = p >> (self.max_log - k)
                vals = layer_values[li]
                if vals[q] != cur:
                    return False
                a, b = vals[q & ~1], vals[q | 1]
                alpha = self.layer_alphas[li]
                x_inv = int(
                    domain.fri_twiddles_bitrev(self.max_log)[self.max_log - k][q >> 1]
                )
                cur = _fold_pair_host(a, b, x_inv, alpha)
                k -= 1
                li += 1
                if self.counts.get(k + 1) and k + 1 < self.max_log:
                    qq = (p >> (self.max_log - k - 1)) & ~1
                    y_inv_k = int(domain.fri_twiddles_bitrev(k + 1)[0][qq >> 1])
                    w0 = col_combined(k + 1, qq)
                    w1 = col_combined(k + 1, qq | 1)
                    folded_in = _fold_pair_host(w0, w1, y_inv_k, alpha)
                    asq = qscalar_mul(alpha, alpha)
                    cur = qscalar_add(qscalar_mul(cur, asq), folded_in)
            # check against last layer
            q_last = p >> (self.max_log - last)
            if tuple(self.proof.last_layer[q_last]) != cur:
                return False
        return True

    def _alpha_for_size(self, l):
        if l == self.max_log:
            return self.alpha0
        # the alpha of the line fold that produced log size l-1
        # fold-in of size l happens after inner layer index (max_log - 1 - l)
        return self.layer_alphas[self.max_log - 1 - l]
