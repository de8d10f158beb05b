"""Merkle vector commitment over same-size column groups (BLAKE2s).

Counterpart of ``cairo_m_tpu.prover.stark.merkle`` (same protocol): every
tree commits a group of equal-length columns — leaf ``i`` hashes the
concatenation of all columns' values at ``i``, zero-padded to a power-of-two
column count; inner nodes hash their two children.  Columns are stored in
**commit order** = bit-reversed FFT order, so FRI folding pairs are
adjacent leaves.

Commitment runs on the tensors' device, down to the root: the leaf pass
(``blake2s.hash_leaves``) writes its digests into the first columns of one
packed ``(8, 2n - 1)`` pyramid and ``blake2s.merkle_pyramid`` fills in every
level above them (the CUDA kernels on the card, their plain versions on the
CPU).  The host hashes nothing of such a tree: it pulls a copy of the
levels of at most ``2^_HOST_TOP_LOG`` nodes, the root among them, for the
path walks.  Decommitment and verification are host-side path walks.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ...hash import blake2s
from ...parallel import sharded
from .. import observe


def _pad_cols(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


# The levels of at most this many nodes are mirrored on the HOST: one pull
# of the pyramid's last 2^(_HOST_TOP_LOG + 1) - 1 columns gives the root and
# lets a decommitment read the upper siblings without a device gather.  The
# value does not change proof bytes.
_HOST_TOP_LOG = 10


def _host_inner_levels(digests_np: np.ndarray):
    """digests_np: (m, 8) level -> list of all upper levels [(m/2, 8), ...]
    via the vectorized NumPy BLAKE2s (blake2s.hash_words_np_vec): the inner
    levels of a tree built from NumPy input."""
    levels = []
    cur = digests_np
    while cur.shape[0] > 1:
        pairs = cur.reshape(-1, 16)  # (m/2, 16): left digest words, right
        nxt = np.stack(
            blake2s.hash_words_np_vec([pairs[:, w] for w in range(16)]),
            axis=1,
        )
        levels.append(nxt.astype(np.uint32))
        cur = nxt
    return levels


class MerkleTree:
    """One tree over equal-length columns (length n = 2^log_size).

    A tensor input builds the whole pyramid on its device: `packed`, one
    (8, 2n - 1) int64 tensor (leaf digests in columns [0, n), then level 1,
    ... , the root last), and `levels`, views of it, one (8, n >> i) view per
    level.  `host_base` is the first level of <= 2^_HOST_TOP_LOG nodes;
    `host_chain` mirrors the levels from there to the root on the host as
    (m, 8) uint32 arrays, pulled, not hashed.  A NumPy input builds entirely
    on the host: levels == [], host_base == 0 and host_chain covers every
    level (the FRI tail layers)."""

    def __init__(self, columns, defer_top: bool = False, log_size: int = None):
        """columns: a stacked (n_cols, n) NumPy array or int64 tensor.

        ``defer_top=True``: don't pull the top levels yet — the caller
        batches many trees' `top_dev` into ONE device->host transfer and
        calls `finish_host` on each.

        ``log_size``: the tree's size.  Under a row mesh
        (parallel/sharded.py) a tensor of fewer than 2^log_size lanes is
        this rank's commit-order block: the rank builds the subtree over
        it, and the levels from `host_base` up are gathered from every rank
        (`finish_host_shared`) and finished on the host.

        A device tree records ``leaves`` and ``pyramid`` spans
        (`observe`; ``CM_DEBUG_MICRO`` prints them)."""
        stacked = columns
        n_cols, n = int(stacked.shape[0]), int(stacked.shape[1])
        self.columns = stacked
        self.n_cols = n_cols
        self.fft_columns = None  # see `open_from_fft_order`
        self.log_size = n.bit_length() - 1
        assert 1 << self.log_size == n
        # (commit block, log of the block) of a tree split over a row mesh
        self.share = None
        if log_size is not None and sharded.is_share(stacked, log_size):
            self.share = (sharded.commit_block(), self.log_size)
            self.log_size = log_size
        kp = _pad_cols(n_cols)
        self.levels = []  # views of the packed device pyramid, leaves first
        self.host_base = 0
        if isinstance(stacked, np.ndarray):
            hashed = stacked
            if kp != n_cols:
                hashed = np.concatenate(
                    [stacked, np.zeros((kp - n_cols, n), np.uint32)], axis=0
                )
            leaf = np.stack(
                blake2s.hash_words_np_vec(list(hashed)), axis=1
            )  # (n, 8)
            self.host_chain = [leaf] + _host_inner_levels(leaf)
            self._root = self.host_chain[-1][0].astype("<u4").tobytes()
            return
        self.packed = torch.empty(
            (8, 2 * n - 1), dtype=torch.int64, device=stacked.device
        )
        with observe.span("leaves", k=n_cols, log=self.log_size,
                          micro=("micro", "merkle leaves k={k} cl={log}")):
            blake2s.hash_leaves(stacked.contiguous(), kp, out=self.packed[:, :n])
        with observe.span("pyramid", log=self.log_size,
                          micro=("micro", "merkle pyramid cl={log}")):
            blake2s.merkle_pyramid(self.packed)
        local_log = n.bit_length() - 1
        offs = [blake2s.pyramid_offset(n, l) for l in range(local_log + 2)]
        self.levels = [self.packed[:, a:b] for a, b in zip(offs, offs[1:])]
        # the mirrored levels are the pyramid's last columns
        self.host_base = max(self.log_size - _HOST_TOP_LOG, 0)
        assert self.host_base <= local_log
        self.top_dev = self.packed[:, blake2s.pyramid_offset(n, self.host_base) :]
        if defer_top:
            self.host_chain = None  # caller batch-pulls and finish_host()es
            self._root = None
        elif self.share is not None:
            self.finish_host_shared(observe.pull(sharded.all_gather(self.top_dev)))
        else:
            self.finish_host(observe.pull(self.top_dev))

    def open_from_fft_order(self, ext):
        """Read the opened values from ``ext``, the device columns in FFT
        order (commit order is its bit reversal), and drop the hashed
        commit-order copy.  A tree split over a row mesh keeps its block."""
        if self.levels and self.share is None:
            self.fft_columns, self.columns = ext, None

    def opened_values(self, positions) -> torch.Tensor:
        """The columns at commit-order ``positions`` (sorted), (n_cols,
        len(positions)) flattened, on the tree's device."""
        cols = self.columns
        if cols is None:
            cols = self.fft_columns
            log = self.log_size
            positions = [int(format(p, f"0{log}b")[::-1], 2) if log else p
                         for p in positions]
        pos = observe.push(np.asarray(positions, np.int64), cols.device)
        return cols.index_select(1, pos).reshape(-1)

    def finish_host(self, top_words: np.ndarray):
        """Mirror the upper levels on the host from the pulled `top_dev`
        ((8, 2m - 1): a level of m nodes and every level above it)."""
        top = np.asarray(top_words).astype(np.uint32).T  # (2m - 1, 8)
        m = (top.shape[0] + 1) // 2
        self.host_chain = []
        off = 0
        while m >= 1:
            self.host_chain.append(np.ascontiguousarray(top[off : off + m]))
            off += m
            m //= 2
        self._root = self.host_chain[-1][0].astype("<u4").tobytes()

    def finish_host_shared(self, tops: np.ndarray):
        """Mirror the upper levels of a tree split over a row mesh from
        every rank's `top_dev` ((D, 8, 2m - 1), rank order): each level
        from `host_base` to the subtree roots is the ranks' pieces in
        commit-block order, and the top log2(D) levels are hashed here, the
        same on every rank."""
        D = int(tops.shape[0])
        bits = D.bit_length() - 1
        by_block = [tops[sharded.bitrev_bits(b, bits)] for b in range(D)]
        m = (int(tops.shape[2]) + 1) // 2
        self.host_chain = []
        off = 0
        while m >= 1:
            level = np.concatenate([t[:, off : off + m] for t in by_block], axis=1)
            self.host_chain.append(np.ascontiguousarray(level.astype(np.uint32).T))
            off += m
            m //= 2
        self.host_chain += _host_inner_levels(self.host_chain[-1])
        self._root = self.host_chain[-1][0].astype("<u4").tobytes()

    def root(self) -> bytes:
        return self._root


def commit(columns, log_size: int = None) -> MerkleTree:
    return MerkleTree(columns, log_size=log_size)


@dataclass
class MerkleDecommitment:
    """Opened values + authentication paths for a sorted position set."""

    values: list  # per column: {position: value}
    siblings: list  # list of 32-byte digests in consumption order

    def to_json_obj(self):
        return {
            "values": [{str(p): int(v) for p, v in col.items()} for col in self.values],
            "siblings": [h.hex() for h in self.siblings],
        }

    @staticmethod
    def from_json_obj(o):
        return MerkleDecommitment(
            [{int(p): int(v) for p, v in col.items()} for col in o["values"]],
            [bytes.fromhex(h) for h in o["siblings"]],
        )


class DecommitPlan:
    """Device gathers + metadata for opening one tree; `finish` assembles
    the decommitment from the host copy of `flat`.  Callers concatenate many
    plans' `flat` tensors and pull them in ONE device->host transfer.

    Siblings of the levels below `tree.host_base` are gathered on the
    device, straight from the packed pyramid; those of the host-mirrored
    upper levels are collected directly and appended after them — the order
    the verifier consumes them in."""

    def __init__(self, tree: MerkleTree, positions):
        self.positions = sorted(set(int(p) for p in positions))
        self.n_cols = tree.n_cols
        host_tree = not tree.levels
        if host_tree:
            parts = [np.take(tree.columns, self.positions, axis=1).reshape(-1)]
        elif tree.share is not None:
            parts = [self._owned_values(tree)]
        else:
            dev = tree.packed.device
            parts = [tree.opened_values(self.positions)]
        # host_chain[0] is pyramid level host_base
        chain_base = tree.host_base
        n_levels = chain_base + len(tree.host_chain)
        sib_idx = []
        self.sib_counts = []
        self.host_siblings = []  # 32-byte digests, level order
        cur = self.positions
        for lvl in range(n_levels - 1):
            cur_set = set(cur)
            sibs = [p ^ 1 for p in cur if (p ^ 1) not in cur_set]
            parents = []
            for p in cur:
                par = p >> 1
                if not parents or parents[-1] != par:
                    parents.append(par)
            if lvl < chain_base:
                # device level (gathered from the packed pyramid)
                self.sib_counts.append(len(sibs))
                level_off = blake2s.pyramid_offset(1 << tree.log_size, lvl)
                sib_idx += [level_off + s for s in sibs]
            else:
                hl = tree.host_chain[lvl - chain_base]
                for s in sibs:
                    self.host_siblings.append(hl[s].astype("<u4").tobytes())
            cur = parents
        if host_tree:
            self.flat = None
            self.host_flat = parts[0]
        else:
            if tree.share is not None and sib_idx:
                parts.append(self._owned_siblings(tree, sib_idx))
            elif sib_idx:
                idx = observe.push(np.asarray(sib_idx, np.int64), dev)
                # one gather for all device levels; (S, 8) word-major per
                # digest
                parts.append(tree.packed.index_select(1, idx).T.reshape(-1))
            self.flat = torch.cat(parts) if len(parts) > 1 else parts[0]
            self.host_flat = None
            mesh = sharded.active_mesh()
            if mesh is not None and tree.share is None and mesh.rank:
                # every rank holds this whole tree; rank 0's copy is read
                self.flat = torch.zeros_like(self.flat)
        self.size = int(
            (self.host_flat if self.flat is None else self.flat).shape[0]
        )

    def _owned_values(self, tree) -> torch.Tensor:
        """Opened values of a tree split over a row mesh, in the whole
        tree's order, with the entries of other ranks' blocks left 0."""
        block, local_log = tree.share
        nl = 1 << local_log
        dev = tree.columns.device
        mine = [j for j, p in enumerate(self.positions) if p >> local_log == block]
        vals = torch.zeros((self.n_cols, len(self.positions)), dtype=torch.int64,
                           device=dev)
        if mine:
            local = observe.push(
                np.asarray([self.positions[j] - block * nl for j in mine], np.int64),
                dev)
            vals[:, observe.push(np.asarray(mine, np.int64), dev)] = (
                tree.columns.index_select(1, local))
        return vals.reshape(-1)

    def _owned_siblings(self, tree, sib_idx) -> torch.Tensor:
        """Device-level siblings of a split tree, (S, 8) word-major, those of
        other ranks' blocks left 0.  ``sib_idx`` are offsets into the whole
        tree's packed pyramid; below the subtree roots each node lies in one
        block."""
        block, local_log = tree.share
        n, nl = 1 << tree.log_size, 1 << local_log
        dev = tree.packed.device
        mine, local = [], []
        lvl = 0
        for j, off in enumerate(sib_idx):
            while off >= blake2s.pyramid_offset(n, lvl + 1):
                lvl += 1
            node = off - blake2s.pyramid_offset(n, lvl)
            width = nl >> lvl
            if node // width == block:
                mine.append(j)
                local.append(blake2s.pyramid_offset(nl, lvl) + node % width)
        sibs = torch.zeros((len(sib_idx), 8), dtype=torch.int64, device=dev)
        if mine:
            idx = observe.push(np.asarray(local, np.int64), dev)
            sibs[observe.push(np.asarray(mine, np.int64), dev)] = (
                tree.packed.index_select(1, idx).T)
        return sibs.reshape(-1)

    def finish(self, host_flat: np.ndarray) -> MerkleDecommitment:
        n_pos = len(self.positions)
        opened = host_flat[: self.n_cols * n_pos].reshape(self.n_cols, n_pos)
        values = [
            {p: int(opened[ci, j]) for j, p in enumerate(self.positions)}
            for ci in range(self.n_cols)
        ]
        off = self.n_cols * n_pos
        siblings = []
        for s in self.sib_counts:
            words = host_flat[off : off + 8 * s].reshape(s, 8)
            off += 8 * s
            for j in range(s):
                siblings.append(words[j].astype("<u4").tobytes())
        siblings += self.host_siblings
        return MerkleDecommitment(values, siblings)


def finish_plans(plans: list) -> list:
    """Pull every plan's device gathers in one transfer; host-only plans
    finish without device traffic."""
    if not plans:
        return []
    dev_plans = [p for p in plans if p.flat is not None]
    host = None
    if dev_plans:
        flat = torch.cat([p.flat for p in dev_plans])
        if sharded.active_mesh() is not None:
            # every entry comes from the one rank that holds it
            flat = sharded.psum_owned(flat)
        host = observe.pull(flat)
    out = []
    off = 0
    with observe.span("finish"):
        for p in plans:
            if p.flat is None:
                out.append(p.finish(p.host_flat))
            else:
                out.append(p.finish(host[off : off + p.size]))
                off += p.size
    return out


def verify_decommitment(
    root: bytes,
    log_size: int,
    n_columns: int,
    positions,
    dec: MerkleDecommitment,
) -> bool:
    positions = sorted(set(int(p) for p in positions))
    if len(dec.values) != n_columns:
        return False
    # recompute leaf digests (column count padded to a power of two with
    # zero words — the committer's leaf-message convention)
    pad = (_pad_cols(n_columns) - n_columns) * b"\x00\x00\x00\x00"
    digests = {}
    for p in positions:
        msg = b""
        for col in dec.values:
            if p not in col:
                return False
            msg += int(col[p]).to_bytes(4, "little")
        digests[p] = blake2s.hash_bytes(msg + pad)
    sib_iter = iter(dec.siblings)
    cur = positions
    for _ in range(log_size):
        parents = []
        parent_digests = {}
        for p in cur:
            sib = p ^ 1
            if sib not in digests:
                try:
                    digests[sib] = next(sib_iter)
                except StopIteration:
                    return False
            l, r = (
                (digests[p], digests[sib]) if p % 2 == 0 else (digests[sib], digests[p])
            )
            par = p >> 1
            if par not in parent_digests:
                parent_digests[par] = blake2s.hash_bytes(l + r)
                parents.append(par)
        digests = parent_digests
        cur = parents
    if next(sib_iter, None) is not None:
        return False
    return digests.get(0) == root
