"""Partial Poseidon2 Merkle trees over memory states (vectorized).

Port of `crates/prover/src/adapter/merkle.rs`: QM31 cell at address N becomes
4 M31 leaves at indices 4N..4N+3 of a depth-30 tree; only touched subtrees
are built, with per-depth default hashes for missing siblings (multiplicity
0 "intermediate" nodes); leaves have multiplicity 1, or 2 for public
addresses (the public data consumes them too).  Each level is one batched
Poseidon2 call in the native core (`native.poseidon2_hash2`, the twin of
`hash2_np`; the Poseidon2 *AIR* re-proves every hash).  A tree is one
``merkle_tree`` span (``tree``, ``nodes``) of the active recorder, and its
hashes add to the counter ``poseidon2_hashes``.

Node arrays (one dict per tree, struct-of-arrays):
  index (left child), depth, left_value, right_value, parent_value,
  left_mult, right_mult, parent_mult
"""

from __future__ import annotations

import numpy as np

from ... import native
from ...hash.poseidon2 import TREE_HEIGHT, active_params, default_hashes
from .. import observe

P = (1 << 31) - 1


def build_partial_merkle_tree(memory: dict, tree_type: str, public_address_ranges):
    """memory: addr -> (value4, clock, mult).  Returns (nodes dict, root)."""
    with observe.span("merkle_tree", tree=tree_type) as sp:
        nodes, root = _build(memory, tree_type, public_address_ranges)
        n = len(nodes["index"])
        observe.count("poseidon2_hashes", n)
        sp.set(nodes=n)
    return nodes, root


def _build(memory: dict, tree_type: str, public_address_ranges):
    if not memory:
        empty = {
            k: np.zeros(0, dtype=np.uint32)
            for k in (
                "index",
                "depth",
                "left_value",
                "right_value",
                "parent_value",
                "left_mult",
                "right_mult",
                "parent_mult",
            )
        }
        return empty, None

    params = active_params()
    defaults = default_hashes(params)
    addrs = np.array(sorted(memory), dtype=np.int64)
    vals = np.array([memory[a][0] for a in addrs], dtype=np.uint32)  # (n, 4)

    if tree_type == "initial":
        pub = set(public_address_ranges.program) | set(public_address_ranges.input)
    else:
        pub = set(public_address_ranges.output)
    is_pub = np.array([a in pub for a in addrs.tolist()], dtype=bool)

    # leaves: indices 4a..4a+3
    leaf_idx = (addrs[:, None] * 4 + np.arange(4)[None, :]).reshape(-1)
    leaf_val = vals.reshape(-1)
    leaf_mult = np.where(np.repeat(is_pub, 4), 2, 1).astype(np.uint32)

    out = {
        k: []
        for k in (
            "index",
            "depth",
            "left_value",
            "right_value",
            "parent_value",
            "left_mult",
            "right_mult",
            "parent_mult",
        )
    }

    cur_idx, cur_val, cur_mult = leaf_idx, leaf_val, leaf_mult
    for depth in range(TREE_HEIGHT, 0, -1):
        parent_idx = np.unique(cur_idx >> 1)
        left_idx = parent_idx * 2
        right_idx = left_idx + 1
        # lookup children among current nodes (sorted)
        order = np.argsort(cur_idx)
        sidx = cur_idx[order]
        sval = cur_val[order]
        smult = cur_mult[order]

        def lookup(want):
            pos = np.searchsorted(sidx, want)
            pos_c = np.clip(pos, 0, len(sidx) - 1)
            found = sidx[pos_c] == want
            val = np.where(found, sval[pos_c], np.uint32(defaults[depth]))
            mult = np.where(found, smult[pos_c], 0).astype(np.uint32)
            return val.astype(np.uint32), mult

        lval, lmult = lookup(left_idx)
        rval, rmult = lookup(right_idx)
        pval = native.poseidon2_hash2(lval, rval, params)
        out["index"].append(left_idx.astype(np.uint32))
        out["depth"].append(np.full(len(left_idx), depth, dtype=np.uint32))
        out["left_value"].append(lval)
        out["right_value"].append(rval)
        out["parent_value"].append(pval)
        out["left_mult"].append(lmult)
        out["right_mult"].append(rmult)
        out["parent_mult"].append(np.ones(len(left_idx), dtype=np.uint32))
        cur_idx, cur_val, cur_mult = (
            parent_idx,
            pval,
            np.ones(len(parent_idx), dtype=np.uint32),
        )

    assert len(cur_idx) == 1 and cur_idx[0] == 0
    root = int(cur_val[0])
    nodes = {k: np.concatenate(v) for k, v in out.items()}
    return nodes, root
