"""The frozen yardstick of the rooflines: the card's peaks and the work a
proof's shape requires of kernel A (BLAKE2s Merkle trees) and kernel B
(the AIR's wide-tape plans).  The work is counted from the proof: its
components' log sizes, the AIR's column counts (`reference/components`)
and the security configuration, never from what the program launched.

Peaks, one NVIDIA H100 80GB HBM3 (SXM) at 700 W:
- HBM: 3.35e12 bytes/s (NVIDIA's data sheet);
- INT32: 64 lanes a clock an SM x 132 SMs x 1,980 MHz (``clocks.max.sm``
  as read off the card) = 16.727e12 operations/s.
A BLAKE2s compression needs 648 INT32-pipe operations: its 80 G functions'
4 xors and 4 rotations each, and the 8 three-input xors of the feed-forward
(the adds can issue as IMAD on the FMA pipe at the same rate).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.980e9
BLAKE2S_OPS = 648
WORD_BYTES = 4  # an M31 value
DIGEST_BYTES = 32


def _pad_cols(k: int) -> int:
    return 1 << max(0, (k - 1).bit_length())


def tree_seconds(log_leaves: int, n_cols: int) -> float:
    """Least time for one tree over ``n_cols`` columns of 2^log_leaves
    leaves: the leaf pass (each leaf hashes its row's words, zero-padded to
    a power-of-two count, in 64-byte blocks) and the inner nodes (one
    compression each), each bound by the larger of its operations and its
    bytes (each column word read once, each digest written once)."""
    n = 1 << log_leaves
    blocks = max(1, -(-_pad_cols(n_cols) * WORD_BYTES // 64))
    leaves = max(n * blocks * BLAKE2S_OPS / INT32_OPS_PER_S,
                 n * (n_cols * WORD_BYTES + DIGEST_BYTES) / HBM_BYTES_PER_S)
    inner = max((n - 1) * BLAKE2S_OPS / INT32_OPS_PER_S,
                (n - 1) * DIGEST_BYTES / HBM_BYTES_PER_S)
    return leaves + inner


def proof_trees(comps, log_sizes, log_blowup: int, log_last_layer: int):
    """[(log leaves, columns)] of every tree one proof commits after the
    preprocessed phase: per phase one tree a commit size (trace;
    interaction: 4 limbs a LogUp column; composition: 4 limbs at the
    largest size), then FRI's inner layers (4 limbs each)."""
    trace, inter = {}, {}
    for c, l in zip(comps, log_sizes):
        cl = l + log_blowup
        trace[cl] = trace.get(cl, 0) + c.n_trace_cols
        if c.n_interaction_cols():
            inter[cl] = inter.get(cl, 0) + 4 * c.n_interaction_cols()
    comp_log = max(log_sizes) + 2 * log_blowup
    trees = sorted(trace.items()) + sorted(inter.items()) + [(comp_log, 4)]
    max_log = comp_log  # the largest quotient column
    trees += [(k, 4) for k in range(max_log - 1, log_last_layer, -1)]
    return trees


def kernel_a_seconds(comps, log_sizes, log_blowup: int, log_last_layer: int) -> float:
    return sum(tree_seconds(l, k) for l, k in
               proof_trees(comps, log_sizes, log_blowup, log_last_layer))


def kernel_b_bytes(comps, log_sizes, claimed_sums, log_blowup: int) -> int:
    """Bytes the AIR's plans must move for one proof, over the components
    with a nonzero claimed sum (the others have no lookups and are all
    padding): the interaction pass reads each trace column once and writes
    the 4-limb LogUp columns; the composition pass reads the trace and
    interaction columns on the blowup domain once and writes its 4 limbs
    there."""
    total = 0
    for c, l, s in zip(comps, log_sizes, claimed_sums):
        if not any(int(x) for x in s):
            continue
        t, i = c.n_trace_cols, 4 * c.n_interaction_cols()
        n, ne = 1 << l, 1 << (l + log_blowup)
        total += (t + i) * n * WORD_BYTES
        total += (t + i + 4) * ne * WORD_BYTES
    return total
