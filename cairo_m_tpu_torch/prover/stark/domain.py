"""Circle group over M31, canonic cosets, twiddles, and domain orderings.

The unit circle x^2 + y^2 = 1 over M31 is a cyclic group of order 2^31
(point addition (x1,y1)+(x2,y2) = (x1x2 - y1y2, x1y2 + y1x2)).  This module
is the TPU-native equivalent of stwo's `core::{circle, poly::circle}`
(consumed by the reference prover per SURVEY.md §2.9):

- points are indexed by integers mod 2^31 (multiples of the generator);
- the **canonic coset** of size 2^n is the set of odd multiples of
  2^(30-n): row i of a trace maps to point ``(2i+1) * 2^(30-n)``;
- the same point set, viewed as the twin coset ``H ∪ -H`` with
  ``H = {(4k+1)*2^(30-n)}``, is the **FFT/commit order** this framework
  stores evaluations in.  Row order <-> FFT order is pure slicing:
  ``fft = concat(rows[0::2], rows[1::2][::-1])`` (no bit-reversal gathers,
  so the layout is XLA-fusion friendly);
- the circle FFT pairs index i with i + len/2 at every level, with
  y-twiddles at the first level and x-twiddles of repeatedly-doubled
  cosets after (Haböck-Levit-Papini circle STARKs construction);
- the vanishing polynomial of the size-2^n canonic domain is
  ``V_n(p) = pi^(n-1)(x_p)`` with ``pi(x) = 2x^2 - 1``; on the blowup-2
  commit domain, a trace-row offset of ``k`` becomes an index offset of
  ``2k`` in row order.

Host (NumPy) computes index tables and twiddles once per log_size (cached);
all hot math consumes them as device tensors.  Counterpart of
``cairo_m_tpu.prover.stark.domain``: the orderings and the bit reversal take
NumPy arrays or torch tensors (plain index ops on the last axis).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...field import m31
from ...parallel import sharded

P = (1 << 31) - 1
M31_CIRCLE_LOG_ORDER = 31

# Generator of the full 2^31-order circle group (x=2, y solves y^2 = -3).
CIRCLE_GEN = (2, 1268011823)


# ---------------------------------------------------------------------------
# Host point arithmetic (Python ints — setup only)
# ---------------------------------------------------------------------------


def point_add(a, b):
    return (
        (a[0] * b[0] - a[1] * b[1]) % P,
        (a[0] * b[1] + a[1] * b[0]) % P,
    )


def point_neg(a):
    return (a[0], (-a[1]) % P)


def point_double(a):
    return point_add(a, a)


@lru_cache(maxsize=None)
def point_at_index(index: int):
    """index -> index * CIRCLE_GEN (double-and-add)."""
    index %= 1 << M31_CIRCLE_LOG_ORDER
    result = (1, 0)
    base = CIRCLE_GEN
    while index:
        if index & 1:
            result = point_add(result, base)
        base = point_double(base)
        index >>= 1
    return result


def subgroup_gen_index(log_size: int) -> int:
    """Index of the generator of the size-2^log_size subgroup."""
    return 1 << (M31_CIRCLE_LOG_ORDER - log_size)


# ---------------------------------------------------------------------------
# Canonic coset tables
# ---------------------------------------------------------------------------


def _point_add_np(ax, ay, b):
    """Vectorized (ax, ay) + scalar point b over M31 (uint32 arrays)."""
    bx, by = np.uint32(b[0]), np.uint32(b[1])
    return (
        m31.sub_np(m31.mul_np(ax, bx), m31.mul_np(ay, by)),
        m31.add_np(m31.mul_np(ax, by), m31.mul_np(ay, bx)),
    )


@lru_cache(maxsize=None)
def coset_points(log_size: int):
    """(x, y) uint32 arrays for the canonic coset of size 2^log_size in
    **row order**: row i -> point (2i+1) * 2^(30-log_size).

    Built in O(log n) vectorized doublings: arr_{t+1} = arr_t ++ (arr_t + 2^t*step).
    """
    n = 1 << log_size
    step_index = subgroup_gen_index(log_size)  # 2^(31-log_size)
    start = point_at_index(subgroup_gen_index(log_size + 1))
    xs = np.array([start[0]], dtype=np.uint32)
    ys = np.array([start[1]], dtype=np.uint32)
    for t in range(log_size):
        shift = point_at_index((step_index << t) % (1 << 31))
        nx, ny = _point_add_np(xs, ys, shift)
        xs = np.concatenate([xs, nx])
        ys = np.concatenate([ys, ny])
    return xs, ys


def to_fft_order(v):
    """Row order -> FFT order ([H; -H] twin-coset layout), on the LAST axis
    (leading axes batch; works on NumPy arrays or torch tensors)."""
    if isinstance(v, np.ndarray):
        return np.concatenate([v[..., 0::2], v[..., 1::2][..., ::-1]], axis=-1)
    return torch.cat([v[..., 0::2], v[..., 1::2].flip(-1)], dim=-1)


def from_fft_order(v):
    """Inverse of to_fft_order (last axis)."""
    n = v.shape[-1]
    m = n // 2
    if isinstance(v, np.ndarray):
        stacked = np.stack([v[..., :m], v[..., m:][..., ::-1]], axis=-1)
    else:
        stacked = torch.stack([v[..., :m], v[..., m:].flip(-1)], dim=-1)
    return stacked.reshape(tuple(v.shape[:-1]) + (n,))


@lru_cache(maxsize=None)
def fft_twiddles(log_size: int):
    """Per-level twiddles for the circle FFT on the size-2^log_size canonic
    domain, in FFT order.

    Returns (levels, inv_levels): ``levels[0]`` = y-coords of H (size n/2),
    ``levels[j>=1]`` = x-coords after j-1 doublings (size n/2^(j+1)), each in
    the FFT order of its own level; ``inv_levels`` are elementwise inverses
    (for the inverse FFT), with the 1/2 butterfly normalization folded in
    separately by the caller.
    """
    n = 1 << log_size
    xs, ys = coset_points(log_size)
    # FFT order of the domain
    fx = to_fft_order(xs)
    fy = to_fft_order(ys)
    m = n // 2
    levels = [fy[:m].copy()]  # y-twiddles: y of H points
    cur_x = fx[:m].copy()  # x of H
    size = m
    while size > 1:
        levels.append(cur_x[: size // 2].copy())
        # doubled coset x-coords: pi(x) = 2x^2 - 1 of the first half
        cur_x = (
            (2 * cur_x[: size // 2].astype(np.uint64) ** 2 - 1) % P
        ).astype(np.uint32)
        size //= 2
    inv_levels = [m31.inv_np(lv) for lv in levels]
    return levels, inv_levels


@lru_cache(maxsize=None)
def vanishing_on_domain(trace_log_size: int, eval_log_size: int):
    """V_{trace}(p) for p over the size-2^eval_log_size canonic domain
    (row order): pi^(trace_log_size - 1)(x_p).  Returns (values, inverses)
    as uint32 arrays."""
    xs, _ = coset_points(eval_log_size)
    v = xs.astype(np.uint64)
    for _ in range(trace_log_size - 1):
        v = (2 * v * v - 1) % P
    v = v.astype(np.uint32)
    return v, m31.inv_np(v)


# ---------------------------------------------------------------------------
# Commit order: bit-reversed FFT order
# ---------------------------------------------------------------------------
# FRI folding pairs (i, i + len/2) of the FFT order become *adjacent* leaf
# pairs (2q, 2q+1) under bit reversal, at every folding level; a query then
# opens both pair elements as Merkle siblings sharing their whole path.


@lru_cache(maxsize=None)
def bitrev_indices(log_size: int) -> np.ndarray:
    n = 1 << log_size
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros(n, dtype=np.uint32)
    for b in range(log_size):
        rev |= ((idx >> b) & 1) << (log_size - 1 - b)
    return rev


@lru_cache(maxsize=None)
def _bitrev_dev(log_size: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(bitrev_indices(log_size).astype(np.int64)).to(device)


def bit_reverse(v, log_size: int):
    """Permute the LAST axis by bit reversal (involution): one gather.

    A cyclic FFT-order share of a row mesh (parallel/sharded.py) becomes
    its rank's commit-order block by a bit reversal of the local index."""
    if isinstance(v, np.ndarray):
        return v[..., bitrev_indices(log_size)]
    if sharded.is_share(v, log_size):
        log_size -= sharded.active_mesh().log_ws
    return v.index_select(-1, _bitrev_dev(log_size, v.device))


def commit_pos_to_row(pos: int, log_size: int) -> int:
    """Commit-order position -> trace row index (host, per-query)."""
    n, m = 1 << log_size, 1 << (log_size - 1)
    f = int(bitrev_indices(log_size)[pos])
    if f < m:
        return 2 * f
    return n - 1 - 2 * (f - m)


def commit_pos_point(pos: int, log_size: int):
    """Circle point (M31 pair) at a commit-order position."""
    row = commit_pos_to_row(pos, log_size)
    return point_at_index((2 * row + 1) * subgroup_gen_index(log_size + 1))


@lru_cache(maxsize=None)
def fri_twiddles_bitrev(log_size: int):
    """Inverse twiddles for FRI folding on commit-order arrays.

    Returns [t_0, t_1, ...]: t_0 = 1/y over H bit-reversed (circle->line
    fold), t_j (j>=1) = 1/x over the level-j line domain bit-reversed.
    Folding at level j pairs positions (2q, 2q+1) with twiddle index q.
    """
    _, inv_levels = fft_twiddles(log_size)
    out = []
    for j, lv in enumerate(inv_levels):
        lg = log_size - 1 - j
        assert lv.shape[0] == 1 << lg
        out.append(bit_reverse(lv, lg))
    return out
