"""Points of the circle group x^2 + y^2 = 1 over M31 (order 2^31), the
canonic domains, and the orderings of the commitment.

Row i of a size-2^L trace is the point (2i + 1) * 2^(30 - L) * G.  FFT
order lists the even rows, then the odd rows reversed; commit order is
FFT order bit-reversed, so FRI's folding pairs are sibling leaves.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import field as f

P = f.P
CIRCLE_GEN = (2, 1268011823)  # x = 2, y^2 = -3


def point_add(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


@lru_cache(maxsize=None)
def point_at_index(index: int):
    """index * G by double-and-add."""
    index %= 1 << 31
    result, base = (1, 0), CIRCLE_GEN
    while index:
        if index & 1:
            result = point_add(result, base)
        base = point_add(base, base)
        index >>= 1
    return result


def bitrev(i: int, bits: int) -> int:
    return int(format(i, f"0{bits}b")[::-1], 2) if bits else 0


def bitrev_array(bits: int) -> np.ndarray:
    idx = np.arange(1 << bits, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev


def coset_points(log_size: int):
    """Row-order (x, y) uint32 arrays of the size-2^L canonic domain, built
    by doubling: rows [0, 2^t) shifted by 2^t steps give rows [2^t, 2^(t+1))."""
    x0, y0 = point_at_index(1 << (30 - log_size))
    xs, ys = np.array([x0], np.uint32), np.array([y0], np.uint32)
    for t in range(log_size):
        gx, gy = (np.uint32(c) for c in point_at_index((1 << (31 - log_size + t)) % (1 << 31)))
        nx = f.sub_np(f.mul_np(xs, gx), f.mul_np(ys, gy))
        ny = f.add_np(f.mul_np(xs, gy), f.mul_np(ys, gx))
        xs, ys = np.concatenate([xs, nx]), np.concatenate([ys, ny])
    return xs, ys


def commit_pos_point(pos: int, log_size: int):
    """The point at commit-order position ``pos`` of the size-2^L domain."""
    fpos = bitrev(pos, log_size)
    m = 1 << (log_size - 1)
    row = 2 * fpos if fpos < m else (1 << log_size) - 1 - 2 * (fpos - m)
    return point_at_index((2 * row + 1) << (30 - log_size))


def fold_twiddle_inv(log_size: int, level: int, i: int) -> int:
    """The inverse twiddle of FRI's fold ``level`` at pair index ``i`` (commit
    order) of a size-2^L domain: 1/y of the pair's point at level 0 (circle
    to line), 1/x of the pair's point after level - 1 doublings above."""
    fpos = bitrev(i, log_size - 1 - level)
    if level == 0:
        coord = point_at_index((4 * fpos + 1) << (30 - log_size))[1]
    else:
        coord = point_at_index((4 * fpos + 1) << (29 - log_size + level))[0]
    return pow(coord, P - 2, P)


def vanishing_at(log_size: int, z):
    """V_L(z) = pi^(L-1)(z.x), pi(x) = 2 x^2 - 1, at a QM31 point."""
    x = z[0]
    for _ in range(log_size - 1):
        x2 = f.qmul(x, x)
        x = f.qsub(f.qadd(x2, x2), f.QONE)
    return x


def step_back(z, log_size: int):
    """z minus the trace step of a size-2^L domain, at a QM31 point."""
    gx, gy = point_at_index(1 << (31 - log_size))
    gy = (-gy) % P
    zx, zy = z
    return (f.qsub(f.qmul_m31(zx, gx), f.qmul_m31(zy, gy)),
            f.qadd(f.qmul_m31(zx, gy), f.qmul_m31(zy, gx)))
