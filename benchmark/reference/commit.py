"""The preprocessed commitment, recomputed in NumPy: each preprocessed
column (the range-check enumerations and the bitwise table) is
interpolated on its canonic circle domain, evaluated on the blowup-2
domain, put in commit order (bit-reversed FFT order), and committed in one
BLAKE2s Merkle tree per log size.  A leaf hashes its row's words, little
endian, zero-padded to a power-of-two column count; a node hashes its two
children's digests.  Every message here fits one BLAKE2s block, so the
hash below is the one-block function, vectorised over lanes.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import field as f
from .domain import bitrev_array, coset_points

P = f.P

_IV = np.array([0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
                0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19], np.uint32)
_SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]


def _rotr_inplace(x, n, tmp):
    np.right_shift(x, np.uint32(n), out=tmp)
    np.left_shift(x, np.uint32(32 - n), out=x)
    np.bitwise_or(x, tmp, out=x)


_G_LANES = ((0, 4, 8, 12), (1, 5, 9, 13), (2, 6, 10, 14), (3, 7, 11, 15),
            (0, 5, 10, 15), (1, 6, 11, 12), (2, 7, 8, 13), (3, 4, 9, 14))


def blake2s_one_block(words, n_bytes: int):
    """BLAKE2s-256 of messages of ``n_bytes`` <= 64 bytes, one a lane:
    ``words`` is a list of 16 uint32 lane arrays (the message, zero-padded,
    little endian) -> list of 8 uint32 lane arrays (the digest)."""
    assert 0 < n_bytes <= 64 and len(words) == 16
    lanes = words[0].shape
    h = [np.full(lanes, _IV[i], np.uint32) for i in range(8)]
    h[0] ^= np.uint32(0x01010020)  # digest 32, key 0, fanout 1, depth 1
    v = [x.copy() for x in h] + [np.full(lanes, x, np.uint32) for x in _IV]
    v[12] ^= np.uint32(n_bytes)
    v[14] = ~v[14]  # the last block
    tmp = np.empty(lanes, np.uint32)
    for r in range(10):
        s = _SIGMA[r]
        for i, (a, b, c, d) in enumerate(_G_LANES):
            va, vb, vc, vd = v[a], v[b], v[c], v[d]
            for x, r1, r2 in ((words[s[2 * i]], 16, 12), (words[s[2 * i + 1]], 8, 7)):
                np.add(va, vb, out=va)
                np.add(va, x, out=va)
                np.bitwise_xor(vd, va, out=vd)
                _rotr_inplace(vd, r1, tmp)
                np.add(vc, vd, out=vc)
                np.bitwise_xor(vb, vc, out=vb)
                _rotr_inplace(vb, r2, tmp)
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def merkle_root(columns: np.ndarray) -> bytes:
    """Root over (k, n) uint32 columns in commit order."""
    k, n = columns.shape
    kp = 1 << max(0, (k - 1).bit_length())
    assert kp <= 16, "one-block leaves only"
    zero = np.zeros(n, np.uint32)
    words = [columns[i] if i < k else zero for i in range(16)]
    level = blake2s_one_block(words, 4 * kp)
    while level[0].shape[0] > 1:
        words = [w[0::2] for w in level] + [w[1::2] for w in level]
        level = blake2s_one_block(words, 64)
    return b"".join(int(w[0]).to_bytes(4, "little") for w in level)


@lru_cache(maxsize=None)
def _twiddles(log_size: int):
    """Per-level butterfly twiddles of the circle FFT, FFT order: level 0
    the y of the half coset H, level j the x after j - 1 doublings."""
    xs, ys = coset_points(log_size)
    fx, fy = to_fft_order(xs), to_fft_order(ys)
    m = 1 << (log_size - 1)
    levels = [fy[:m].copy()]
    cur = fx[:m].copy()
    size = m
    while size > 1:
        levels.append(cur[: size // 2].copy())
        cur = ((2 * cur[: size // 2].astype(np.uint64) ** 2 - 1) % P).astype(np.uint32)
        size //= 2
    return levels, [f.inv_np(lv) for lv in levels]


def to_fft_order(v):
    return np.concatenate([v[..., 0::2], v[..., 1::2][..., ::-1]], axis=-1)


def ifft(v, log_size: int):
    """FFT-order evaluations (k, 2^L) -> circle coefficients."""
    _, itw = _twiddles(log_size)
    k, n = v.shape
    for j in range(log_size):
        half = n >> (j + 1)
        v = v.reshape(k, 1 << j, 2, half)
        a, b = v[:, :, 0], v[:, :, 1]
        v = np.stack([f.add_np(a, b), f.mul_np(f.sub_np(a, b), itw[j])], axis=2)
    scale = np.uint32(pow((P + 1) // 2, log_size, P))
    return f.mul_np(v.reshape(k, n), scale)


def fft(c, log_size: int):
    """Coefficients (k, 2^L) -> FFT-order evaluations."""
    tw, _ = _twiddles(log_size)
    k, n = c.shape
    v = c
    for j in range(log_size - 1, -1, -1):
        half = n >> (j + 1)
        v = v.reshape(k, 1 << j, 2, half)
        a, b = v[:, :, 0], f.mul_np(v[:, :, 1], tw[j])
        v = np.stack([f.add_np(a, b), f.sub_np(a, b)], axis=2)
    return v.reshape(k, n)


def commit_roots(columns, log_blowup: int):
    """[(trace log, row-order column)] -> [(commit log, root)], largest
    first; computed once a process for one set of columns."""
    key = (log_blowup, tuple((int(l), np.asarray(c, np.uint32).tobytes()) for l, c in columns))
    hit = _ROOTS.get(key)
    if hit is None:
        hit = _ROOTS[key] = _commit_roots(columns, log_blowup)
    return hit


_ROOTS: dict = {}


def _commit_roots(columns, log_blowup: int):
    """The roots, one tree a log size (columns of one size in their order)."""
    groups: dict = {}
    for l, col in columns:
        groups.setdefault(int(l), []).append(np.asarray(col, np.uint32))
    roots = []
    for l in sorted(groups, reverse=True):
        cl = l + log_blowup
        coeffs = ifft(to_fft_order(np.stack(groups[l])), l)
        big = np.zeros((coeffs.shape[0], 1 << cl), np.uint32)
        big[:, :: 1 << log_blowup] = coeffs
        ext = fft(big, cl)
        roots.append((cl, merkle_root(ext[:, bitrev_array(cl)])))
    return roots
