"""M31 and QM31 arithmetic in NumPy (arrays) and Python ints (scalars).

M31 = Z / (2^31 - 1); CM31 = M31[i] / (i^2 + 1); QM31 = CM31[u] / (u^2 -
(2 + i)).  A QM31 value is a 4-tuple (a, b, c, d) = (a + b i) + (c + d i) u.
"""

from __future__ import annotations

import numpy as np

P = (1 << 31) - 1
P_U32 = np.uint32(P)
QONE = (1, 0, 0, 0)
QZERO = (0, 0, 0, 0)


# -- M31, uint32 arrays with uint64 intermediates --

def add_np(a, b):
    s = a.astype(np.uint64) + b.astype(np.uint64)
    s = np.where(s >= P, s - P, s)
    return s.astype(np.uint32)


def sub_np(a, b):
    a = a.astype(np.uint64)
    b = b.astype(np.uint64)
    return np.where(a >= b, a - b, a + P - b).astype(np.uint32)


def neg_np(a):
    return np.where(a == 0, np.uint32(0), P_U32 - a.astype(np.uint32))


def mul_np(a, b):
    p = a.astype(np.uint64) * b.astype(np.uint64)
    p = (p & P) + (p >> 31)
    p = (p & P) + (p >> 31)
    return np.where(p == P, 0, p).astype(np.uint32)


def pow_np(a, e: int):
    a = np.asarray(a, dtype=np.uint32)
    result = np.full_like(a, 1, dtype=np.uint32)
    base = a
    while e > 0:
        if e & 1:
            result = mul_np(result, base)
        base = mul_np(base, base)
        e >>= 1
    return result


def inv_np(a):
    """a^(P-2); 0 maps to 0."""
    return pow_np(a, P - 2)


# -- QM31, 4-tuples of uint32 arrays --

def _cmul_np(p, q):
    return (sub_np(mul_np(p[0], q[0]), mul_np(p[1], q[1])),
            add_np(mul_np(p[0], q[1]), mul_np(p[1], q[0])))


def _cmul_r_np(p):
    """(2 + i) * p over CM31."""
    return (sub_np(add_np(p[0], p[0]), p[1]), add_np(p[0], add_np(p[1], p[1])))


def qmul_np(x, y):
    a_, b_ = (x[0], x[1]), (x[2], x[3])
    c_, d_ = (y[0], y[1]), (y[2], y[3])
    ac, bd = _cmul_np(a_, c_), _cmul_np(b_, d_)
    ad, bc = _cmul_np(a_, d_), _cmul_np(b_, c_)
    rbd = _cmul_r_np(bd)
    return (add_np(ac[0], rbd[0]), add_np(ac[1], rbd[1]),
            add_np(ad[0], bc[0]), add_np(ad[1], bc[1]))


def qinv_np(x):
    """(a + b u)^-1 = (a - b u) / (a^2 - (2 + i) b^2)."""
    a_, b_ = (x[0], x[1]), (x[2], x[3])
    a2, b2 = _cmul_np(a_, a_), _cmul_np(b_, b_)
    rb2 = _cmul_r_np(b2)
    denom = (sub_np(a2[0], rb2[0]), sub_np(a2[1], rb2[1]))
    norm = add_np(mul_np(denom[0], denom[0]), mul_np(denom[1], denom[1]))
    ninv = inv_np(norm)
    dinv = (mul_np(denom[0], ninv), neg_np(mul_np(denom[1], ninv)))
    na = _cmul_np(a_, dinv)
    nb = _cmul_np(b_, dinv)
    return (na[0], na[1], neg_np(nb[0]), neg_np(nb[1]))


# -- QM31 scalars, tuples of Python ints --

def _cmul(p0, p1, q0, q1):
    return (p0 * q0 - p1 * q1) % P, (p0 * q1 + p1 * q0) % P


def qmul(a, b):
    a0, a1, a2, a3 = (int(x) for x in a)
    b0, b1, b2, b3 = (int(x) for x in b)
    ac0, ac1 = _cmul(a0, a1, b0, b1)
    bd0, bd1 = _cmul(a2, a3, b2, b3)
    ad0, ad1 = _cmul(a0, a1, b2, b3)
    bc0, bc1 = _cmul(a2, a3, b0, b1)
    rbd0, rbd1 = (2 * bd0 - bd1) % P, (bd0 + 2 * bd1) % P
    return ((ac0 + rbd0) % P, (ac1 + rbd1) % P,
            (ad0 + bc0) % P, (ad1 + bc1) % P)


def qinv(a):
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


def qadd(a, b):
    return tuple((int(x) + int(y)) % P for x, y in zip(a, b))


def qsub(a, b):
    return tuple((int(x) - int(y)) % P for x, y in zip(a, b))


def qmul_m31(a, s):
    return tuple((int(x) * int(s)) % P for x in a)


def qpow(a, e: int):
    r, base = QONE, a
    while e > 0:
        if e & 1:
            r = qmul(r, base)
        base = qmul(base, base)
        e >>= 1
    return r


def qconj(v):
    """(a, b, c, d) -> (a, b, -c, -d)."""
    return (v[0], v[1], (P - v[2]) % P, (P - v[3]) % P)
