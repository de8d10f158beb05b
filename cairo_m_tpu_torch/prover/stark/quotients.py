"""DEEP quotients: reduce "column f equals v at OODS point z" to low-degree.

Standard circle-STARK pair-vanishing construction (role of stwo's
`core::pcs::quotients`):  with ``conj`` the QM31/CM31 conjugation
``(A + Bu) -> (A - Bu)`` (an automorphism fixing M31, so real columns
satisfy ``f(conj z) = conj f(z)``), each (column, point z, value v) yields

    a = conj(v) - v
    c = conj(z).y - z.y           (shared by all columns sampled at z)
    b = v*c - a*z.y
    numerator_i(p)  = c*f_i(p) - (a_i*y_p + b_i)
    denominator_z(p) = (x_p - z.x)*(conj(z).y - z.y) - (y_p - z.y)*(conj(z).x - z.x)

(a line through z and conj z).  The quotient column for log_size l is

    Q_l(p) = sum_z  [ sum_i alpha^{k_i} * numerator_i(p) ] / denominator_z(p)

with one global alpha and k_i enumerating (tree, column, point) in
commitment order.  Q_l is low-degree iff every sampled value is correct.

Device path evaluates Q_l over full commit domains (batched, weights folded
into one QM31xM31 contraction per point); host path recomputes Q_l at query
positions for the FRI verifier.  Counterpart of
``cairo_m_tpu.prover.stark.quotients`` on torch tensors.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ...field import m31
from ...field.qm31 import qadd, qinv, qmul, qmul_m31, qsub
from ...parallel import sharded
from .. import observe
from .fri import QZERO, qscalar_add, qscalar_mul, qscalar_mul_m31, qscalar_sub
from . import domain

P = (1 << 31) - 1


def qconj(v):
    """QM31/CM31 conjugation: (a, b, c, d) -> (a, b, -c, -d)."""
    return (v[0], v[1], (P - v[2]) % P, (P - v[3]) % P)


def line_coeffs(z, v):
    """(a, b, c) for one (point, value) sample (host scalars)."""
    zx, zy = z
    a = qscalar_sub(qconj(v), v)
    c = qscalar_sub(qconj(zy), zy)
    b = qscalar_sub(qscalar_mul(v, c), qscalar_mul(a, zy))
    return a, b, c


def denominator_coeffs(z):
    """(dx, dy, dc): d(p) = dx*x_p + dy*y_p + dc (host scalars)."""
    zx, zy = z
    dx = qscalar_sub(qconj(zy), zy)
    dy = qscalar_sub(zx, qconj(zx))
    dc = qscalar_sub(
        qscalar_mul(qconj(zx), zy), qscalar_mul(zx, qconj(zy))
    )
    # d(p) = (x - zx)*(conj(zy) - zy) - (y - zy)*(conj(zx) - zx)
    #      = dx*x + dy*y + (zy*conj(zx) - zx*conj(zy))
    return dx, dy, dc


def denominator_at(z, px: int, py: int):
    """d(p) for a base-field point (host scalar)."""
    dx, dy, dc = denominator_coeffs(z)
    return qscalar_add(
        qscalar_add(qscalar_mul_m31(dx, px), qscalar_mul_m31(dy, py)), dc
    )


class ColumnSampleBatch:
    """All samples at one point z for columns of one log_size:
    (z, [(column_ref, value, alpha_pow)])."""

    def __init__(self, z):
        self.z = z
        self.entries = []  # (column array or opened dict, value, alpha_pow)


def group_samples(samples):
    """samples: iterable of (log_size, column_handle, z, value, alpha_pow)
    -> {log_size: [ColumnSampleBatch]} preserving point order."""
    out: dict[int, list] = {}
    for log_size, col, z, v, apow in samples:
        batches = out.setdefault(log_size, [])
        for b in batches:
            if b.z == z:
                b.entries.append((col, v, apow))
                break
        else:
            b = ColumnSampleBatch(z)
            b.entries.append((col, v, apow))
            batches.append(b)
    return out


_ROW_CHUNK = 64


def _batch_term(cols, w, wa, wb, c, dx, dy, dc, px, py):
    """Quotient term of one sample batch: cols (k, n) device, w (k, 4)
    int64 device weights, the rest host QM31 tuples, px/py (n,) device
    -> 4 x (n,)."""
    # wf_j = sum_i w[i,j] * cols[i], in row chunks so the (chunk, n)
    # product temporaries stay small; partial sums of reduced products stay
    # far below 2^63
    wf = []
    for j in range(4):
        acc = 0
        for s in range(0, cols.shape[0], _ROW_CHUNK):
            prod = m31.mul(w[s : s + _ROW_CHUNK, j][:, None], cols[s : s + _ROW_CHUNK])
            acc = acc + prod.sum(dim=0)
        wf.append(acc % P)
    numer = qsub(qmul(wf, c), qadd(qmul_m31(wa, py), wb))
    den = qadd(qadd(qmul_m31(dx, px), qmul_m31(dy, py)), dc)
    return qmul(numer, qinv(den))


@lru_cache(maxsize=None)
def _fft_points(log_size: int, device: torch.device):
    xs, ys = domain.coset_points(log_size)
    return tuple(
        torch.from_numpy(domain.to_fft_order(v).astype(np.int64)).to(device)
        for v in (xs, ys)
    )


def quotient_column_device(log_size: int, batches, stacks):
    """Evaluate Q_l over the full commit domain in FFT order on the stacks'
    device.  Column handles are (stack_key, row) pairs into ``stacks`` — a
    dict of (K, n) FFT-order column stacks (one per commitment phase);
    gathering per stack avoids materializing their concatenation.

    FFT order (not commit order) so the FRI prover folds contiguous
    halves."""
    total = None
    for b in batches:
        k = len(b.entries)
        # entries arrive phase by phase -> contiguous runs per stack
        pieces = []
        run_key, run_rows = None, []
        for (key, row), _, _ in b.entries:
            if key != run_key and run_rows:
                pieces.append(_take_rows(stacks[run_key], run_rows))
                run_rows = []
            run_key = key
            run_rows.append(row)
        if run_rows:
            pieces.append(_take_rows(stacks[run_key], run_rows))
        cols = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
        device = cols.device
        px, py = _fft_points(log_size, device)
        # a cyclic share of a row mesh (parallel/sharded.py) meets its lanes'
        # points
        px = sharded.share_of(px, cols, log_size)
        py = sharded.share_of(py, cols, log_size)
        w = np.zeros((k, 4), dtype=np.int64)
        wa, wb = QZERO, QZERO
        _, _, c = line_coeffs(b.z, b.entries[0][1])
        for i, (col, v, apow) in enumerate(b.entries):
            a_i, b_i, _ = line_coeffs(b.z, v)
            wa = qscalar_add(wa, qscalar_mul(apow, a_i))
            wb = qscalar_add(wb, qscalar_mul(apow, b_i))
            w[i] = apow
        dx, dy, dc = denominator_coeffs(b.z)
        term = _batch_term(
            cols, observe.push(w, device), wa, wb, c, dx, dy, dc, px, py,
        )
        total = term if total is None else qadd(total, term)
    return total


def _take_rows(stack, rows):
    idx = observe.push(np.asarray(rows, np.int64), stack.device)
    return stack.index_select(0, idx)


def quotient_value_host(log_size: int, batches, pos: int):
    """Recompute Q_l at one commit-order position from opened values (host).

    Column handles in ``batches`` are dicts {position: int value}."""
    px, py = domain.commit_pos_point(pos, log_size)
    total = QZERO
    for b in batches:
        wa, wb, wfv = QZERO, QZERO, QZERO
        _, _, c = line_coeffs(b.z, b.entries[0][1])
        for col, v, apow in b.entries:
            a_i, b_i, _ = line_coeffs(b.z, v)
            wa = qscalar_add(wa, qscalar_mul(apow, a_i))
            wb = qscalar_add(wb, qscalar_mul(apow, b_i))
            wfv = qscalar_add(wfv, qscalar_mul_m31(apow, col[pos]))
        numer = qscalar_sub(
            qscalar_mul(wfv, c),
            qscalar_add(qscalar_mul_m31(wa, py), wb),
        )
        den = denominator_at(b.z, px, py)
        from .fri import qscalar_mul as qm

        total = qscalar_add(total, qm(numer, _qscalar_inv(den)))
    return total


def _qscalar_inv(v):
    from .fri import qscalar_inv

    return qscalar_inv(v)
