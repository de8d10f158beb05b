"""Circle FFT / iFFT over M31 on torch tensors — the prover's core transform.

Counterpart of ``cairo_m_tpu.prover.stark.fft``.  Evaluations are stored in
**FFT order** (see `domain.py`): level j butterflies pair contiguous
half-blocks (i, i + len/2), so every level is a reshape plus elementwise
ops, and the leading axes batch any number of columns.

Coefficients come out in the circle-FFT basis
``b_j = y^{j0} * x^{j1} * pi(x)^{j2} * ... , pi(x) = 2x^2 - 1`` with the
y-bit as the index MSB and deeper pi-powers toward the LSB, so a size-2^L
coefficient vector embeds into a size-2^L' one at indices ``i << (L' - L)``.

Under a row mesh (parallel/sharded.py) `ifft` takes a cyclic share of
FFT-order evaluations and returns the block share of the coefficients,
`fft` the reverse, and `eval_at_qpoint_folds` adds the ranks' partial sums.

`eval_at_points` evaluates a whole sample step of the polynomial commitment
(every stack at each of its QM31 points): on the card in one launch of
``csrc/point_eval.cu`` (and one of its sum), on the CPU by the folds.

The TPU package splits large transforms into a two-stage transposed layout
and pads the batch axis around it (``_pad_lead``); both work around TPU lane
width and an XLA TPU miscompile and are not carried over: every level here
is one reshape of the natural layout.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ... import kernels
from ...field import m31
from ...parallel import sharded
from . import domain

P = (1 << 31) - 1


@lru_cache(maxsize=None)
def twiddles_dev(log_size: int, inverse: bool, device: torch.device):
    """Per-level (inverse) twiddles as int64 tensors on ``device``, uploaded
    once per process and shared by every transform of that size."""
    levels, inv_levels = domain.fft_twiddles(log_size)
    src = inv_levels if inverse else levels
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device) for t in src)


def ifft(values, log_size: int, itw=None):
    """Evaluations (..., 2^log_size) in FFT order -> coefficients.

    The 1/2 butterfly normalizations are batched into one final 2^-L scale.
    """
    v = values
    n = 1 << log_size
    if sharded.is_share(v, log_size):
        return _ifft_share(v, log_size)
    if itw is None:
        itw = twiddles_dev(log_size, True, v.device)
    lead = tuple(v.shape[:-1])
    for j in range(log_size):
        half = n >> (j + 1)
        v = v.reshape(lead + (1 << j, 2, half))
        a = v[..., 0, :]
        b = v[..., 1, :]
        f0 = m31.add(a, b)
        f1 = m31.mul(m31.sub(a, b), itw[j])
        v = torch.stack([f0, f1], dim=-2)
    v = v.reshape(lead + (n,))
    scale = pow((P + 1) // 2, log_size, P)  # 2^-log_size
    return m31.mul(v, scale)


def fft(coeffs, log_size: int, tw=None):
    """Coefficients -> evaluations (..., 2^log_size) in FFT order."""
    v = coeffs
    n = 1 << log_size
    if sharded.is_share(v, log_size):
        return _fft_share(v, log_size)
    if tw is None:
        tw = twiddles_dev(log_size, False, v.device)
    lead = tuple(v.shape[:-1])
    for j in range(log_size - 1, -1, -1):
        half = n >> (j + 1)
        v = v.reshape(lead + (1 << j, 2, half))
        a = v[..., 0, :]
        b = m31.mul(v[..., 1, :], tw[j])
        v = torch.stack([m31.add(a, b), m31.sub(a, b)], dim=-2)
    return v.reshape(lead + (n,))


def embed_coeffs(coeffs, log_size: int, eval_log_size: int):
    """Embed a coefficient vector into the bigger basis (index << gap).

    Under a row mesh a block share embeds into the block share of the
    bigger basis in place (block r of both holds the same indices' images),
    and a whole vector whose image is split keeps this rank's block."""
    gap = eval_log_size - log_size
    assert gap >= 0
    if gap == 0:
        return coeffs
    lead = tuple(coeffs.shape[:-1])
    n = int(coeffs.shape[-1])
    big = coeffs.new_zeros(lead + (n, 1 << gap))
    big[..., 0] = coeffs
    big = big.reshape(lead + (n << gap,))
    if not sharded.is_share(coeffs, log_size):
        big = sharded.block_share(big)
    return big


# ---------------------------------------------------------------------------
# Row-sharded transforms (parallel/sharded.py: evaluations in cyclic shares,
# coefficients in block shares)
# ---------------------------------------------------------------------------


def _ifft_share(v, log_size: int):
    """`ifft` of a cyclic FFT-order share -> the coefficients' block share.
    Levels that pair lanes at a distance >= D run on the cyclic share with
    every D-th twiddle; one all-to-all turns it into blocks, in which the
    last log2(D) levels are local."""
    mesh = sharded.active_mesh()
    D, d = mesh.world_size, mesh.log_ws
    n = 1 << log_size
    nl = n // D
    itw = twiddles_dev(log_size, True, v.device)
    lead = tuple(v.shape[:-1])
    for j in range(log_size - d):
        half = (n >> (j + 1)) // D
        v = v.reshape(lead + (1 << j, 2, half))
        a = v[..., 0, :]
        b = v[..., 1, :]
        f1 = m31.mul(m31.sub(a, b), sharded.cyclic_slice(itw[j]))
        v = torch.stack([m31.add(a, b), f1], dim=-2)
    v = sharded.cyclic_to_block(v.reshape(lead + (nl,)))
    for j in range(log_size - d, log_size):
        half = n >> (j + 1)
        v = v.reshape(lead + (nl // (2 * half), 2, half))
        a = v[..., 0, :]
        b = v[..., 1, :]
        f1 = m31.mul(m31.sub(a, b), itw[j])
        v = torch.stack([m31.add(a, b), f1], dim=-2)
    scale = pow((P + 1) // 2, log_size, P)
    return m31.mul(v.reshape(lead + (nl,)), scale)


def _fft_share(v, log_size: int):
    """`fft` of a block share of coefficients -> the evaluations' cyclic
    FFT-order share (the mirror of `_ifft_share`)."""
    mesh = sharded.active_mesh()
    D, d = mesh.world_size, mesh.log_ws
    n = 1 << log_size
    nl = n // D
    tw = twiddles_dev(log_size, False, v.device)
    lead = tuple(v.shape[:-1])
    for j in range(log_size - 1, log_size - d - 1, -1):
        half = n >> (j + 1)
        v = v.reshape(lead + (nl // (2 * half), 2, half))
        a = v[..., 0, :]
        b = m31.mul(v[..., 1, :], tw[j])
        v = torch.stack([m31.add(a, b), m31.sub(a, b)], dim=-2)
    v = sharded.block_to_cyclic(v.reshape(lead + (nl,)))
    for j in range(log_size - d - 1, -1, -1):
        half = (n >> (j + 1)) // D
        v = v.reshape(lead + (1 << j, 2, half))
        a = v[..., 0, :]
        b = m31.mul(v[..., 1, :], sharded.cyclic_slice(tw[j]))
        v = torch.stack([m31.add(a, b), m31.sub(a, b)], dim=-2)
    return v.reshape(lead + (nl,))


def lde(values_fft_order, log_size: int, eval_log_size: int):
    """Low-degree extension: evaluations on the size-2^log_size canonic
    domain -> evaluations on the size-2^eval_log_size one (both FFT order)."""
    coeffs = ifft(values_fft_order, log_size)
    return fft(embed_coeffs(coeffs, log_size, eval_log_size), eval_log_size)


# ---------------------------------------------------------------------------
# Point evaluation (OODS) — coefficients x QM31 circle point
# ---------------------------------------------------------------------------


def point_eval_twiddles_host(qpoint, log_size: int) -> np.ndarray:
    """QM31 twiddles for evaluating a size-2^L coefficient vector at a
    *scalar* QM31 point: a (log_size, 4) uint32 array [t_{L-1}, ..., t_0]
    with t_0 = y, t_1 = x, t_j = pi^(j-1)(x) — innermost fold first."""
    from .fri import qscalar_mul

    x, y = qpoint
    x = tuple(int(v) for v in x)
    y = tuple(int(v) for v in y)
    tws = [y]
    cur = x
    for _ in range(log_size - 1):
        tws.append(cur)
        two = tuple((2 * v) % P for v in cur)
        sq = qscalar_mul(two, cur)
        cur = ((sq[0] - 1) % P,) + tuple(sq[1:])
    return np.array(tws[::-1], dtype=np.uint32)


def eval_at_qpoint_folds(coeffs, log_size: int, tws):
    """Evaluate M31 coefficient rows (..., 2^L) at a QM31 point by halving
    folds: the evaluation is a multilinear contraction
    sum_i c[i] prod_j t_j^{bit_j(i)}, so folding the MSB first pairs the
    contiguous halves.  ``tws``: (log_size, 4) from
    `point_eval_twiddles_host`.  Returns a QM31 limb tuple of shape (...,)."""
    from ...field.qm31 import qadd, qmul

    share = sharded.is_share(coeffs, log_size)
    local_log = log_size - (sharded.active_mesh().log_ws if share else 0)
    z = torch.zeros_like(coeffs)
    v = (coeffs, z, z, z)
    for j in range(local_log - 1, -1, -1):
        half = v[0].shape[-1] // 2
        a = tuple(c[..., :half] for c in v)
        b = tuple(c[..., half:] for c in v)
        t = tuple(int(tws[j, k]) for k in range(4))
        v = qadd(a, qmul(b, t))
    v = tuple(c[..., 0] for c in v)
    if not share:
        return v
    # a block share (parallel/sharded.py): block r holds the indices whose
    # high log2(D) bits are r, so its partial sum carries the product of the
    # twiddles of those bits; the ranks' partial sums add up mod P
    from .fri import QONE, qscalar_mul

    r = sharded.active_mesh().rank
    f = QONE
    for j in range(local_log, log_size):
        if (r >> (j - local_log)) & 1:
            f = qscalar_mul(f, tuple(int(tws[j, k]) for k in range(4)))
    v = qmul(v, f)
    return tuple(sharded.psum_mod(torch.stack(v)).unbind(0))


# A job of the kernel evaluates its stack at up to this many points with one
# read of the coefficients: a log size's interaction columns are sampled at
# the point and at the previous row's.
_PE_POINTS = 2
_PE_ROW = 16  # int64 fields of a job row (csrc/point_eval.cu)
_PE_WARPS = 8  # warps of a block of the main grid
# a warp takes 2^12 coefficients of a column (or that many in whole columns)
_PE_SEG_LOG = 12


def eval_at_points(jobs) -> torch.Tensor:
    """The values of stacks of M31 coefficient columns at QM31 circle
    points: a whole sample step of the polynomial commitment in one call.

    ``jobs``: ``[(coeffs, log_size, points)]``, ``coeffs`` a contiguous
    (k, 2^log_size) int64 stack (under a row mesh, or this rank's block
    share of one), ``points`` a list of QM31 circle points.  Returns one
    int64 tensor: for each job, for each of its points, the (4, k) limbs of
    its columns' values, flattened, one after the other.  CUDA stacks go to
    ``csrc/point_eval.cu`` (two launches for all jobs); CPU stacks take the
    plain version, `eval_at_qpoint_folds` a job and point."""
    device = None
    for coeffs, log_size, _ in jobs:
        if not isinstance(coeffs, torch.Tensor) or coeffs.dim() != 2:
            raise ValueError("eval_at_points wants (k, 2^log_size) stacks")
        if coeffs.dtype != torch.int64:
            raise ValueError(f"eval_at_points wants int64 stacks, got {coeffs.dtype}")
        if not coeffs.is_contiguous():
            raise ValueError("eval_at_points wants contiguous stacks")
        sharded.is_share(coeffs, log_size)  # raises for any other length
        if device is not None and coeffs.device != device:
            raise ValueError(f"eval_at_points: stacks on {device} and {coeffs.device}")
        device = coeffs.device
    if device is None or device.type == "cpu":
        return _eval_at_points_plain(jobs)
    if device.type != "cuda":
        raise ValueError(f"eval_at_points: unsupported device {device}")
    return _eval_at_points_cuda(jobs, device)


def _eval_at_points_plain(jobs) -> torch.Tensor:
    """Plain torch version of `eval_at_points`: the halving folds."""
    vals = [
        torch.stack(eval_at_qpoint_folds(
            coeffs, log_size, point_eval_twiddles_host(z, log_size))).reshape(-1)
        for coeffs, log_size, points in jobs
        for z in points
    ]
    if not vals:
        return torch.zeros(0, dtype=torch.int64)
    return torch.cat(vals)


def _point_eval_table(jobs):
    """-> (table, twiddles, n_blocks, n_partials, n_sum_warps, n_values,
    psum): the kernel's job rows (int64, `_PE_ROW` a row, a job of more than
    `_PE_POINTS` points split) and its QM31 entries (int64, 4 a row).

    A point's twiddles are one sequence for every log size it is evaluated
    at: `point_eval_twiddles_host(z, L)` is the last L rows of
    `point_eval_twiddles_host(z, L_max)`.  Under a row mesh a block share
    contracts its local bits and its values carry the twiddles of the
    rank's high bits; a whole stack's values carry 1 on the first rank and
    0 on the others, so that one modular all-reduce of every value (`psum`)
    leaves each value on every rank."""
    mesh = sharded.active_mesh()
    shares = [sharded.is_share(c, l) for c, l, _ in jobs]
    psum = any(shares)
    tws = [(1, 0, 0, 0), (0, 0, 0, 0)]  # entry 0: one, 1: zero
    lmax, seq = {}, {}
    for _, log_size, points in jobs:
        for z in points:
            lmax[z] = max(lmax.get(z, 0), log_size)
    for z, l in lmax.items():
        seq[z] = len(tws) + l  # the entry past the rows of z's longest sequence
        tws += [tuple(int(v) for v in t) for t in point_eval_twiddles_host(z, l)]
    rows = []
    blk = part = warps = out = 0
    for (coeffs, log_size, points), share in zip(jobs, shares):
        k = int(coeffs.shape[0])
        if k == 0:
            continue
        bits = log_size - (mesh.log_ws if share else 0)
        if bits >= _PE_SEG_LOG:
            nseg = 1 << (bits - _PE_SEG_LOG)
            tasks = k * nseg
        else:
            nseg = 1
            tasks = -(-k >> (_PE_SEG_LOG - bits))
        for i in range(0, len(points), _PE_POINTS):
            pts = points[i : i + _PE_POINTS]
            row = [0] * _PE_ROW
            row[0], row[1], row[2], row[3] = coeffs.data_ptr(), k, bits, len(pts)
            for p, z in enumerate(pts):
                # row j of this log size's twiddles (index bit j) is entry
                # seq[z] - log_size + j
                row[4 + p] = seq[z] - log_size
                if share:
                    row[6 + p] = len(tws)
                    tws.append(_rank_factor(tws, row[4 + p], bits, log_size,
                                            mesh.rank))
                else:
                    row[6 + p] = 1 if psum and mesh.rank else 0
                row[8 + p] = out + p * 4 * k
            n_blocks = -(-tasks // _PE_WARPS)
            row[10:] = [part, blk, blk + n_blocks, warps, warps + len(pts) * k,
                        tasks]
            rows.append(row)
            part += len(pts) * k * nseg
            blk += n_blocks
            warps += len(pts) * k
            out += len(pts) * 4 * k
    table = np.array(rows, dtype=np.int64).reshape(-1, _PE_ROW)
    return (table, np.array(tws, dtype=np.int64), blk, part, warps, out, psum)


def _rank_factor(tws, t0: int, local: int, log_size: int, rank: int):
    """The product of the twiddle rows j (entry t0 + j) of the index bits
    j >= local that are set in this rank's block index."""
    from .fri import QONE, qscalar_mul

    f = QONE
    for j in range(local, log_size):
        if (rank >> (j - local)) & 1:
            f = qscalar_mul(f, tws[t0 + j])
    return f


def _eval_at_points_cuda(jobs, device) -> torch.Tensor:
    table, tws, n_blocks, n_part, n_warps, n_out, psum = _point_eval_table(jobs)
    out = torch.empty(n_out, dtype=torch.int64, device=device)
    if n_out == 0:
        return out
    n_jobs = int(table.shape[0])
    # the rows and entries reach the card in one copy that does not wait
    host = torch.from_numpy(np.concatenate([table.reshape(-1), tws.reshape(-1)]))
    part = torch.empty(4 * n_part, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        dev = host.pin_memory().to(device, non_blocking=True)
        err = kernels.lib().cm_point_eval(
            dev.data_ptr(), n_jobs, dev.data_ptr() + 8 * table.size,
            part.data_ptr(), out.data_ptr(), n_blocks, n_warps, _PE_SEG_LOG,
            torch.cuda.current_stream().cuda_stream,
        )
    kernels.check(err, "point_eval")
    kernels.count("point_eval", (n_jobs, n_warps))
    return sharded.psum_mod(out) if psum else out
