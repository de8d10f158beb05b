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

The TPU package splits large transforms into a two-stage transposed layout
and pads the batch axis around it (``_pad_lead``); both work around TPU lane
width and an XLA TPU miscompile and are not carried over: every level here
is one reshape of the natural layout.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

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
