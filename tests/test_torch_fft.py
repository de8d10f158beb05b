"""Circle domain orderings and FFT/LDE of cairo_m_tpu_torch vs the JAX
reference, bit for bit, at log sizes 4-12."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cairo_m_tpu.prover.stark import domain as rdomain
from cairo_m_tpu.prover.stark import fft as rfft
from cairo_m_tpu_torch.prover.stark import domain, fft
from torch_port_helpers import P, to_np, to_t

LOGS = [4, 5, 8, 10, 12]


def _cols(log, k=3, seed=0):
    rng = np.random.default_rng(seed + log)
    return rng.integers(0, P, size=(k, 1 << log), dtype=np.uint32)


@pytest.mark.parametrize("log", LOGS)
def test_orderings_match_reference(log):
    v = _cols(log)
    t = to_t(v)
    np.testing.assert_array_equal(to_np(domain.to_fft_order(t)), rdomain.to_fft_order(v))
    np.testing.assert_array_equal(
        to_np(domain.from_fft_order(t)), np.asarray(rdomain.from_fft_order(jnp.asarray(v)))
    )
    np.testing.assert_array_equal(
        to_np(domain.bit_reverse(t, log)),
        np.asarray(rdomain.bit_reverse(jnp.asarray(v), log)),
    )
    np.testing.assert_array_equal(
        to_np(domain.from_fft_order(domain.to_fft_order(t))), v
    )


def _ref(fn, *static):
    """The reference transform as ONE jitted graph (eager dispatch of its
    per-level ops costs far more than the compile)."""
    return jax.jit(lambda v: fn(v, *static))


@pytest.mark.parametrize("log", LOGS)
def test_ifft_fft_match_reference(log):
    v = _cols(log, seed=1)
    coeffs = fft.ifft(to_t(v), log)
    rcoeffs = _ref(rfft.ifft, log)(jnp.asarray(v))
    np.testing.assert_array_equal(to_np(coeffs), np.asarray(rcoeffs))
    np.testing.assert_array_equal(to_np(fft.fft(coeffs, log)), v)
    np.testing.assert_array_equal(
        to_np(fft.fft(to_t(v), log)), np.asarray(_ref(rfft.fft, log)(jnp.asarray(v)))
    )


@pytest.mark.parametrize("log,gap", [(4, 1), (4, 2), (9, 1), (11, 1)])
def test_lde_matches_reference(log, gap):
    v = _cols(log, k=2, seed=2)
    got = fft.lde(to_t(v), log, log + gap)
    want = _ref(rfft.lde, log, log + gap)(jnp.asarray(v))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    # a single (1-D) column
    np.testing.assert_array_equal(to_np(fft.lde(to_t(v[0]), log, log + gap)), to_np(got[0]))


@pytest.mark.parametrize("log", [4, 10])
def test_eval_at_qpoint_matches_reference(log):
    coeffs = _cols(log, k=4, seed=3)
    z = ((5, 6, 7, 8), (123456789, 1, 2, 3))
    tws = fft.point_eval_twiddles_host(z, log)
    np.testing.assert_array_equal(tws, rfft.point_eval_twiddles_host(z, log))
    got = fft.eval_at_qpoint_folds(to_t(coeffs), log, tws)
    want = \
        jax.jit(lambda c, t: rfft.eval_at_qpoint_folds(c, log, t))(
            jnp.asarray(coeffs), jnp.asarray(tws))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@functools.lru_cache(maxsize=None)
def _ref_folds(log):
    return jax.jit(lambda c, t: rfft.eval_at_qpoint_folds(c, log, t))


def _point(seed):
    rng = np.random.default_rng(seed)
    return tuple(tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2))


@pytest.mark.parametrize("log", [1, 4, 10, 13])
@pytest.mark.parametrize("n_points", [1, 2])
@pytest.mark.parametrize("k", [1, 100])
def test_eval_at_points_matches_reference(log, n_points, k):
    """`eval_at_points`' plain route on a job table (the case's stack and a
    small one of another size and points) against the reference's jitted
    folds, job by job and point by point."""
    points = [_point(i) for i in range(n_points)]
    jobs = [(to_t(_cols(log, k=k, seed=4)), log, points),
            (to_t(_cols(3, k=5, seed=5)), 3, [points[-1], _point(7)])]
    got = to_np(fft.eval_at_points(jobs))
    off = 0
    for coeffs, job_log, zs in jobs:
        k_job = int(coeffs.shape[0])
        for z in zs:
            tws = fft.point_eval_twiddles_host(z, job_log)
            want = _ref_folds(job_log)(jnp.asarray(to_np(coeffs)),
                                       jnp.asarray(tws))
            np.testing.assert_array_equal(
                got[off : off + 4 * k_job].reshape(4, k_job), np.stack(want))
            off += 4 * k_job
    assert off == got.size


@pytest.mark.parametrize("seed", [0, 1])
def test_point_eval_twiddles_are_one_sequence(seed):
    """A point's twiddles at log size L are the last L rows of its longest
    sequence: the kernel keeps one sequence a point for every log size."""
    z = _point(seed)
    longest = fft.point_eval_twiddles_host(z, 24)
    for log in range(1, 25):
        np.testing.assert_array_equal(fft.point_eval_twiddles_host(z, log),
                                      longest[24 - log:])


@pytest.mark.parametrize("bad", ["strided", "int32", "1-D"])
def test_eval_at_points_rejects_bad_stacks(bad):
    coeffs = to_t(_cols(4, k=4, seed=6))
    if bad == "strided":
        coeffs, match = coeffs[:, ::2], "contiguous"
        log = 3
    else:
        log = 4
        coeffs, match = {"int32": (coeffs.to(torch.int32), "int64"),
                         "1-D": (coeffs[0], r"\(k, 2\^log_size\)")}[bad]
    with pytest.raises(ValueError, match=match):
        fft.eval_at_points([(coeffs, log, [_point(0)])])
