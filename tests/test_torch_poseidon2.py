"""Poseidon2 on torch tensors (``hash/poseidon2.py`` ``permute_t``,
``hash2_t``) vs the NumPy path and the JAX reference's ``permute_jax`` and
``hash2_jax``, on states made from a seed with numpy.  The arithmetic is
exact, so the results must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cairo_m_tpu.hash import poseidon2 as rposeidon2
from cairo_m_tpu_torch.hash import poseidon2
from torch_port_helpers import P, to_np, to_t


@pytest.mark.parametrize("shape", [(1, 16), (257, 16), (3, 5, 16)])
def test_permute_t_matches_numpy_and_reference(shape):
    states = np.random.default_rng(shape[0]).integers(0, P, size=shape, dtype=np.uint32)
    got = to_np(poseidon2.permute_t(to_t(states)))
    np.testing.assert_array_equal(got, poseidon2.permute_np(states))
    np.testing.assert_array_equal(
        got, np.asarray(rposeidon2.permute_jax(jnp.asarray(states)))
    )


def test_hash2_t_matches_numpy_and_reference():
    rng = np.random.default_rng(7)
    left, right = rng.integers(0, P, size=(2, 1000), dtype=np.uint32)
    got = to_np(poseidon2.hash2_t(to_t(left), to_t(right)))
    np.testing.assert_array_equal(got, poseidon2.hash2_np(left, right))
    np.testing.assert_array_equal(
        got, np.asarray(rposeidon2.hash2_jax(jnp.asarray(left), jnp.asarray(right)))
    )


def test_permute_t_keeps_the_tensor_device_and_dtype():
    out = poseidon2.permute_t(torch.zeros((4, 16), dtype=torch.int64))
    assert out.dtype == torch.int64 and out.device.type == "cpu"
