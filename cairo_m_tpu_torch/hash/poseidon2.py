"""Poseidon2 permutation over M31, T=16 (vectorized host path).

Matches the reference permutation structure exactly
(`crates/prover/src/components/poseidon2.rs:95-310` and
`src/poseidon2.rs:24-37`):

    state = M_E(state)                      # initial external linear layer
    4 x full round:    state = M_E(sbox(state + rc))
    14 x partial round: state[0] = sbox(state[0] + rc); state = M_I(state)
    4 x full round:    state = M_E(sbox(state + rc))

with S-box x^5, external matrix M_E = circ(2*M4, M4, M4, M4) (addition-only
M4 from eprint 2023/323 §5.1), and internal matrix
``M_I(state)[i] = diag[i]*state[i] + sum(state)``.

Two-to-one hash (`src/poseidon2.rs:27-36`): ``hash(l, r)`` permutes
``[l, r, 0..0]`` and returns ``state[0]``.

States are *stacked* ``(..., 16)`` arrays.  Counterpart of
``cairo_m_tpu.hash.poseidon2``: the same round code runs on NumPy uint32
arrays (``permute_np``, ``hash2_np``: the host path the prover uses for the
adapter Merkle trees and witness generation) and on int64 torch tensors on
their own device (``permute_t``, ``hash2_t``: the counterparts of the
reference's ``permute_jax`` and ``hash2_jax``) through one op bundle.
"""

from __future__ import annotations

import numpy as np
import torch

from ..field import m31
from .poseidon2_params import (  # noqa: F401
    active_params,
    DEFAULT_PARAMS,
    FULL_ROUNDS,
    PARTIAL_ROUNDS,
    T,
    Poseidon2Params,
)

TREE_HEIGHT = 30  # adapter Merkle tree depth (merkle.rs:57-62)


class _Ops:
    __slots__ = ("add", "mul", "xp")

    def __init__(self, add, mul, xp):
        self.add = add
        self.mul = mul
        self.xp = xp


NP_OPS = _Ops(m31.add_np, m31.mul_np, np)


class _TorchXp:
    """The array functions `permute_stacked` calls, for tensors on one
    device (round constants become int64 tensors there)."""

    stack = staticmethod(torch.stack)
    concatenate = staticmethod(torch.concatenate)

    def __init__(self, device):
        self.device = device

    def asarray(self, a):
        return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)


def _apply_m4_stacked(x, o: _Ops):
    """M4 on shape (..., 4, 4): last axis is the 4-vector, axis -2 the group.

    Same t0..t7 dataflow as the reference `apply_m4` (poseidon2.rs:95-113).
    """
    add = o.add
    x0, x1, x2, x3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    t0 = add(x0, x1)
    t02 = add(t0, t0)
    t1 = add(x2, x3)
    t12 = add(t1, t1)
    t2 = add(add(x1, x1), t1)
    t3 = add(add(x3, x3), t0)
    t4 = add(add(t12, t12), t3)
    t5 = add(add(t02, t02), t2)
    t6 = add(t3, t5)
    t7 = add(t2, t4)
    return o.xp.stack([t6, t5, t7, t4], axis=-1)


def apply_external_round_matrix(state, o: _Ops):
    """M_E = circ(2*M4, M4, M4, M4) on stacked (..., 16) state."""
    add = o.add
    g = state.reshape(state.shape[:-1] + (4, 4))
    g = _apply_m4_stacked(g, o)
    # s_j = sum over the 4 groups of column j; add to every group
    s = g[..., 0, :]
    for i in range(1, 4):
        s = add(s, g[..., i, :])
    g = add(g, s[..., None, :])
    return g.reshape(state.shape)


def apply_internal_round_matrix(state, o: _Ops, diag):
    """M_I(state)[i] = diag[i]*state[i] + sum(state)."""
    total = state[..., 0]
    for i in range(1, T):
        total = o.add(total, state[..., i])
    return o.add(o.mul(state, diag), total[..., None])


def _sbox(x, o: _Ops):
    x2 = o.mul(x, x)
    x4 = o.mul(x2, x2)
    return o.mul(x4, x)


def permute_stacked(state, o: _Ops, params: Poseidon2Params = None):
    """Full permutation on stacked (..., 16) uint32 state."""
    params = params or active_params()
    ext_rc = o.xp.asarray(params.external_rc)  # (8, 16)
    int_rc = o.xp.asarray(params.internal_rc)  # (14,)
    diag = o.xp.asarray(params.internal_diag)  # (16,)
    state = apply_external_round_matrix(state, o)
    for r in range(FULL_ROUNDS // 2):
        state = o.add(state, ext_rc[r])
        state = _sbox(state, o)
        state = apply_external_round_matrix(state, o)
    for r in range(PARTIAL_ROUNDS):
        s0 = _sbox(o.add(state[..., 0], int_rc[r]), o)
        state = o.xp.concatenate([s0[..., None], state[..., 1:]], axis=-1)
        state = apply_internal_round_matrix(state, o, diag)
    for r in range(FULL_ROUNDS // 2):
        state = o.add(state, ext_rc[FULL_ROUNDS // 2 + r])
        state = _sbox(state, o)
        state = apply_external_round_matrix(state, o)
    return state


def permute_np(states: np.ndarray, params: Poseidon2Params = None):
    """Host batched permutation: (n, 16) -> (n, 16)."""
    return permute_stacked(np.asarray(states, dtype=np.uint32), NP_OPS, params)


def permute_t(states: torch.Tensor, params: Poseidon2Params = None):
    """Batched permutation on stacked (..., 16) int64 tensors holding M31
    values, on the tensors' device."""
    ops = _Ops(m31.add, m31.mul, _TorchXp(states.device))
    return permute_stacked(states, ops, params)


def hash2_t(left: torch.Tensor, right: torch.Tensor, params=None):
    """Two-to-one hash on int64 tensors: permute([l, r, 0..0])[0]."""
    zero = torch.zeros_like(left)
    state = torch.stack([left, right] + [zero] * (T - 2), dim=-1)
    return permute_t(state, params)[..., 0]


def hash2_np(left: np.ndarray, right: np.ndarray, params=None):
    """Two-to-one hash, vectorized on host: digest = permute([l,r,0..0])[0]."""
    params = params or active_params()
    left = np.asarray(left, dtype=np.uint32)
    state = np.zeros(left.shape + (T,), dtype=np.uint32)
    state[..., 0] = left
    state[..., 1] = np.asarray(right, dtype=np.uint32)
    return permute_np(state, params)[..., 0]


_DEFAULT_HASHES_CACHE: dict[str, np.ndarray] = {}


def default_hashes(params: Poseidon2Params = None) -> np.ndarray:
    """Per-depth default subtree hashes (all-zero leaves), depth 0..TREE_HEIGHT.

    `defaults[TREE_HEIGHT] = 0`; `defaults[d] = hash(defaults[d+1], defaults[d+1])`
    (reference `src/poseidon2.rs:38-57`).
    """
    params = params or active_params()
    if params.name not in _DEFAULT_HASHES_CACHE:
        defaults = np.zeros(TREE_HEIGHT + 1, dtype=np.uint32)
        for depth in range(TREE_HEIGHT - 1, -1, -1):
            child = defaults[depth + 1]
            defaults[depth] = hash2_np(
                np.array([child]), np.array([child]), params
            )[0]
        _DEFAULT_HASHES_CACHE[params.name] = defaults
    return _DEFAULT_HASHES_CACHE[params.name]
