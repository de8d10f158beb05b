"""Poseidon2-M31 instance parameters (T=16, 8 full + 14 partial rounds).

The reference derives its round constants and internal-matrix diagonal from
the `zkhash` crate (`poseidon2_instance_m31::{RC16, MAT_DIAG16_M_1}`, consumed
by `crates/prover/build.rs:24-33`).  Those exact constants are
not recoverable in this offline environment, so this module generates an
equivalent instance deterministically from a seed string using SHAKE-256
rejection sampling — cryptographically neutral, reproducible, and documented.

**Bit-parity hook:** every consumer reads the constants through
:class:`Poseidon2Params`; dropping the zkhash values into
``EXTERNAL_ROUND_CONSTS`` / ``INTERNAL_ROUND_CONSTS`` / ``INTERNAL_MATRIX``
below is a one-file change that makes the whole stack (adapter Merkle trees,
poseidon2 AIR, program ids) hash-compatible with the Rust reference.

Layout mirrors the generated ``poseidon2_constants.rs``:

- ``EXTERNAL_ROUND_CONSTS[8][16]`` — full-round constants; rows 0..4 are the
  first half, rows 4..8 the second half.
- ``INTERNAL_ROUND_CONSTS[14]`` — partial-round constants (element 0 only).
- ``INTERNAL_MATRIX[16]`` — diagonal of the internal linear layer
  (applied as ``state[i]*diag[i] + sum(state)``).
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field

import numpy as np

P = (1 << 31) - 1

T = 16
FULL_ROUNDS = 8
PARTIAL_ROUNDS = 14


def _shake_m31_stream(seed: str, count: int) -> np.ndarray:
    """Deterministic M31 elements: SHAKE-256(seed) → u32 LE words, rejecting
    values >= 2^31 - 1 (uniform over [0, P))."""
    out = []
    h = hashlib.shake_256(seed.encode())
    # Draw generously; extend if rejection leaves us short.
    n_bytes = count * 8
    buf = h.digest(n_bytes)
    i = 0
    while len(out) < count:
        if i + 4 > len(buf):
            n_bytes *= 2
            buf = hashlib.shake_256(seed.encode()).digest(n_bytes)
        w = int.from_bytes(buf[i : i + 4], "little") & 0x7FFFFFFF
        i += 4
        if w < P:
            out.append(w)
    return np.array(out, dtype=np.uint32)


@dataclass(frozen=True)
class Poseidon2Params:
    external_rc: np.ndarray  # (FULL_ROUNDS, T) uint32
    internal_rc: np.ndarray  # (PARTIAL_ROUNDS,) uint32
    internal_diag: np.ndarray  # (T,) uint32
    name: str = "cairo-m-tpu/poseidon2-m31-t16-shake256-v1"

    @staticmethod
    def generate(seed: str = "cairo-m-tpu/poseidon2-m31-t16-shake256-v1") -> "Poseidon2Params":
        ext = _shake_m31_stream(seed + "/external", FULL_ROUNDS * T).reshape(
            FULL_ROUNDS, T
        )
        internal = _shake_m31_stream(seed + "/internal", PARTIAL_ROUNDS)
        diag = _shake_m31_stream(seed + "/diag", T)
        return Poseidon2Params(ext, internal, diag, name=seed)


# --- Default instance -------------------------------------------------------
# Replace the three arrays with zkhash's RC16 / MAT_DIAG16_M_1 values to get
# bit-parity with the Rust reference prover.
_DEFAULT = Poseidon2Params.generate()

EXTERNAL_ROUND_CONSTS: np.ndarray = _DEFAULT.external_rc
INTERNAL_ROUND_CONSTS: np.ndarray = _DEFAULT.internal_rc
INTERNAL_MATRIX: np.ndarray = _DEFAULT.internal_diag

DEFAULT_PARAMS = Poseidon2Params(
    EXTERNAL_ROUND_CONSTS, INTERNAL_ROUND_CONSTS, INTERNAL_MATRIX, _DEFAULT.name
)


# --- Active-instance hook ---------------------------------------------------
# Consumers resolve parameters at CALL time through ``active_params()`` so a
# drop-in replacement (e.g. the zkhash constants for reference bit-parity)
# can be installed at run time without touching import-time bindings.
# Tested by tests/test_prover_e2e.py::test_external_poseidon2_constants.

_ACTIVE: list = [DEFAULT_PARAMS]


def active_params() -> Poseidon2Params:
    return _ACTIVE[-1]


from contextlib import contextmanager


@contextmanager
def use_params(params: Poseidon2Params):
    """Scoped swap of the Poseidon2 instance (adapter trees, AIR, ids)."""
    _ACTIVE.append(params)
    try:
        yield params
    finally:
        _ACTIVE.pop()
