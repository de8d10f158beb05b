"""Prover configuration (reference prover_config.rs); counterpart of
``cairo_m_tpu.prover.config``."""

from __future__ import annotations

from dataclasses import dataclass

from .stark.fri import FriConfig
from .stark.pcs import PcsConfig


@dataclass
class ProtocolScale:
    """Sizes of the preprocessed lookup tables.

    Production (the reference protocol): the clock range check spans 2^20
    (`LOG_SIZE_RC_20`, runner lib.rs:15) and the bitwise table 3*2^16 rows
    rounded to 2^18 (preprocessed/bitwise.rs:25-100) — these floor every
    proof's commit domain at 2^21.  Tests and the multichip dryrun shrink
    them with `set_test_scale` so tiny proofs don't pay megarow commits.

    TEST SCALE IS NOT THE PRODUCTION PROTOCOL: it is only sound for traces
    whose total clock count stays below 2^rc_big_bits (no clock-update gaps
    the native adapter, pinned at 2^20, would miss) and that execute no
    bitwise opcodes when bitwise_log < 18.
    """

    rc_big_bits: int = 20
    bitwise_log: int = 18

    def rc_limit(self) -> int:
        return (1 << self.rc_big_bits) - 1

    def key(self):
        return (self.rc_big_bits, self.bitwise_log)


SCALE = ProtocolScale()


def set_test_scale(rc_big_bits: int = 10, bitwise_log: int = 8):
    """Shrink the preprocessed tables (see ProtocolScale docstring)."""
    assert rc_big_bits > 8 and bitwise_log >= 4
    SCALE.rc_big_bits = rc_big_bits
    SCALE.bitwise_log = bitwise_log


def set_production_scale():
    SCALE.rc_big_bits = 20
    SCALE.bitwise_log = 18

# 96-bit conjectured security: n_queries*log_blowup + pow_bits = 96
REGULAR_96_BITS = PcsConfig(
    pow_bits=16,
    fri_config=FriConfig(
        log_blowup_factor=1, log_last_layer_degree_bound=0, n_queries=80
    ),
)

# Same security numbers under the stwo framing: stwo's Blake2sChannel byte
# framing + one mixed-degree Merkle tree per phase (stark/stwo_merkle.py).
STWO_FRAMING_96_BITS = PcsConfig(
    pow_bits=16,
    fri_config=FriConfig(
        log_blowup_factor=1, log_last_layer_degree_bound=0, n_queries=80
    ),
    framing="stwo",
)


def test_config(n_queries=12, pow_bits=4, framing="native") -> PcsConfig:
    """Small config for fast tests (NOT production security)."""
    return PcsConfig(
        pow_bits=pow_bits,
        fri_config=FriConfig(
            log_blowup_factor=1, log_last_layer_degree_bound=0, n_queries=n_queries
        ),
        framing=framing,
    )
