"""The protocol's scale and security configuration, as the verifier states
them (the reference prover's ``prover_config.rs`` and runner constants).

Production: the clock range check spans 2^20 and the bitwise table 2^18
rows.  ``protocol_scale`` sets other sizes for a block (the CPU tests shrink
both for their small proofs).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

TREE_HEIGHT = 30  # the adapter's memory Merkle tree depth
INTERACTION_POW_BITS = 2


@dataclass
class ProtocolScale:
    rc_big_bits: int = 20
    bitwise_log: int = 18

    def rc_limit(self) -> int:
        return (1 << self.rc_big_bits) - 1

    def key(self):
        return (self.rc_big_bits, self.bitwise_log)


SCALE = ProtocolScale()


def rc_limit() -> int:
    return SCALE.rc_limit()


@contextmanager
def protocol_scale(rc_big_bits: int, bitwise_log: int):
    """Within the block, the verifier expects tables of these sizes (the
    tests shrink them for their small proofs)."""
    saved = SCALE.key()
    SCALE.rc_big_bits, SCALE.bitwise_log = rc_big_bits, bitwise_log
    try:
        yield
    finally:
        SCALE.rc_big_bits, SCALE.bitwise_log = saved


@dataclass(frozen=True)
class SecurityConfig:
    """pow_bits + log_blowup * n_queries bits of conjectured security."""

    pow_bits: int = 16
    log_blowup: int = 1
    log_last_layer_degree_bound: int = 0
    n_queries: int = 80

    @property
    def log_last_layer_size(self) -> int:
        return self.log_last_layer_degree_bound + self.log_blowup

    def mix_into(self, channel):
        channel.mix_u64(self.pow_bits)
        channel.mix_u64(self.log_blowup)
        channel.mix_u64(self.log_last_layer_degree_bound)
        channel.mix_u64(self.n_queries)


REGULAR_96_BITS = SecurityConfig()
