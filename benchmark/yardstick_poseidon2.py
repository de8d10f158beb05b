"""The yardstick of the Poseidon2 witness kernel's roofline: the bytes a
proof's shape fixes for the ``poseidon2`` component's witness, counted
from the proof (the component's log size and the AIR's column count,
`reference/components`), never from what the program launched.

Each of the component's 2^log rows reads its 16 input words once and
writes its 443 columns once, 4 bytes an M31 value, at the card's HBM rate
(`yardstick.HBM_BYTES_PER_S`).  The permutation's integer operations
(~1,900 a row) stay below the bytes' time on an H100, so the bytes bound
it.
"""

from __future__ import annotations

from benchmark.yardstick import HBM_BYTES_PER_S, WORD_BYTES

STATE_WORDS = 16  # a row's input state


def poseidon2_witness_bytes(comps, log_sizes) -> int:
    """Bytes the ``poseidon2`` witness must move for one proof."""
    for c, l in zip(comps, log_sizes):
        if c.name == "poseidon2":
            return (1 << l) * (c.n_trace_cols + STATE_WORDS) * WORD_BYTES
    raise ValueError("the proof has no poseidon2 component")


def poseidon2_witness_seconds(comps, log_sizes) -> float:
    return poseidon2_witness_bytes(comps, log_sizes) / HBM_BYTES_PER_S
