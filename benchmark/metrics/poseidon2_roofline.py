"""The Poseidon2 witness kernel's share of its roofline, in %: the least
time the card needs for the bytes of the window's proofs' ``poseidon2``
witnesses (their shape, counted by `benchmark.yardstick_poseidon2`) over
the device time of the kernels whose name holds ``poseidon2`` in the
trace.  Nothing to read where no such kernel ran."""

from benchmark.yardstick_poseidon2 import poseidon2_witness_seconds


def read(rec):
    ev = rec.get("events")
    if not ev:
        return None
    ns = sum(d for name, _, d in ev if "poseidon2" in name)
    if not ns:
        return None
    sh = rec["shape"]
    least = poseidon2_witness_seconds(sh["comps"], sh["log_sizes"]) * len(rec["jobs"])
    return 100.0 * least / (ns / 1e9)
