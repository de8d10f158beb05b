"""Kernel B's share of its bytes roofline, in %: the bytes the AIR's
interaction and composition passes must move for the window's proofs
(`benchmark.yardstick`) at the card's HBM rate, over the device time of
B's kernels (the wide-tape plan kernels) in the trace."""

from benchmark.yardstick import HBM_BYTES_PER_S, kernel_b_bytes


def read(rec):
    ev = rec.get("events")
    if not ev:
        return None
    ns = sum(d for name, _, d in ev if "wtape" in name)
    if not ns:
        return None
    sh = rec["shape"]
    least = kernel_b_bytes(sh["comps"], sh["log_sizes"], sh["claimed_sums"],
                           sh["log_blowup"]) / HBM_BYTES_PER_S * len(rec["jobs"])
    return 100.0 * least / (ns / 1e9)
