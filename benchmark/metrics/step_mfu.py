"""The whole window's share of the card's peak, in %: the least time the
card needs at its peaks for the work the window's proofs require of the
two hand kernels (kernel A's Merkle trees and kernel B's AIR passes,
counted from the proofs' shape by `benchmark.yardstick`) over the
window's seconds.  It stays defined when a kernel leaves the path, so a
kernel's roofline cannot rise unseen by moving its work elsewhere."""

from benchmark.yardstick import HBM_BYTES_PER_S, kernel_a_seconds, kernel_b_bytes


def read(rec):
    sh = rec["shape"]
    least = (kernel_a_seconds(sh["comps"], sh["log_sizes"], sh["log_blowup"],
                              sh["log_last_layer"])
             + kernel_b_bytes(sh["comps"], sh["log_sizes"], sh["claimed_sums"],
                              sh["log_blowup"]) / HBM_BYTES_PER_S)
    return 100.0 * least * len(rec["jobs"]) / rec["window_s"]
