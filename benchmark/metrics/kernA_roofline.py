"""Kernel A's share of its roofline, in %: the least time the card needs
for the Merkle trees of the window's proofs (their shape, counted by
`benchmark.yardstick`) over the device time of A's kernels (the BLAKE2s
leaf and pyramid kernels) in the trace."""

from benchmark.yardstick import kernel_a_seconds


def read(rec):
    ev = rec.get("events")
    if not ev:
        return None
    ns = sum(d for name, _, d in ev if "blake2s" in name)
    if not ns:
        return None
    sh = rec["shape"]
    least = kernel_a_seconds(sh["comps"], sh["log_sizes"], sh["log_blowup"],
                             sh["log_last_layer"]) * len(rec["jobs"])
    return 100.0 * least / (ns / 1e9)
