"""Share of the traced window, in %, in which no operation ran on the
card: 1 - (union of device activity) / (window)."""

from benchmark.trace import union_ns


def read(rec):
    ev = rec.get("events")
    if not ev:
        return None
    t0, t1 = rec["t0_ns"], rec["t1_ns"]
    busy = union_ns([(max(s, t0), min(s + d, t1)) for _, s, d in ev
                     if s < t1 and s + d > t0])
    return 100.0 * (1.0 - busy / (t1 - t0))
