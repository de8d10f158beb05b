"""The traced run's device record: CUDA activity only, read from the
profiler's raw events (a CPU-activity trace of whole proofs would cost
more than the proofs), put on the harness's clock, and reduced to busy
time, idle gaps and time by kernel.

The profiler's event times and the harness's ``time.monotonic_ns`` spans
are tied by a marker: a one-element kernel launched after a device sync,
whose end the host sees when the next sync returns.  The offset is taken
at both ends of the window; their difference is the clock's disagreement
over it, reported as ``clock_skew_us``.
"""

from __future__ import annotations

import time

MARKER = "bitwise_not"  # the marker kernel's name contains this


def _marker(torch, device) -> int:
    """Launch the marker after a sync; -> host ns when it is known done."""
    x = torch.zeros(1, dtype=torch.int32, device=device)
    torch.cuda.synchronize(device)
    torch.bitwise_not(x)
    torch.cuda.synchronize(device)
    return time.monotonic_ns()


class DeviceTrace:
    """Context manager around the measured window."""

    def __init__(self, torch, device):
        self.torch, self.device = torch, device
        self.events = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t_open = _marker(self.torch, self.device)
        return self

    def __exit__(self, *exc):
        self.t_close = _marker(self.torch, self.device)
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return False
        cuda = self.torch.autograd.DeviceType.CUDA
        raw = [(e.name(), e.start_ns(), e.duration_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type() == cuda]
        marks = [s + d for n, s, d in raw if MARKER in n]
        # the first and last marker kernels bracket the window
        off_open, off_close = self.t_open - marks[0], self.t_close - marks[-1]
        self.clock_skew_us = (off_close - off_open) / 1e3
        self.events = [(n, s + off_open, d) for n, s, d in raw if MARKER not in n]
        return False


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def merged_ns(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint [start, end]
    pairs: what a segment worker keeps of its trace."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_gaps(events, t0: int, t1: int):
    """[(start, end)] of the window's stretches with no device activity."""
    gaps, cur = [], t0
    for a, b in sorted((s, s + d) for _, s, d in events):
        if a > cur:
            gaps.append((cur, min(a, t1)))
        cur = max(cur, b)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    return [(a, b) for a, b in gaps if b > a]


def by_name(events) -> dict:
    out: dict = {}
    for n, _, d in events:
        out[n] = out.get(n, 0) + d
    return out


def label_gaps(gaps, spans):
    """Idle seconds by the harness span that holds each gap's midpoint
    (spans: [(name, start_ns, end_ns)]); a gap in no span is ``harness``."""
    out: dict = {}
    for a, b in gaps:
        mid = (a + b) // 2
        name = next((n for n, s, e in spans if s <= mid < e), "harness")
        out[name] = out.get(name, 0) + (b - a)
    return out
