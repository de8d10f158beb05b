"""The program's own spans in a traced run: idle seconds by the program
span that holds them, and the per-layer metrics read from the spans.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as ``python3 -m benchmark.run ... --trace 1`` does (set-up
with one cold job, the window under the device trace, the same jobs and
the same sync), with a recorder of the program (``observe.record()`` of
``cairo_m_tpu_torch.prover.observe``) active around the cold job and
around each window job, and prints one JSON line: the metrics of `READERS`
beside the accepted readers that need no proof's shape, the window's idle
seconds by harness span (``idle_gaps``) and by program span
(``idle_gaps_by_span``), where those idle seconds lie (``idle_in``), and
the checks of the spans against the harness's own clocks.  It verifies no
proof: ``benchmark.run`` judges the same jobs.

A record here is `benchmark.run`'s, with ``cold_spans`` (the cold job's
spans) and, on each job, ``program_spans`` and ``program_counts``.  A
span is any object with the attributes of ``observe.Span``: ``name``,
``attrs``, ``start`` and ``end`` (``time.monotonic_ns``, the device
trace's clock), ``id``, ``parent`` and ``root``; ids are unique within one
job's spans.  Every reader returns None for a record without spans.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys

# the roots of a job's input: idle time inside them is the host VM's and
# adapter's work, children or not
ROOTS_OF_INPUT = ("vm", "adapter")


def _children(spans) -> dict:
    out: dict = {}
    for s in spans:
        if s.parent is not None:
            out.setdefault(s.parent, []).append(s)
    return out


def _union_ns(intervals) -> int:
    total, end = 0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def self_ns(span, children: dict) -> int:
    """The span's duration less the part its child spans cover."""
    kids = children.get(span.id, ())
    return (span.end - span.start) - _union_ns(
        [(max(k.start, span.start), min(k.end, span.end)) for k in kids])


def outermost(spans, names) -> list:
    """The spans named in ``names`` with no ancestor named in ``names``."""
    by_id = {s.id: s for s in spans}
    out = []
    for s in spans:
        if s.name not in names:
            continue
        p = by_id.get(s.parent)
        while p is not None and p.name not in names:
            p = by_id.get(p.parent)
        if p is None:
            out.append(s)
    return out


def paths(spans) -> dict:
    """id -> the span's names from its root, joined by ``/``."""
    by_id = {s.id: s for s in spans}
    memo: dict = {}

    def path(s):
        if s.id not in memo:
            p = by_id.get(s.parent)
            memo[s.id] = s.name if p is None else f"{path(p)}/{s.name}"
        return memo[s.id]

    for s in spans:
        path(s)
    return memo


# -- the readers --

def _per_job(rec, value):
    jobs = rec.get("jobs") or []
    if not jobs or any("program_spans" not in j for j in jobs):
        return None
    return sum(value(j) for j in jobs) / len(jobs)


def _seconds_of(name):
    return lambda j: sum(s.end - s.start for s in j["program_spans"]
                         if s.name == name) / 1e9


def vm_s(rec):
    """Mean seconds of a window job's ``vm`` span (the native VM)."""
    return _per_job(rec, _seconds_of("vm"))


def adapter_s(rec):
    """Mean seconds of a window job's ``adapter`` span (the NumPy
    assembly of the prover's input)."""
    return _per_job(rec, _seconds_of("adapter"))


def component_dispatch_s(rec):
    """Mean self seconds a window job of its ``dispatch`` spans: the host
    queueing each live component's interaction trace and composition
    contribution, plans recorded on a miss left out."""
    def value(j):
        spans = j["program_spans"]
        kids = _children(spans)
        return sum(self_ns(s, kids) for s in spans if s.name == "dispatch") / 1e9
    return _per_job(rec, value)


def host_pulls_per_proof(rec):
    """Mean ``pulls`` a window job: device-to-host transfers, each of which
    waits for the device's queue."""
    return _per_job(rec, lambda j: j["program_counts"].get("pulls", 0))


def pull_wait_s(rec):
    """Mean seconds a window job spends in its ``pull`` spans."""
    return _per_job(rec, _seconds_of("pull"))


def _cold(rec, value):
    spans = rec.get("cold_spans")
    return None if spans is None else value(spans)


def cold_plans_s(rec):
    """Seconds of the cold job's plan recordings (outermost
    ``plan_record`` spans)."""
    return _cold(rec, lambda sp: sum(
        s.end - s.start for s in outermost(sp, ("plan_record",))) / 1e9)


def cold_inverses_s(rec):
    """Seconds of the cold job's host twiddles, vanishing rows and
    coset points (outermost ``host_inverse`` spans)."""
    return _cold(rec, lambda sp: sum(
        s.end - s.start for s in outermost(sp, ("host_inverse",))) / 1e9)


def cold_preprocessed_s(rec):
    """Seconds of the cold job's ``preprocessed`` span less the plan
    recordings and host inverses inside it, which the other two count."""
    def value(spans):
        by_id = {s.id: s for s in spans}
        total = 0
        for p in (s for s in spans if s.name == "preprocessed"):
            inner = []
            for s in outermost(spans, ("plan_record", "host_inverse")):
                a = by_id.get(s.parent)
                while a is not None and a is not p:
                    a = by_id.get(a.parent)
                if a is p:
                    inner.append((s.start, s.end))
            total += (p.end - p.start) - _union_ns(inner)
        return total / 1e9
    return _cold(rec, value)


READERS = {
    "vm_s": vm_s,
    "adapter_s": adapter_s,
    "component_dispatch_s": component_dispatch_s,
    "host_pulls_per_proof": host_pulls_per_proof,
    "pull_wait_s": pull_wait_s,
    "cold_s.plans": cold_plans_s,
    "cold_s.inverses": cold_inverses_s,
    "cold_s.preprocessed": cold_preprocessed_s,
}


# -- idle time by program span --

def _timeline(spans):
    """[(t, span or None)]: from t on, the innermost open span."""
    events = sorted([(s.start, 1, s.id, s) for s in spans]
                    + [(s.end, 0, -s.id, s) for s in spans],
                    key=lambda e: e[:3])
    out, stack = [], []
    for t, is_open, _, s in events:
        if is_open:
            stack.append(s)
        elif stack and stack[-1] is s:
            stack.pop()
        else:
            stack.remove(s)
        out.append((t, stack[-1] if stack else None))
    return out


def idle_by_span(gaps, jobs) -> tuple:
    """Idle ns by the innermost program span that holds each gap's
    midpoint, named by its path (``prove/pcs/decommit/openings/pull``), or
    by the harness's span (`trace.label_gaps`) where no program span does.
    -> (ns by name, ns by where the innermost span is: ``leaf`` (a span
    without children, or ``vm``/``adapter``), ``step`` (a span whose only
    children are the pulls it waits in), ``phase_self`` (another span's
    own time between its children), ``harness``)."""
    from .trace import label_gaps

    points, names, kind = [], {}, {}
    for k, j in enumerate(jobs):
        spans = j["program_spans"]
        kids = _children(spans)
        for sid, path in paths(spans).items():
            names[(k, sid)] = path
        for s in spans:
            mine = kids.get(s.id, ())
            kind[(k, s.id)] = (
                "leaf" if not mine or s.name in ROOTS_OF_INPUT
                else "step" if all(c.name == "pull" for c in mine)
                else "phase_self")
        points += [(t, None if s is None else (k, s.id)) for t, s in _timeline(spans)]
    points.sort(key=lambda p: p[0])
    times = [t for t, _ in points]
    harness = [sp for j in jobs for sp in j["spans"]]
    out: dict = {}
    where = {"leaf": 0, "step": 0, "phase_self": 0, "harness": 0}
    for a, b in gaps:
        i = bisect.bisect_right(times, (a + b) // 2) - 1
        key = points[i][1] if i >= 0 else None
        if key is None:
            for name, ns in label_gaps([(a, b)], harness).items():
                out[name] = out.get(name, 0) + ns
            where["harness"] += b - a
            continue
        out[names[key]] = out.get(names[key], 0) + (b - a)
        where[kind[key]] += b - a
    return out, where


# -- a traced run with the program's spans --

def recorded(job):
    """Run ``job()`` (-> a job record of `benchmark.run.run_job`) with a
    recorder of the program active; the record gains ``program_spans``
    and ``program_counts``."""
    from cairo_m_tpu_torch.prover import observe

    with observe.record() as r:
        out = job()
        out["program_spans"], out["program_counts"] = r.drain()
    return out


def checks(rec) -> dict:
    """The spans against the harness's clocks: on each job ``vm`` +
    ``adapter`` against the span around ``native_prover_input``, the
    prover's phase spans against its ``timing``; the cold metrics'
    sum against ``cold_prove_s``."""
    worst_input, phases_equal = 0.0, True
    for j in rec["jobs"]:
        spans = j["program_spans"]
        va = sum(s.end - s.start for s in spans if s.name in ROOTS_OF_INPUT) / 1e9
        worst_input = max(worst_input, abs(va - j["vm_adapter_s"]) / j["vm_adapter_s"])
        (root,) = [s for s in spans if s.name == "prove"]
        phases = {s.name: (s.end - s.start) / 1e9 for s in spans if s.parent == root.id}
        phases_equal &= all(abs(j["phases"][n] - v) < 1e-9 for n, v in phases.items())
    cold = sum(READERS[n](rec) for n in ("cold_s.plans", "cold_s.inverses",
                                         "cold_s.preprocessed"))
    return {"vm_adapter_rel_diff_max": worst_input, "phases_equal_timing": phases_equal,
            "cold_parts_s": cold, "cold_prove_s": rec["cold_prove_s"]}


def main(argv=None) -> int:
    from . import run as bench_run
    from .trace import DeviceTrace, idle_gaps, label_gaps
    from .traffic import Stream

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.spans",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args(argv)
    bench = bench_run.load_benchmark()
    cell, config, mix = bench_run.load_cell(bench, a.workload)

    import torch

    if not torch.cuda.is_available():
        bench_run.log("needs a CUDA card")
        return 2
    device = "cuda"
    card = bench_run.card_line()
    torch.cuda.init()
    torch.zeros(1, device=device)

    def sync():
        torch.cuda.synchronize(device)

    bench_run.set_port_scale(config)
    security = bench_run.port_security(config)
    prog = bench_run.Program(config)
    stream = Stream(mix, a.seed)

    def job():
        return bench_run.run_job(prog, stream.next(), security, device, sync)

    cold = recorded(job)
    rec = {"cold_prove_s": cold["prove_s"], "setup_s": bench_run.process_age_s(),
           "cold_spans": cold["program_spans"]}
    del cold
    with DeviceTrace(torch, device) as tracer:
        jobs, w0, w1 = bench_run.run_window(lambda: recorded(job), a.seconds)
    rec.update(events=tracer.events, clock_skew_us=tracer.clock_skew_us,
               window_s=(w1 - w0) / 1e9, t0_ns=w0, t1_ns=w1, jobs=jobs)
    gaps = idle_gaps(tracer.events, w0, w1)
    by_span, where = idle_by_span(gaps, jobs)
    harness = label_gaps(gaps, [sp for j in jobs for sp in j["spans"]])
    metrics = {name: fn(rec) for name, fn in READERS.items()}
    for name in ("vm_adapter_s", "phase_s.trace", "phase_s.pcs", "cold_prove_s",
                 "device_idle_share", "setup_s", "cycles_per_s"):
        metrics[name] = bench_run.reader(name)(rec)

    def top(d):
        return [[n, ns / 1e9] for n, ns in sorted(d.items(), key=lambda kv: -kv[1])[:10]]

    idle_ns = sum(b - a for a, b in gaps)
    line = {"workload": a.workload, "seed": a.seed, "card": card, "jobs": len(jobs),
            "window_s": rec["window_s"], "clock_skew_us": rec["clock_skew_us"],
            "metrics": metrics, "idle_gaps": top(harness), "idle_gaps_by_span": top(by_span),
            "idle_in": {k: v / idle_ns for k, v in where.items()},
            "counts_per_job": [j["program_counts"] for j in jobs],
            "checks": checks(rec),
            "loaded": bench_run.forbidden_modules()}
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
