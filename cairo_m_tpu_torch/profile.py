"""Profile the prover on fibonacci runs: phases, launches, memory, components.

    python -m cairo_m_tpu_torch.profile prove [--iters 100000 1000000]
        [--runs cold,warm] [--device cuda] [--verify] [--save-proof DIR]
        [--trace] [--test-scale]
    python -m cairo_m_tpu_torch.profile components [--iters 100000]
        [--device cuda] [--test-scale]

``prove``: compile the fibonacci loop, run the native VM + adapter for each
``--iters`` as one segment (no step cap), and prove at ``REGULAR_96_BITS``
once per entry of ``--runs``: ``cold`` sets the prover's caches of recorded
plans and of the preprocessed commitment aside first (the CUDA context,
the kernels and the twiddle tables stay), ``warm`` proves again.  Per proof:
adapter seconds, prove seconds, cycles/s, the ``timing`` phases, kernel
launches by kernel (`kernels.launches`), peak device memory (reset before
each proof) and the components' log sizes.  The last run of ``--runs``
prints its ``CM_DEBUG_PHASES`` lines (`prover.observe`).  ``--verify``
verifies the proof with this package, ``--save-proof DIR`` writes
``fib_<iters>_proof.json`` and its sha256 there, ``--trace`` adds one
further warm proof under ``torch.profiler``: device kernels, device busy
seconds, host seconds in ``cudaLaunchKernel`` and the ten largest device
operations.  The last line of standard output is one JSON summary.

``components``: one warm-up proof, then one proof whose every live
component's interaction trace and composition contribution is timed on
its own (`ComponentTimer`): the host's seconds to queue the work
(dispatch) beside the seconds until the device finished it, which says
whether a component is bound by dispatch or by compute.

``--test-scale``: the tests' protocol scale (``set_test_scale(10, 8)``,
``test_config(n_queries=8, pow_bits=2)``) instead of the production one.
``--device`` defaults to the card (`device.py`); ``--device cpu`` runs the
plain versions of the kernels.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

import torch

from . import kernels
from .compiler import compile_cairo
from .device import DEFAULT_DEVICE, resolve_device
from .prover import config as config_mod
from .prover import observe
from .prover import prove as prove_mod
from .prover.adapter.native_import import native_prover_input
from .prover.components.registry import ComponentSet
from .prover.relations import Relations
from .prover.stark import framework
from .prover.verify import verify_cairo_m

FIB_SRC = """
fn main(n: felt) -> felt {
    let a = 0; let b = 1; let i = 0;
    while i != n { let t = a + b; a = b; b = t; i = i + 1; }
    return a;
}
"""
# one segment: the reference's `native_prover_input` default, no cap
MAX_STEPS = 1 << 32
TEST_SCALE = {"rc_big_bits": 10, "bitwise_log": 8}
TEST_CONFIG = {"n_queries": 8, "pow_bits": 2}
# host-side API calls that launch a device kernel
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                 "cuLaunchKernelEx")

_T00 = time.time()


def log(msg: str):
    print(f"[{time.time() - _T00:8.1f}s] {msg}", flush=True)


def card_line(device) -> str | None:
    """The card's name and power limit as nvidia-smi prints them."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return torch.cuda.get_device_name(device)
    return out.splitlines()[0] if out else None


def proof_digest(proof) -> str:
    return hashlib.sha256(
        json.dumps(proof.to_json_obj(), sort_keys=True).encode()).hexdigest()


def host_max_rss_gib() -> float:
    """The process's peak resident host memory so far (Linux: KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


@contextlib.contextmanager
def cold_prover_caches():
    """Set the prover's process-wide caches (recorded plans, the
    preprocessed tables' commitment and stacks) aside for the proof in
    the context, and put them back afterwards."""
    caches = (framework._PLAN_CACHE, prove_mod._PRE_PHASE_CACHE,
              prove_mod._PRE_STACK_CACHE)
    saved = [dict(c) for c in caches]
    for c in caches:
        c.clear()
    try:
        yield
    finally:
        for c, old in zip(caches, saved):
            c.update(old)


@contextlib.contextmanager
def env_switch(name: str, on: bool):
    """Set environment variable ``name`` for the context when ``on``."""
    old = os.environ.get(name)
    if on:
        os.environ[name] = "1"
    try:
        yield
    finally:
        if on:
            if old is None:
                del os.environ[name]
            else:
                os.environ[name] = old


def fib_input(iters: int):
    program = compile_cairo(FIB_SRC).program
    t = time.time()
    pi = native_prover_input(program, "main", [iters], max_steps=MAX_STEPS)
    return pi, time.time() - t


def log_sizes(proof) -> dict:
    """Component name -> log size, registry order."""
    names = [c.name for c in ComponentSet(Relations()).all]
    return dict(zip(names, proof.log_sizes))


def timed_prove(pi, cfg, device, observer=None):
    """One proof; -> (proof, record of seconds, phases, launches by kernel
    and by shape, peak device memory)."""
    kernels.reset_launches()
    timing = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    observe.sync(device)
    t = time.time()
    proof = prove_mod.prove_cairo_m(pi, cfg, timing, device=device,
                                    observer=observer)
    observe.sync(device)
    seconds = time.time() - t
    rec = {"seconds": seconds, "cycles_per_s": pi.total_steps / seconds,
           "phases": timing, "launches": dict(kernels.launches),
           # "name,*shape" -> launches (`kernels.launch_shapes`)
           "launch_shapes": {",".join(map(str, k)): n
                             for k, n in sorted(kernels.launch_shapes.items())},
           "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else None)}
    return proof, rec


def _busy_ns(spans) -> int:
    """Length of the union of (start, end) intervals."""
    busy, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def trace_prove(pi, cfg, device) -> dict:
    """One warm proof under ``torch.profiler``: -> device kernel count,
    device busy seconds, host seconds in the launch calls, wall seconds,
    and the ten largest device operations by total time.  On a card only
    the CUDA activity is traced (kernels, copies and the runtime's host
    calls; not every torch operator, whose record would cost more than the
    proof), and the raw events are read without building the profiler's
    operator tree."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU]
    observe.sync(device)
    with profile(activities=acts) as prof:
        t = time.time()
        prove_mod.prove_cairo_m(pi, cfg, device=device)
        observe.sync(device)
        wall = time.time() - t
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [(e.name(), e.start_ns(), e.duration_ns())
           for e in events if e.device_type() == cuda]
    n_kernels = sum(1 for name, _, _ in dev
                    if not name.startswith(("Memcpy", "Memset")))
    by_name: dict = {}
    for name, _, ns in dev:
        n, total = by_name.get(name, (0, 0))
        by_name[name] = (n + 1, total + ns)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    launch_ns = sum(e.duration_ns() for e in events
                    if e.device_type() != cuda and e.name() in _LAUNCH_CALLS)
    busy = _busy_ns([(a, a + ns) for _, a, ns in dev]) / 1e9
    return {
        "wall_s": wall, "device_kernels": n_kernels, "device_ops": len(dev),
        "device_busy_s": busy, "device_busy_share": busy / wall,
        "launch_calls": sum(1 for e in events if e.name() in _LAUNCH_CALLS),
        "launch_host_s": launch_ns / 1e9,
        "top_device_ops": [{"name": name[:120], "count": n, "ms": ns / 1e6}
                           for name, (n, ns) in top],
    }


def log_trace(label: str, tr: dict):
    """Print a `trace_prove` record: its totals, then the largest device
    operations."""
    log(f"{label} traced warm prove: {tr['wall_s']:.3f} s wall, "
        f"{tr['device_kernels']} device kernels ({tr['device_ops']} device "
        f"operations), device busy {tr['device_busy_s']:.4f} s "
        f"({100 * tr['device_busy_share']:.1f}%), {tr['launch_calls']} "
        f"launch calls, {tr['launch_host_s']:.4f} s of host time")
    for op in tr["top_device_ops"]:
        log(f"    {op['ms']:10.3f} ms {op['count']:7d}x {op['name']}")


def scale_config(test_scale: bool):
    """The protocol config, with the preprocessed tables set to its scale:
    the tests' (``--test-scale``) or the production one."""
    if test_scale:
        config_mod.set_test_scale(**TEST_SCALE)
        return config_mod.test_config(**TEST_CONFIG)
    config_mod.set_production_scale()
    return config_mod.REGULAR_96_BITS


def run_prove(iters_list, runs, device, cfg, verify=False, save_dir=None,
              trace=False) -> dict:
    """The ``prove`` command; -> its JSON summary."""
    summary = {"device": str(device), "card": card_line(device), "fib": []}
    log(f"device {device}" + (f" ({summary['card']})" if summary["card"] else ""))
    for iters in iters_list:
        pi, adapter_s = fib_input(iters)
        entry = {"iters": iters, "cycles": pi.total_steps,
                 "adapter_s": adapter_s, "host_max_rss_gib": host_max_rss_gib(),
                 "runs": {}}
        log(f"fib({iters}): native VM + adapter {adapter_s:.3f} s, "
            f"{pi.total_steps} cycles, host max RSS {entry['host_max_rss_gib']:.2f} GiB")
        proof = None
        for i, run in enumerate(runs):
            last = i == len(runs) - 1
            with contextlib.ExitStack() as stack:
                if run == "cold":
                    stack.enter_context(cold_prover_caches())
                # the last run's phase lines, unless the caller set the
                # switch for every run
                stack.enter_context(env_switch("CM_DEBUG_PHASES", last))
                proof, rec = timed_prove(pi, cfg, device)
            entry["runs"][run] = rec
            peak = rec["peak_device_bytes"]
            log(f"fib({iters}) {run} prove: {rec['seconds']:.3f} s "
                f"({rec['cycles_per_s']:.1f} cycles/s); phases "
                + json.dumps({k: round(v, 4) for k, v in rec["phases"].items()})
                + f"; launches {rec['launches']}"
                + (f"; peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)"
                   if peak is not None else ""))
        entry["log_sizes"] = log_sizes(proof)
        entry["sha256"] = proof_digest(proof)
        log(f"fib({iters}) log sizes {json.dumps(entry['log_sizes'])}")
        log(f"fib({iters}) proof sha256 {entry['sha256']}")
        if save_dir is not None:
            os.makedirs(save_dir, exist_ok=True)
            path = os.path.join(save_dir, f"fib_{iters}_proof.json")
            with open(path, "w") as f:
                f.write(json.dumps(proof.to_json_obj(), sort_keys=True))
            with open(path + ".sha256", "w") as f:
                f.write(entry["sha256"] + "\n")
            entry["saved"] = path
            log(f"fib({iters}) proof written to {path}")
        if verify:
            t = time.time()
            entry["verified"] = bool(verify_cairo_m(proof, cfg, device=device))
            entry["verify_s"] = time.time() - t
            log(f"fib({iters}) verified={entry['verified']} in "
                f"{entry['verify_s']:.3f} s")
        if trace:
            entry["trace"] = trace_prove(pi, cfg, device)
            log_trace(f"fib({iters})", entry["trace"])
        entry["host_max_rss_gib"] = host_max_rss_gib()
        summary["fib"].append(entry)
        del proof, pi
    return summary


class ComponentTimer:
    """Observer of `prove_cairo_m`: for each live component and stage
    (``interaction``, ``composition``), the host seconds to queue its work
    (``dispatch_s``) and the seconds until the device finished it
    (``seconds``; the device is synced before and after).  ``keep``: also
    keep each piece's output, keyed by (stage, component name)."""

    def __init__(self, device, keep: bool = False):
        self.device = device
        self.keep = keep
        self.rows = []
        self.outputs = {}
        self._t = None

    def begin(self, stage, comp):
        observe.sync(self.device)
        self._t = time.perf_counter()

    def end(self, stage, comp, out):
        dispatch = time.perf_counter() - self._t
        observe.sync(self.device)
        self.rows.append({"stage": stage, "component": comp.name,
                          "log_size": comp.log_size, "dispatch_s": dispatch,
                          "seconds": time.perf_counter() - self._t})
        if self.keep:
            self.outputs[(stage, comp.name)] = out


def profile_components(pi, cfg, device, keep: bool = False):
    """One warm-up proof, then one observed proof; -> (proof, its record,
    the `ComponentTimer`)."""
    prove_mod.prove_cairo_m(pi, cfg, device=device)
    timer = ComponentTimer(device, keep)
    proof, rec = timed_prove(pi, cfg, device, observer=timer)
    return proof, rec, timer


def run_components(iters: int, device, cfg) -> dict:
    """The ``components`` command; -> its JSON summary."""
    pi, adapter_s = fib_input(iters)
    log(f"device {device}; fib({iters}): {pi.total_steps} cycles, native VM + "
        f"adapter {adapter_s:.3f} s")
    return {"iters": iters, **component_report(pi, cfg, device)}


def component_report(pi, cfg, device) -> dict:
    """`profile_components` on the prover input ``pi``, printed stage by
    stage, components by synced seconds; -> the record of the ``components``
    command."""
    proof, rec, timer = profile_components(pi, cfg, device)
    log(f"observed prove (synced around every component): {rec['seconds']:.3f} s; "
        "phases " + json.dumps({k: round(v, 4) for k, v in rec["phases"].items()}))
    totals = {}
    for stage in ("interaction", "composition"):
        rows = sorted((r for r in timer.rows if r["stage"] == stage),
                      key=lambda r: -r["seconds"])
        total = sum(r["seconds"] for r in rows)
        dispatch = sum(r["dispatch_s"] for r in rows)
        totals[stage] = {"seconds": total, "dispatch_s": dispatch}
        log(f"{stage}: {len(rows)} live components, {total:.4f} s synced, "
            f"{dispatch:.4f} s of it queueing on the host")
        for r in rows:
            log(f"    {r['component']:34s} log={r['log_size']:2d} "
                f"{1e3 * r['seconds']:9.3f} ms (dispatch {1e3 * r['dispatch_s']:9.3f} ms)")
    return {"device": str(device), "card": card_line(device),
            "cycles": pi.total_steps, "prove": rec, "totals": totals,
            "components": timer.rows, "sha256": proof_digest(proof)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cairo_m_tpu_torch.profile",
                                 description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    pp = sub.add_parser("prove", help="cold and warm proves of fibonacci runs")
    pp.add_argument("--iters", type=int, nargs="+", default=[100_000, 1_000_000])
    pp.add_argument("--runs", default="cold,warm",
                    help="comma-separated runs per input: cold, warm")
    pp.add_argument("--verify", action="store_true")
    pp.add_argument("--save-proof", metavar="DIR")
    pp.add_argument("--trace", action="store_true",
                    help="one more warm proof under torch.profiler")
    pc = sub.add_parser("components",
                        help="per-component interaction and composition seconds")
    pc.add_argument("--iters", type=int, default=100_000)
    for p in (pp, pc):
        p.add_argument("--device", default=DEFAULT_DEVICE)
        p.add_argument("--test-scale", action="store_true",
                       help="set_test_scale(10, 8), 8 queries, 2 PoW bits")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        kernels.lib()  # build outside the timed proofs
    cfg = scale_config(args.test_scale)
    if args.cmd == "prove":
        runs = [r for r in args.runs.split(",") if r]
        bad = set(runs) - {"cold", "warm"}
        if bad or not runs:
            ap.error(f"--runs takes cold and warm, not {sorted(bad) or runs}")
        summary = run_prove(args.iters, runs, device, cfg, args.verify,
                            args.save_proof, args.trace)
        ok = all(e.get("verified", True) for e in summary["fib"])
    else:
        summary = run_components(args.iters, device, cfg)
        ok = True
    print(json.dumps(summary), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
