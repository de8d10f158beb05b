"""The chain job kind: a program longer than one segment, proved as a
continuation chain by the port's segment workers, one worker process a
card of the cell.

A configuration chooses it with ``"job": "chain"`` and states
``segment_steps``, the VM steps of a full segment.  A job is one call of
the port's public entry::

    prove_segments_multiprocess(source, entry, slots, segment_steps,
                                devices=["cuda:0", ..., "cuda:<chips-1>"],
                                n_processes=chips, test_scale=..., test_config=...)

with the configuration's scale and security passed to the workers through
the entry's own ``test_scale`` and ``test_config`` (``test_config`` fixes
blowup 2 and a last layer of degree 1, and takes the queries and PoW bits).
Every call starts fresh worker processes: each compiles the program, runs
the VM over the whole chain, assembles every segment's input, proves the
segments ``proc_id, proc_id + chips, ...`` and verifies its proofs.  The
harness measures the entry as it stands and keeps no workers of its own.

A chain job's record: ``args``; ``cycles``, the sum of the segments'
``n_steps``; ``t0``/``t1`` and ``wall_s``, the harness's clock around the
call; ``proofs``, each segment's proof as JSON, in segment order; and
``segments``, the port's record of each segment without its proof
(``segment``, ``worker``, ``device``, ``prove_s``, ``verify_s``,
``peak_bytes``, ``n_steps``, ``initial_root``, ``final_root``,
``launches``); ``worker_forbidden``, the forbidden top-level modules
(`run.FORBIDDEN`) that any worker held when it exited, read by the
workers' hook (``worker_hook/sitecustomize.py``) on every chain.  A traced
chain adds ``workers``, each worker's trace, and ``trace_overhead_s``,
the most that opening and flushing its trace cost a worker.

`judge_chain` trusts nothing the port checked: it reads the proofs' JSON.
"""

from __future__ import annotations

import contextlib
import json
import os
import random
import tempfile
import time
from pathlib import Path

from . import run as R
from .trace import idle_gaps, label_gaps, union_ns
from .traffic import Stream

DIR_ENV = "CM_BENCH_WORKER_DIR"  # where each worker writes its report
TRACE_ENV = "CM_BENCH_WORKER_TRACE"  # set: each worker traces its card too
WORKER_HOOK = R.HERE / "worker_hook"  # the workers' sitecustomize
CHAIN_TIMEOUT_S = 300  # the entry kills the workers of a chain that takes longer


class Chain:
    """The cell's chain job: the program, its call encoding, the segment
    cap, and a worker a card (``device`` ``cuda``) or ``chips`` workers on
    one other device (the tests' CPU)."""

    def __init__(self, config: dict, chips: int, device: str = "cuda"):
        s = config["security"]
        if (s["log_blowup"], s["log_last_layer_degree_bound"]) != (1, 0):
            raise ValueError("the workers' test_config fixes log_blowup 1 and "
                             "log_last_layer_degree_bound 0")
        self.prog = R.Program(config)
        self.source = (R.ROOT / config["program"]).read_text()
        self.segment_steps = int(config["segment_steps"])
        self.devices = ([f"cuda:{i}" for i in range(chips)] if device == "cuda"
                        else [device] * chips)
        self.test_config = {"n_queries": int(s["n_queries"]), "pow_bits": int(s["pow_bits"])}
        self.test_scale = {k: int(v) for k, v in config["scale"].items()}


@contextlib.contextmanager
def _worker_env(out: str, trace: bool):
    """The workers' hook on ``PYTHONPATH``, writing its reports to ``out``
    (and tracing each card with ``trace``); the environment is restored
    after."""
    saved = {k: os.environ.get(k) for k in (DIR_ENV, TRACE_ENV, "PYTHONPATH")}
    os.environ[DIR_ENV] = out
    os.environ.pop(TRACE_ENV, None)
    if trace:
        os.environ[TRACE_ENV] = "1"
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(WORKER_HOOK), saved["PYTHONPATH"]) if p)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_chain_job(chain: Chain, args, trace: bool = False) -> dict:
    """One chain: the port's entry, timed by the harness's clock, each
    worker's report read after it (a worker that leaves none fails the
    chain)."""
    from cairo_m_tpu_torch.parallel.segments import prove_segments_multiprocess

    with tempfile.TemporaryDirectory(prefix="cm_bench_chain_") as out:
        with _worker_env(out, trace):
            t0 = time.monotonic_ns()
            records = prove_segments_multiprocess(
                chain.source, chain.prog.entry, chain.prog.slots(args), chain.segment_steps,
                devices=chain.devices, n_processes=len(chain.devices),
                test_scale=chain.test_scale, test_config=chain.test_config,
                timeout=CHAIN_TIMEOUT_S)
            t1 = time.monotonic_ns()
        workers = [json.loads(p.read_text()) for p in sorted(Path(out).glob("worker_*.json"))]
    if len(workers) != len(chain.devices):
        raise RuntimeError(f"{len(workers)} of {len(chain.devices)} segment workers reported")
    proofs = [r.pop("proof") for r in records]
    job = {"args": args, "cycles": sum(int(r["n_steps"]) for r in records),
           "proofs": proofs, "segments": records, "t0": t0, "t1": t1,
           "wall_s": (t1 - t0) / 1e9,
           "worker_forbidden": R.forbidden_modules(m for w in workers for m in w.pop("modules"))}
    if trace:
        job["workers"] = workers
        job["trace_overhead_s"] = max(w["start_ns"] + w["flush_ns"] for w in workers) / 1e9
    return job


def peak_bytes(jobs) -> int:
    """The largest peak of the jobs' segments: the busiest card's."""
    return max((s["peak_bytes"] or 0 for j in jobs for s in j["segments"]), default=0)


def by_worker(job) -> dict:
    """worker -> its segment records, in segment order."""
    out: dict = {}
    for s in sorted(job["segments"], key=lambda s: s["segment"]):
        out.setdefault(s["worker"], []).append(s)
    return out


def describe(job) -> str:
    parts = [f"{w}: " + "+".join(f"{s['prove_s']:.2f}/{s['verify_s']:.2f}" for s in segs)
             for w, segs in sorted(by_worker(job).items())]
    return (f"n={job['args'][0]} {len(job['segments'])} segments {job['cycles']} cycles "
            f"{job['wall_s']:.3f} s; worker: prove/verify s a segment: " + "; ".join(parts))


# -- the judgement --

def chain_fault(job: dict, answers, segment_steps: int):
    """Why the chain's proofs do not state a whole, ordered chain of the
    program on its arguments, read from the proofs' JSON alone; None if
    they do."""
    segs = [s["segment"] for s in job["segments"]]
    if not segs or segs != list(range(len(segs))) or len(job["proofs"]) != len(segs):
        return f"segment set {segs}"
    pds = [p["public_data"] for p in job["proofs"]]
    for k, (a, b) in enumerate(zip(pds, pds[1:])):
        if a["final_root"] != b["initial_root"]:
            return f"root chain broken between segments {k} and {k + 1}"
        if list(a["final_registers"]) != list(b["initial_registers"]):
            return f"registers do not carry from segment {k} to {k + 1}"
        if int(a["clock"]) != segment_steps:
            return f"segment {k} of {len(pds)} is not full: {a['clock']} steps"
    if not 0 < int(pds[-1]["clock"]) <= segment_steps:
        return f"last segment has {pds[-1]['clock']} steps"
    steps = sum(int(pd["clock"]) for pd in pds)
    if hasattr(answers, "cycles") and steps != answers.cycles(job["args"]):
        return f"{steps} steps proved, the program takes {answers.cycles(job['args'])}"

    def values(entries):
        return [tuple(e[1]) for e in entries if e is not None]

    if values(pds[0]["input"]) != [(v, 0, 0, 0) for v in answers.input_slots(job["args"])]:
        return f"segment 0's input {values(pds[0]['input'])}"
    if values(pds[-1]["output"]) != [(v, 0, 0, 0) for v in answers.output_slots(job["args"])]:
        return f"the last segment's output {values(pds[-1]['output'])}"
    return None


def picks(jobs, seed: int, n_verified: int) -> list:
    """(chain, segment) pairs drawn from the seed, at least one of them a
    resumed segment (k >= 1) where the window has one."""
    pairs = [(i, k) for i, j in enumerate(jobs) for k in range(len(j["proofs"]))]
    rng = random.Random(int(seed) ^ 0x5EED)
    out = rng.sample(pairs, min(n_verified, len(pairs)))
    resumed = [p for p in pairs if p[1] >= 1]
    if out and resumed and not any(k >= 1 for _, k in out):
        out[-1] = rng.choice(resumed)
    return out


def judge_chain(config: dict, jobs: list, seed: int, n_verified: int = R.N_VERIFIED) -> dict:
    """The reference's verdict on the window's chains: each chain whole,
    ordered and stating the configuration's answer (`chain_fault`), else
    a wrong answer; segment proofs drawn from the seed verified in full,
    a rejected one a rejected proof.  -> numbers compared, each with its
    limit, and what was read."""
    from .reference import scale as rscale
    from .reference.verify import Rejected, verify

    answers = R.answer_module(config["name"])
    wrong, reasons = 0, []
    for i, j in enumerate(jobs):
        why = chain_fault(j, answers, int(config["segment_steps"]))
        if why:
            wrong += 1
            reasons.append(f"chain {i}: {why}")
    chosen = picks(jobs, seed, n_verified)
    cfg, sc = rscale.SecurityConfig(**config["security"]), config["scale"]
    rejected = 0
    t = time.monotonic()
    with rscale.protocol_scale(sc["rc_big_bits"], sc["bitwise_log"]):
        for i, k in chosen:
            try:
                verify(jobs[i]["proofs"][k], cfg)
            except Rejected as e:
                rejected += 1
                reasons.append(f"chain {i} segment {k}: {e}")
    resumed = sum(1 for _, k in chosen if k >= 1)
    R.log(f"reference: {len(jobs)} chains, {len(chosen)} segment proofs verified "
          f"({resumed} resumed: {chosen}) in {time.monotonic() - t:.3f} s")
    for r in reasons:
        R.log(f"reference: {r}")
    return {"wrong_answers": {"value": wrong, "limit": 0},
            "rejected_proofs": {"value": rejected, "limit": 0},
            "jobs_answered": len(jobs), "proofs_verified": len(chosen),
            "resumed_verified": resumed, "reasons": reasons}


# -- the traced window --

def worker_phases(job: dict, worker: dict) -> list:
    """[(phase, start ns, end ns)] of one worker's life in a chain, the
    first that holds a moment naming it: each ``prove`` span, the
    ``verify`` after it (its record's ``verify_s``), ``start`` (the call
    to the first proof), ``exit`` (the last verification to the call's
    return: the proofs written, the process gone, the collection), and
    ``vm_adapter`` (the rest: the VM and inputs of the segments between)."""
    segs = by_worker(job).get(worker["proc_id"], [])
    out = []
    for (a, b), s in zip(worker["prove"], segs):
        out += [("prove", a, b), ("verify", b, b + int(s["verify_s"] * 1e9))]
    first = worker["prove"][0][0] if worker["prove"] else job["t1"]
    last = out[-1][2] if out else job["t0"]
    return out + [("start", job["t0"], first), ("exit", last, job["t1"]),
                  ("vm_adapter", job["t0"], job["t1"])]


def trace_summary(jobs: list, w0: int, w1: int, chips: int):
    """-> (breakdown, device line's extra) of a traced window: busy
    seconds a card, its device operations and its idle seconds by the
    phase of the worker that held the card, each the mean over the cell's
    cards."""
    busy = {c: [] for c in range(chips)}
    phases = {c: [] for c in range(chips)}
    ops: dict = {}
    for j in jobs:
        for w in j["workers"]:
            c = int(w["device"])
            busy.setdefault(c, []).extend((a, b) for a, b in w["busy"])
            phases.setdefault(c, []).extend(worker_phases(j, w))
            for name, ns in w["by_name"].items():
                ops[name] = ops.get(name, 0) + ns
    gaps: dict = {}
    busy_ns = 0
    for c, iv in busy.items():
        iv = [(max(a, w0), min(b, w1)) for a, b in iv if a < w1 and b > w0]
        busy_ns += union_ns(iv)
        labelled = label_gaps(idle_gaps([("", a, b - a) for a, b in iv], w0, w1), phases[c])
        for name, ns in labelled.items():
            gaps[name] = gaps.get(name, 0) + ns
    n = len(busy)
    if not busy_ns:
        raise RuntimeError("the workers' traces hold no device activity")
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    return ({"device_ops": [[k, v / n / 1e9] for k, v in top],
             "idle_gaps": [[k, v / n / 1e9] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]},
            {"busy_s": busy_ns / n / 1e9, "window_s": (w1 - w0) / 1e9})


# -- a run --

def run_chain(cell: dict, config: dict, mix: dict, metrics: list, seed: int,
              seconds: float, trace: bool, device: str = "cuda") -> dict:
    """`benchmark.run.run` for a chain cell: set-up builds the port's
    kernels (nvcc, in a checkout's first run; the workers load the
    library); then the window of chains, under ``--trace 1`` each worker's
    card traced, then the judgement.  Every chain starts fresh workers, so
    a chain in set-up would warm nothing the window uses: ``setup_s`` is
    the process's age when the window's first chain ends, what a user
    pays from start to the first chain's proofs.  The harness's own
    process touches no card."""
    chain = Chain(config, int(cell["chips"]), device)
    stream = Stream(mix, seed)
    if device.startswith("cuda"):
        from cairo_m_tpu_torch import kernels

        kernels.build()
    age0, m0 = R.process_age_s(), time.monotonic_ns()
    R.log(f"set-up: kernels built, {age0:.3f} s")

    jobs, w0, w1 = R.run_window(lambda: run_chain_job(chain, stream.next(), trace), seconds)
    rec = {"setup_s": age0 + (jobs[0]["t1"] - m0) / 1e9, "window_s": (w1 - w0) / 1e9,
           "t0_ns": w0, "t1_ns": w1, "jobs": jobs, "peak_window_bytes": peak_bytes(jobs)}
    R.log(f"window {rec['window_s']:.3f} s, {len(jobs)} chains, "
          f"{sum(j['cycles'] for j in jobs)} cycles; set-up to the first chain's end "
          f"{rec['setup_s']:.3f} s")
    for i, j in enumerate(jobs):
        R.log(f"chain {i}: {describe(j)}")
    values = {}
    for m in metrics:
        v = R.reader(m["name"])(rec)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {"metrics": values, "count": len(chain.devices)}
    if trace:
        result["breakdown"], result["device_extra"] = trace_summary(jobs, w0, w1, len(chain.devices))
        R.log("trace: " + "; ".join(
            f"worker {w['proc_id']} on card {w['device']}: {w['events']} device events, "
            f"clock skew {w['clock_skew_us']:.1f} us, card current at "
            f"+{(w['set_device_ns'] - j['t0']) / 1e9:.3f} s, context {w['context_ns'] / 1e9:.3f} s, "
            f"first prove at +{((w['prove'] or [[j['t1']]])[0][0] - j['t0']) / 1e9:.3f} s, "
            f"trace open {w['start_ns'] / 1e9:.3f} s, flush {w['flush_ns'] / 1e9:.3f} s"
            for j in jobs for w in j["workers"]))
    result["peak_bytes"] = rec["peak_window_bytes"]
    result["worker_forbidden"] = sorted({m for j in jobs for m in j["worker_forbidden"]})
    result["checks"] = judge_chain(config, jobs, seed)
    result["jobs"] = len(jobs)
    return result
