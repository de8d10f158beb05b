"""One run of one cell of the benchmark of cairo_m_tpu_torch.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port.  A cell (an entry of
``workloads`` in ``BENCHMARK.json``) names a configuration (a program, its
entry point, the protocol's scale and security: ``configs/<name>.json``)
and a traffic mix (``traffic/<name>.json``).  The run:

1. set-up: the CUDA context, the program compiled, one cold job on the
   stream's first arguments (plans, preprocessed commitment, twiddles);
2. the window: jobs one after another, closed loop, each on the stream's
   next arguments; no job starts after ``--seconds``, and the window ends
   when its last job does.  A job is what a user pays for one execution:
   the native VM and adapter (``native_prover_input``) and the proof
   (``prove_cairo_m``), the device synced at its end;
3. after the window: the peak device memory read, then the program's
   results judged by the plain reference (``reference/``): every job's
   public input and output against the configuration's answer, and
   proofs drawn from the seed verified in full;
4. the last line on standard output: one JSON object, with ``--trace 0``
   the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics
   read from a device trace of the window.  Each metric is read by
   ``metrics/<name>.py`` from the run's record.

The run fails, printing no result, without a card, with fewer cards than
the cell asks for, or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

from .trace import DeviceTrace, by_name, idle_gaps, label_gaps, union_ns
from .traffic import Stream, load_mix

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "cairo_m_tpu")
N_VERIFIED = 2  # proofs a run verifies in full with the reference


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as fh:
        start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


# -- the benchmark's data --

def load_benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(bench: dict, workload: str):
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((ROOT / entry["file"]).read_text())
    return cell, config, load_mix(cell["traffic"])


def cell_metrics(bench: dict, cell: dict, trace: bool) -> list:
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in bench[kind]
            if cell["name"] in m.get("workloads", [cell["name"]])]


def _load(package: str, name: str):
    """The module ``benchmark/<package>/<name>.py`` (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark.{package.replace('/', '.')}.{name}", HERE / package / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """The metric's reader, ``metrics/<name>.py``."""
    return _load("metrics", name).read


def answer_module(config_name: str):
    """What a proof of the configuration must state, ``reference/answers/<config>.py``."""
    return _load("reference/answers", config_name)


def card_line() -> str:
    """The card's name, power limit and top SM clock, as nvidia-smi reads
    them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"


# -- the system under test --

class Program:
    """The cell's program compiled by the port, and its call encoding."""

    def __init__(self, config: dict):
        from cairo_m_tpu_torch.compiler import compile_cairo

        src = (ROOT / config["program"]).read_text()
        self.program = compile_cairo(src).program
        self.entry = config["entry"]
        self.max_steps = int(config["max_steps"])
        self.kinds = [p.ty.kind for p in self.program.get_entrypoint(self.entry).params]

    def slots(self, args) -> list:
        out = []
        for kind, v in zip(self.kinds, args, strict=True):
            if kind == "felt":
                out.append(int(v))
            elif kind == "u32":
                out += [int(v) & 0xFFFF, int(v) >> 16]
            else:
                raise ValueError(f"argument kind {kind}")
        return out


def port_security(config: dict):
    from cairo_m_tpu_torch.prover.stark.fri import FriConfig
    from cairo_m_tpu_torch.prover.stark.pcs import PcsConfig

    s = config["security"]
    return PcsConfig(pow_bits=s["pow_bits"], fri_config=FriConfig(
        log_blowup_factor=s["log_blowup"],
        log_last_layer_degree_bound=s["log_last_layer_degree_bound"],
        n_queries=s["n_queries"]))


def set_port_scale(config: dict):
    from cairo_m_tpu_torch.prover import config as pc

    pc.SCALE.rc_big_bits = int(config["scale"]["rc_big_bits"])
    pc.SCALE.bitwise_log = int(config["scale"]["bitwise_log"])


def run_job(prog: Program, args, security, device, sync) -> dict:
    """One execution: VM + adapter, then the proof, the device synced."""
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m

    t0 = time.monotonic_ns()
    pi = native_prover_input(prog.program, prog.entry, prog.slots(args), prog.max_steps)
    cycles = int(pi.total_steps)
    t1 = time.monotonic_ns()
    timing = {}
    proof = prove_cairo_m(pi, security, timing, device=device)
    del pi
    sync()
    t2 = time.monotonic_ns()
    spans = [("vm_adapter", t0, t1)]
    t = t1
    for phase in ("trace", "interaction", "composition", "pcs"):
        d = int(timing.get(phase, 0.0) * 1e9)
        spans.append((f"prove:{phase}", t, min(t + d, t2)))
        t += d
    if t < t2:
        spans.append(("prove:sync", t, t2))
    return {"args": args, "cycles": cycles, "proof": proof, "phases": timing,
            "vm_adapter_s": (t1 - t0) / 1e9, "prove_s": (t2 - t1) / 1e9,
            "t0": t0, "t1": t2, "spans": spans}


# -- the judgement --

def judge(config: dict, jobs: list, seed: int, n_verified: int = N_VERIFIED) -> dict:
    """The reference's verdict on the window's results: every job's public
    input and output against the configuration's answer; proofs drawn
    from the seed verified in full.  -> numbers compared, each with its
    limit."""
    from .reference import scale as rscale
    from .reference.verify import Rejected, verify

    answers = answer_module(config["name"])
    wrong = 0
    for j in jobs:
        pd = j["proof"].public_data
        got_in = [e[1] for e in pd.input if e is not None]
        got_out = [e[1] for e in pd.output if e is not None]
        want_in = [(v, 0, 0, 0) for v in answers.input_slots(j["args"])]
        want_out = [(v, 0, 0, 0) for v in answers.output_slots(j["args"])]
        if [tuple(x) for x in got_in] != want_in or [tuple(x) for x in got_out] != want_out:
            wrong += 1
    picks = random.Random(int(seed) ^ 0x5EED).sample(range(len(jobs)), min(n_verified, len(jobs)))
    cfg, sc = rscale.SecurityConfig(**config["security"]), config["scale"]
    rejected, reasons = 0, []
    t = time.monotonic()
    with rscale.protocol_scale(sc["rc_big_bits"], sc["bitwise_log"]):
        for i in picks:
            try:
                verify(jobs[i]["proof"].to_json_obj(), cfg)
            except Rejected as e:
                rejected += 1
                reasons.append(f"job {i}: {e}")
    log(f"reference: {len(jobs)} answers, {len(picks)} proofs verified in "
        f"{time.monotonic() - t:.3f} s")
    for r in reasons:
        log(f"reference rejected {r}")
    return {"wrong_answers": {"value": wrong, "limit": 0},
            "rejected_proofs": {"value": rejected, "limit": 0},
            "jobs_answered": len(jobs), "proofs_verified": len(picks),
            "reasons": reasons}


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


# -- a run --

def run_window(do_job, seconds: float, clock=time.monotonic_ns):
    """Jobs one after another, the first at the start, until ``seconds``
    have passed since the start; no job starts after that, and the window
    ends when the last job does.  -> (jobs, start ns, end ns)."""
    jobs = []
    w0 = clock()
    deadline = w0 + int(seconds * 1e9)
    while not jobs or clock() < deadline:
        jobs.append(do_job())
    return jobs, w0, jobs[-1]["t1"]


def run(cell: dict, config: dict, mix: dict, metrics: list, seed: int,
        seconds: float, trace: bool, device: str = "cuda") -> dict:
    import torch

    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.init()
        torch.zeros(1, device=device)

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    set_port_scale(config)
    security = port_security(config)
    prog = Program(config)
    stream = Stream(mix, seed)

    # set-up: one cold job on the stream's first arguments
    cold = run_job(prog, stream.next(), security, device, sync)
    setup_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    rec = {"cold_prove_s": cold["prove_s"], "setup_s": process_age_s()}
    del cold
    log(f"set-up {rec['setup_s']:.3f} s (cold prove {rec['cold_prove_s']:.3f} s)")

    # the window
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    with DeviceTrace(torch, device) if trace else contextlib.nullcontext() as tracer:
        jobs, w0, w1 = run_window(
            lambda: run_job(prog, stream.next(), security, device, sync), seconds)
    if trace:
        rec["events"], rec["clock_skew_us"] = tracer.events, tracer.clock_skew_us
    rec.update(window_s=(w1 - w0) / 1e9, t0_ns=w0, t1_ns=w1, jobs=jobs)
    rec["peak_window_bytes"] = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"window {rec['window_s']:.3f} s, {len(jobs)} jobs, "
        f"{sum(j['cycles'] for j in jobs)} cycles")
    log("jobs (vm + adapter, prove) s: " + " ".join(
        f"{j['vm_adapter_s']:.3f}+{j['prove_s']:.3f}" for j in jobs))

    last = jobs[-1]["proof"]
    from .reference.components.registry import ComponentSet
    from .reference.relations import Relations
    from .reference.scale import protocol_scale

    sc = config["scale"]
    with protocol_scale(sc["rc_big_bits"], sc["bitwise_log"]):
        comps = ComponentSet(Relations()).all
        for c, l in zip(comps, last.log_sizes):
            c.log_size = l
        rec["shape"] = {"comps": comps, "log_sizes": list(last.log_sizes),
                        "claimed_sums": list(last.claimed_sums),
                        "log_blowup": config["security"]["log_blowup"],
                        "log_last_layer": config["security"]["log_blowup"]
                        + config["security"]["log_last_layer_degree_bound"]}
        values = {}
        for m in metrics:
            v = reader(m["name"])(rec)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}

    result = {"metrics": values}
    if trace:
        ev = rec["events"]
        busy = union_ns([(s, s + d) for _, s, d in ev if s < w1 and s + d > w0]) / 1e9
        top = sorted(by_name(ev).items(), key=lambda kv: -kv[1])[:10]
        spans = [sp for j in jobs for sp in j["spans"]]
        gaps = sorted(label_gaps(idle_gaps(ev, w0, w1), spans).items(), key=lambda kv: -kv[1])[:10]
        result["breakdown"] = {"device_ops": [[n, d / 1e9] for n, d in top],
                               "idle_gaps": [[n, d / 1e9] for n, d in gaps]}
        result["device_extra"] = {"busy_s": busy, "window_s": rec["window_s"]}
        log(f"trace: {len(ev)} device events, clock skew {rec['clock_skew_us']:.1f} us")
    result["peak_bytes"] = max(setup_peak, rec["peak_window_bytes"])

    # the judgement, with the program's device state freed
    del rec, tracer
    if on_card:
        torch.cuda.empty_cache()
    result["checks"] = judge(config, jobs, seed)
    result["jobs"] = len(jobs)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    bench = load_benchmark()
    cell, config, mix = load_cell(bench, a.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        log(f"needs {cell['chips']} CUDA card(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    log(f"card: {card_line()}")
    res = run(cell, config, mix, cell_metrics(bench, cell, bool(a.trace)),
              a.seed, a.seconds, bool(a.trace))
    bad = forbidden_modules()
    if bad:
        log(f"loaded in this process: {', '.join(bad)}")
        return 3
    line = result_line(res, torch.cuda.get_device_name(0), bool(a.trace))
    for name, v in line["checks"].items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    print(json.dumps(line), flush=True)
    return 0


def result_line(res: dict, kind: str, trace: bool) -> dict:
    """The run's last line; the numbers compared, each with its limit,
    come last under ``checks``."""
    checks = {k: v for k, v in res["checks"].items() if isinstance(v, dict)}
    device = {"platform": "gpu", "kind": kind, "count": 1,
              "memory_peak_bytes": int(res["peak_bytes"])}
    if trace:
        device.update(res["device_extra"])
    line = {"correct": all(v["value"] <= v["limit"] for v in checks.values()),
            "attempted": res["jobs"], "failed": sum(v["value"] for v in checks.values()),
            "metrics": res["metrics"], "device": device}
    if trace:
        line["breakdown"] = res["breakdown"]
    line["checks"] = checks
    return line


if __name__ == "__main__":
    sys.exit(main())
