"""Benchmark: prove the fibonacci loop end to end, report cycles proved/s.

    python -m cairo_m_tpu_torch.bench [--device cuda] [--test-scale]

The counterpart of the repository's ``bench.py`` (the JAX package's
bench), with its protocol, knobs and line.  Prints ONE JSON line on
standard output:

  {"metric": "fibonacci_cycles_proved_per_sec", "value": N,
   "unit": "cycles/s", "vs_baseline": N, "detail": {...}}

Protocol: compile the fibonacci loop -> run the native VM + adapter
(``native_prover_input``) for ``BENCH_FIB_ITERS`` iterations (default
100,000: 800,010 cycles) -> prove at ``REGULAR_96_BITS`` -> verify.  The
first prove warms the process (the kernels' first load, plan recording,
the preprocessed commitment, twiddles); the second is timed, with the
device synced before and after (`profile.timed_prove`).  ``value`` is
cycles/s of the timed prove, ``vs_baseline`` its ratio to 1e6 cycles/s
(``bench.py``'s baseline, BASELINE.md).  ``detail`` holds ``stage``,
``n_cycles``, ``prove_s``, ``adapter_s`` (compile + VM + adapter),
``warmup_s``, ``phases`` (the prover's ``timing``), ``device`` (the card's
name, or ``cpu``) and ``verified``; after the warm-up alone it holds the
warm-up's rate and a ``note``.  The timed prove's kernel launches by kernel
go to standard error as ``kernel launches {...}``, after a ``proving``
line when the first prove starts.

Once the run starts, every exit path writes the line once: normal
completion, SIGTERM and SIGINT (``os.write`` from the handler), and any
exception (recorded in ``detail.error`` and ``detail.traceback``; the best
measurement so far is kept).  The exit code is 75 when a signal comes
before any prove has finished, 1 when an error does, and 0 otherwise.

``--device`` defaults to the card and fails without one: the line then
carries the error, ``value`` 0.0 and exit code 1, never a CPU measurement.
``--device cpu`` runs the plain versions of the kernels; ``--test-scale``
the tests' protocol scale (``set_test_scale(10, 8)``,
``test_config(n_queries=8, pow_bits=2)``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import time
import traceback

import torch

from . import profile
from .compiler import compile_cairo
from .device import DEFAULT_DEVICE, resolve_device
from .prover.adapter.native_import import native_prover_input
from .prover.verify import verify_cairo_m

METRIC = "fibonacci_cycles_proved_per_sec"
DEFAULT_ITERS = 100_000
BASELINE_CYCLES_PER_SEC = 1e6
# the source of bench.py, as it is there
FIB_SRC = """
fn main(n: felt) -> felt {
    let a = 0;
    let b = 1;
    let i = 0;
    while i != n {
        let t = a + b;
        a = b;
        b = t;
        i = i + 1;
    }
    return a;
}
"""


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def device_name(device: torch.device) -> str:
    """What a line records as its device: the card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def new_line() -> dict:
    return {"metric": METRIC, "value": 0.0, "unit": "cycles/s",
            "vs_baseline": 0.0, "detail": {"stage": "startup"}}


def measured(line: dict) -> bool:
    """Whether a prove has finished and the line holds its rate."""
    return "prove_s" in line["detail"]


def _record(line, value, n_cycles, prove_s, stage, **extra):
    detail = {"stage": stage, "n_cycles": n_cycles, "prove_s": round(prove_s, 3)}
    detail.update(extra)
    line["value"] = round(value, 2)
    line["vs_baseline"] = round(value / BASELINE_CYCLES_PER_SEC, 4)
    line["detail"] = detail


def run(iters: int, cfg, device=DEFAULT_DEVICE, line: dict | None = None):
    """The bench's protocol on ``device``; fills ``line`` (a `new_line`,
    which a signal handler may print at any point) as it goes.
    -> (line, the timed proof)."""
    line = new_line() if line is None else line
    device = resolve_device(device)
    t0 = time.time()
    program = compile_cairo(FIB_SRC).program
    pi = native_prover_input(program, "main", [iters])
    n_cycles = pi.total_steps
    adapter_s = time.time() - t0
    line["detail"]["stage"] = "adapter_done"
    log(f"proving fib({iters}): {n_cycles} cycles on {device_name(device)}; "
        f"compile + native VM + adapter {adapter_s:.3f} s")

    _, warm = profile.timed_prove(pi, cfg, device)
    _record(line, n_cycles / warm["seconds"], n_cycles, warm["seconds"],
            "warm_prove_done",
            note="warm-run rate (includes the kernels' first load, plan "
                 "recording and the preprocessed commitment)")

    proof, rec = profile.timed_prove(pi, cfg, device)
    _record(line, n_cycles / rec["seconds"], n_cycles, rec["seconds"],
            "timed_prove_done",
            adapter_s=round(adapter_s, 3),
            warmup_s=round(warm["seconds"], 3),
            phases={k: round(v, 3) for k, v in rec["phases"].items()},
            device=device_name(device))
    log(f"timed prove {rec['seconds']:.3f} s; kernel launches "
        + json.dumps(rec["launches"]))

    line["detail"]["verified"] = bool(verify_cairo_m(proof, cfg, device=device))
    line["detail"]["stage"] = "done"
    return line, proof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cairo_m_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--test-scale", action="store_true",
                    help="set_test_scale(10, 8), 8 queries, 2 PoW bits")
    args = ap.parse_args(argv)
    iters = int(os.environ.get("BENCH_FIB_ITERS", str(DEFAULT_ITERS)))
    line = new_line()
    emitted = []

    def emit():
        if not emitted:
            emitted.append(True)
            # async-signal-safe: bytes straight to fd 1, no buffered print
            os.write(1, (json.dumps(line) + "\n").encode())

    def on_signal(signum, frame):
        emit()
        # non-zero when no prove finished: a stop this early is a failure,
        # not a 0.0-throughput reading
        os._exit(0 if measured(line) else 75)

    signal.signal(signal.SIGTERM, on_signal)
    signal.signal(signal.SIGINT, on_signal)
    rc = 0
    try:
        # standard output carries the line alone
        with contextlib.redirect_stdout(sys.stderr):
            run(iters, profile.scale_config(args.test_scale), args.device, line)
    except Exception as e:  # noqa: BLE001 - the line records any failure
        line["detail"]["error"] = repr(e)[:500]
        line["detail"]["traceback"] = traceback.format_exc(limit=8)[-1500:]
        rc = 0 if measured(line) else 1
    # disarm the handlers first, so that the line cannot be written twice
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    emit()
    return rc


if __name__ == "__main__":
    sys.exit(main())
