"""The harness's hook in a segment worker of a chain run.

A chain's proofs are made in worker processes that the port starts
(``cairo_m_tpu_torch.parallel.segments``), out of the harness's sight.
For every chain the harness puts this directory on the workers'
``PYTHONPATH`` and names a directory in ``CM_BENCH_WORKER_DIR``; Python
then loads this module when each worker starts, and when the worker
exits it writes ``worker_<pid>.json`` there: its ``--proc-id`` and the
top-level names of every module in its ``sys.modules`` (``modules``),
which the harness holds to the rule it holds its own process to.  Its
exit handler is registered before the worker's code runs, so it runs
after the worker's own handlers and sees their imports too.

With ``CM_BENCH_WORKER_TRACE`` set as well (``--trace 1``) it also traces
the worker's card.  It leaves the worker as it is until the worker makes
its card current (``torch.cuda.set_device``, which the port calls before
it allocates), so that no context is made on another card, and then:

- makes the card's context (which the worker's first allocation would
  make), then opens `benchmark.trace.DeviceTrace` on that card (CUDA
  activity only, put on ``time.monotonic_ns``, the harness's clock);
- makes a recorder of the program's spans active
  (``cairo_m_tpu_torch.prover.observe.record``), for the ``prove`` spans'
  times;

and its report adds its card, the union of its device activity as
disjoint ``[start, end]`` pairs, device nanoseconds by kernel name, its
``prove`` spans, when it made its card current (``set_device_ns``), the
nanoseconds the context took (``context_ns``), and those the trace cost
it: opening (``start_ns``) and flushing (``flush_ns``).

Without ``CM_BENCH_WORKER_DIR`` it does nothing.  Either way it first
runs any ``sitecustomize`` that it hides on ``sys.path``.
"""

import os
import sys


def _run_hidden():
    import importlib.machinery
    import importlib.util

    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    spec = importlib.machinery.PathFinder.find_spec("sitecustomize", rest)
    if spec is not None and spec.loader is not None:
        spec.loader.exec_module(importlib.util.module_from_spec(spec))


_run_hidden()

OUT = os.environ.get("CM_BENCH_WORKER_DIR")
TRACE = bool(os.environ.get("CM_BENCH_WORKER_TRACE"))
_state = {}


def _start(torch):
    import time

    from benchmark.trace import DeviceTrace
    from cairo_m_tpu_torch.prover import observe

    t0 = time.monotonic_ns()
    card = torch.device("cuda", torch.cuda.current_device())
    torch.empty(1, device=card)
    torch.cuda.synchronize(card)
    t1 = time.monotonic_ns()
    _state.update(card=card.index, set_device_ns=t0, context_ns=t1 - t0)
    _state["record"] = observe.record()
    _state["rec"] = _state["record"].__enter__()
    _state["trace"] = DeviceTrace(torch, card).__enter__()
    _state["start_ns"] = time.monotonic_ns() - t1


def _proc_id():
    argv = sys.argv
    return int(argv[argv.index("--proc-id") + 1]) if "--proc-id" in argv else -1


def _trace_report():
    import time

    from benchmark.trace import by_name, merged_ns

    t = time.monotonic_ns()
    tracer = _state.pop("trace")
    tracer.__exit__(None, None, None)
    spans, _ = _state["rec"].drain()
    _state["record"].__exit__(None, None, None)
    ev = tracer.events
    out = {"device": _state["card"], "events": len(ev), "clock_skew_us": tracer.clock_skew_us,
           "busy": merged_ns((s, s + d) for _, s, d in ev),
           "by_name": by_name(ev),
           "prove": sorted([s.start, s.end] for s in spans
                           if s.name == "prove" and s.parent is None)}
    out.update({k: _state[k] for k in ("set_device_ns", "context_ns", "start_ns")})
    out["flush_ns"] = time.monotonic_ns() - t
    return out


def _report():
    import json

    out = {"proc_id": _proc_id()}
    if "trace" in _state:
        out.update(_trace_report())
    out["modules"] = sorted({m.split(".")[0] for m in list(sys.modules)})
    with open(os.path.join(OUT, f"worker_{os.getpid()}.json"), "w") as fh:
        json.dump(out, fh)


if OUT:
    import atexit

    if TRACE:
        import torch

        _set_device = torch.cuda.set_device

        def set_device(device):
            _set_device(device)
            if not _state:
                _start(torch)

        torch.cuda.set_device = set_device
    atexit.register(_report)
