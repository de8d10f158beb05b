"""The chain job kind on the CPU at the tests' protocol scale: a chain of
3 segments proved by two CPU segment workers through the harness's chain
job, judged sound and judged wrong once for each fault the judge must
count; the control (one query fewer) rejected; the one-segment job's
record as it was; the workers' security equal to the production one; the
chain's traffic keeping its log sizes; the readers and the trace's
reduction on synthetic records; the workers' hook, which reports the
modules each worker loaded, and a run whose worker loads a forbidden
one giving no result."""

import copy
import json
import os
import subprocess
import sys
import time

import pytest

from benchmark import chain as C
from benchmark import run as R
from benchmark.conftest import small
from benchmark.traffic import Stream, load_mix

CELL = "fib_chain.10m.4card"
MIX = {"args": [{"low": 25, "high": 30}]}
STEPS = 100  # fib(25..30): 210..250 cycles, 3 segments


def _config():
    bench = R.load_benchmark()
    _, config, _ = R.load_cell(bench, CELL)
    c = small(config)
    c["segment_steps"] = STEPS
    return c


@pytest.fixture(scope="module")
def tiny_chain():
    """One chain job of fib(30) (250 cycles) on two CPU workers."""
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    return C.run_chain_job(C.Chain(_config(), 2, "cpu"), [30])


def test_the_chain_job(tiny_chain):
    job = tiny_chain
    assert job["cycles"] == 250 and [s["segment"] for s in job["segments"]] == [0, 1, 2]
    assert [s["worker"] for s in job["segments"]] == [0, 1, 0]
    assert all("proof" not in s for s in job["segments"]) and len(job["proofs"]) == 3
    assert job["t1"] > job["t0"] and job["wall_s"] > 0
    assert set(job["segments"][0]) >= {"prove_s", "verify_s", "worker", "device", "peak_bytes",
                                       "n_steps", "initial_root", "final_root"}
    assert job["worker_forbidden"] == [] and "workers" not in job


def test_a_sound_chain_is_judged_correct(tiny_chain):
    checks = C.judge_chain(_config(), [tiny_chain], 2**33 + 1)
    assert checks["wrong_answers"]["value"] == 0 and checks["rejected_proofs"]["value"] == 0
    assert checks["proofs_verified"] == 2 and checks["resumed_verified"] >= 1


def _swap(job):
    job["proofs"][0], job["proofs"][1] = job["proofs"][1], job["proofs"][0]


def _drop(job):
    del job["proofs"][1], job["segments"][1]


def _renumbered_drop(job):
    """The first segment dropped and the rest renumbered from 0."""
    del job["proofs"][0], job["segments"][0]
    for k, s in enumerate(job["segments"]):
        s["segment"] = k


def _root(job):
    job["proofs"][1]["public_data"]["initial_root"] ^= 1


def _output(job):
    out = job["proofs"][-1]["public_data"]["output"]
    out[0][1][0] = (out[0][1][0] + 1) % ((1 << 31) - 1)


def _stale(job):
    """The chain of the arguments before, handed back for new ones."""
    job["args"] = [job["args"][0] - 1]


FAULTS = [_swap, _drop, _renumbered_drop, _root, _output, _stale]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_a_broken_chain_is_a_wrong_answer(tiny_chain, fault):
    job = copy.deepcopy(tiny_chain)
    fault(job)
    checks = C.judge_chain(_config(), [job, tiny_chain], 7, n_verified=0)
    assert checks["wrong_answers"]["value"] == 1, checks["reasons"]


def test_an_altered_proof_is_rejected(tiny_chain):
    job = copy.deepcopy(tiny_chain)
    for p in job["proofs"]:
        p["interaction_pow_nonce"] += 1
    checks = C.judge_chain(_config(), [job], 11)
    assert checks["rejected_proofs"]["value"] == 2 and checks["wrong_answers"]["value"] == 0


def test_picks_hold_a_resumed_segment():
    jobs = [{"proofs": [0] * 10}, {"proofs": [0] * 10}]
    for seed in range(200):
        got = C.picks(jobs, seed, 2)
        assert len(set(got)) == 2 and any(k >= 1 for _, k in got)
    assert C.picks([{"proofs": [0]}], 5, 2) == [(0, 0)]


def test_the_control_is_rejected():
    """The program one query below the stated security, on a chain at the
    tests' scale, judged at the stated one."""
    from benchmark.control import readings

    os.environ.setdefault("OMP_NUM_THREADS", "1")
    out = readings(_config(), MIX, [2**35 + 7], device="cpu", chips=2, sides=("control",))
    (side, _, checks), = out
    assert side == "control" and checks["rejected_proofs"]["value"] >= 1, checks
    assert checks["wrong_answers"]["value"] == 0


def test_a_run_reads_its_chains(tiny_chain, monkeypatch):
    """`run_chain` over replayed chain jobs: the window, the readers, the
    device line's count and peak, the judgement."""
    bench = R.load_benchmark()
    cell, config, _ = R.load_cell(bench, CELL)
    replayed = []

    def job(chain, args, trace=False):
        j = copy.deepcopy(tiny_chain)
        j["t0"] = time.monotonic_ns()
        j["t1"] = j["t0"] + int(j["wall_s"] * 1e9)
        for s in j["segments"]:
            s["peak_bytes"] = 1000 + s["segment"]
        replayed.append(j)
        return j

    monkeypatch.setattr(C, "run_chain_job", job)
    age = R.process_age_s()
    res = C.run_chain(cell, _config(), MIX, R.cell_metrics(bench, cell, False), 3, 0, False,
                      device="cpu")
    line = R.result_line(res, "cpu", False)
    assert line["correct"] is True and line["attempted"] == 1
    assert line["device"]["count"] == 4 and line["device"]["memory_peak_bytes"] == 1002
    # the chain's rate is per layer here (PERF.md section 2)
    assert set(line["metrics"]) == {"peak_device_gib", "setup_s"}
    # no chain in set-up: the window's first chain ends it
    assert len(replayed) == 1
    wall = tiny_chain["wall_s"]
    assert age - 0.02 + wall <= line["metrics"]["setup_s"]["value"] <= R.process_age_s() + 0.02 + wall
    per_layer = [m["name"] for m in R.cell_metrics(bench, cell, True)]
    assert per_layer == ["chain_cycles_per_s", "chain_start_s", "chain_verify_share",
                         "chain_cold_prove_s"]
    res = C.run_chain(cell, _config(), MIX, R.cell_metrics(bench, cell, True), 3, 0, False,
                      device="cpu")
    assert res["metrics"]["chain_cycles_per_s"]["value"] == pytest.approx(250 / wall, rel=0.05)


@pytest.mark.parametrize("fault", [_drop, _output, _stale], ids=lambda f: f.__name__[1:])
def test_a_run_over_a_broken_chain_is_not_correct(tiny_chain, monkeypatch, fault):
    """A whole run, its window's chain broken underneath: a segment lost
    between the workers and the harness, an answer altered, a chain
    returned unchanged."""
    bench = R.load_benchmark()
    cell, _, _ = R.load_cell(bench, CELL)
    jobs = []

    def job(chain, args, trace=False):
        j = copy.deepcopy(tiny_chain)
        j["t0"] = time.monotonic_ns()
        j["t1"] = j["t0"] + 1
        fault(j)
        jobs.append(j)
        return j

    monkeypatch.setattr(C, "run_chain_job", job)
    res = C.run_chain(cell, _config(), MIX, R.cell_metrics(bench, cell, False), 5, 0, False,
                      device="cpu")
    assert R.result_line(res, "cpu", False)["correct"] is False


def test_the_segment_job_record_is_as_it_was():
    """The one-segment job of `fib_loop` and `sha256_1k`: chosen for a
    configuration without ``job``, and its record's keys unchanged."""
    from cairo_m_tpu_torch.prover import config as pc

    bench = R.load_benchmark()
    for name in ("fib_loop.100k", "sha256_1k.bench1k", "fib_loop.1m"):
        assert R.job_kind(R.load_cell(bench, name)[1]) == "segment"
    assert R.job_kind(R.load_cell(bench, CELL)[1]) == "chain"
    config = small(R.load_cell(bench, "fib_loop.100k")[1])
    R.set_port_scale(config)
    try:
        job = R.run_job(R.Program(config), [20], R.port_security(config), "cpu", lambda: None)
    finally:
        pc.set_production_scale()
    assert list(job) == ["args", "cycles", "proof", "phases", "vm_adapter_s", "prove_s",
                         "t0", "t1", "spans"]
    assert [s[0] for s in job["spans"]][:2] == ["vm_adapter", "prove:trace"]


def test_the_workers_security_is_the_configurations():
    """``test_config(n_queries=80, pow_bits=16)`` is ``REGULAR_96_BITS``, so
    the chain's workers prove at the stated security, and one query fewer
    reaches them."""
    from cairo_m_tpu_torch.prover.config import REGULAR_96_BITS, test_config

    from benchmark.control import weakened

    assert test_config(n_queries=80, pow_bits=16) == REGULAR_96_BITS
    _, config, _ = R.load_cell(R.load_benchmark(), CELL)
    assert test_config(**C.Chain(config, 4).test_config) == REGULAR_96_BITS
    assert C.Chain(config, 4).devices == ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    assert test_config(**C.Chain(weakened(config), 4).test_config) != REGULAR_96_BITS
    assert C.Chain(config, 4).test_scale == {"rc_big_bits": 20, "bitwise_log": 18}


def _last_segment_shape(n):
    from cairo_m_tpu_torch.prover import config as pc
    from cairo_m_tpu_torch.prover.adapter.native_import import native_segment_prover_inputs
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet
    from cairo_m_tpu_torch.prover.relations import Relations

    _, config, _ = R.load_cell(R.load_benchmark(), CELL)
    pc.set_production_scale()
    prog = R.Program(config)
    for last in native_segment_prover_inputs(prog.program, prog.entry, prog.slots([n]),
                                             config["segment_steps"]):
        pass
    comps = ComponentSet(Relations())
    comps.write_traces(last)
    return [c.log_size for c in comps.all]


def test_the_chain_traffic_keeps_every_log_size():
    """Every n of the mix gives 10 segments whose last has the log sizes of
    the upstream's n = 1,250,000 (9 full segments are alike for every n)."""
    from benchmark.reference.answers import fib_chain

    mix = load_mix("fib_chain_10m")
    lo, hi = mix["args"][0]["low"], mix["args"][0]["high"]
    for n in (lo, hi):
        assert -(-fib_chain.cycles([n]) // 1048575) == 10
    want = _last_segment_shape(1250000)
    for n in (lo, Stream(mix, 2**36 + 5).next()[0]):
        assert _last_segment_shape(n) == want, n
    assert _last_segment_shape(lo - 19) != want


def _rec(jobs, overhead=0.0):
    for j in jobs:
        j["trace_overhead_s"] = overhead
    return {"jobs": jobs}


def _seg(k, worker, prove, verify, n_steps=100):
    return {"segment": k, "worker": worker, "prove_s": prove, "verify_s": verify,
            "n_steps": n_steps}


def test_the_segment_worker_readers():
    job = {"wall_s": 30.0, "cycles": 340, "segments": [
        _seg(0, 0, 10.0, 1.0), _seg(1, 1, 9.0, 1.0), _seg(2, 0, 4.0, 1.0),
        _seg(3, 1, 3.0, 0.5, n_steps=40)]}
    rec = _rec([job, copy.deepcopy(job)], overhead=2.0)
    assert R.reader("chain_start_s")(rec) == pytest.approx(30.0 - 2.0 - 16.0)
    assert R.reader("chain_verify_share")(rec) == pytest.approx(100 * 3.5 / 29.5)
    # worker 0: 10 - 4; worker 1 has no later full segment
    assert R.reader("chain_cold_prove_s")(rec) == pytest.approx(6.0)
    rec["window_s"] = 40.0
    assert R.reader("chain_cycles_per_s")(rec) == pytest.approx(2 * 340 / 40.0)
    for name in ("chain_cycles_per_s", "chain_start_s", "chain_verify_share",
                 "chain_cold_prove_s"):
        assert R.reader(name)({"jobs": []}) is None
    # a one-segment record has no chain to read
    assert R.reader("chain_cycles_per_s")({"jobs": [{"cycles": 5}], "window_s": 1.0}) is None


def test_the_traced_chain_reduction():
    """Busy seconds the mean over the cards, a card with no worker counted
    idle; idle seconds by the phase of the worker holding the card."""
    job = {"t0": 0, "t1": 1000, "segments": [_seg(0, 0, 0, 100e-9), _seg(1, 1, 0, 0)],
           "workers": [{"proc_id": 0, "device": 0, "busy": [[100, 200], [300, 400]],
                        "by_name": {"k": 200, "j": 10}, "prove": [[50, 250]]}]}
    phases = C.worker_phases(job, job["workers"][0])
    assert phases[:2] == [("prove", 50, 250), ("verify", 250, 350)]
    breakdown, extra = C.trace_summary([job], 0, 1000, 2)
    assert extra == {"busy_s": 100e-9, "window_s": 1e-6}
    assert breakdown["device_ops"] == [["k", 100e-9], ["j", 5e-9]]
    gaps = dict(breakdown["idle_gaps"])
    # card 0: [0, 100) (its midpoint in the prove span), [200, 300) verify,
    # [400, 1000) exit; card 1, with no worker: [0, 1000) the harness's
    assert gaps == pytest.approx({"prove": 50e-9, "verify": 50e-9, "exit": 300e-9,
                                  "harness": 500e-9})
    with pytest.raises(RuntimeError):
        C.trace_summary([dict(job, workers=[])], 0, 1000, 2)


def _probe(tmp_path, env_extra, code):
    """Run ``code`` in a fresh interpreter with the workers' hook and a
    hidden sitecustomize (which imports a stand-in ``jaxlib`` from its own
    directory) on ``PYTHONPATH``; -> its standard output."""
    hidden = tmp_path / "hidden"
    hidden.mkdir()
    (hidden / "jaxlib.py").write_text("")
    (hidden / "sitecustomize.py").write_text("import builtins, jaxlib\nbuiltins.HIDDEN_RAN = 1\n")
    env = {k: v for k, v in os.environ.items() if k not in (C.DIR_ENV, C.TRACE_ENV)}
    env.update(env_extra, PYTHONPATH=os.pathsep.join([str(C.WORKER_HOOK), str(hidden)]))
    return subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120, check=True).stdout


def test_the_worker_hook_is_off_without_its_variable(tmp_path):
    """On a worker's PYTHONPATH without ``CM_BENCH_WORKER_DIR`` the
    workers' sitecustomize loads nothing and writes nothing, and runs the
    sitecustomize it hides."""
    out = _probe(tmp_path, {}, "import sys, json, builtins; print(json.dumps(["
                 "builtins.HIDDEN_RAN, 'torch' in sys.modules, sys.modules['sitecustomize'].__file__]))")
    ran, torch_loaded, where = json.loads(out)
    assert ran == 1 and not torch_loaded and where.startswith(str(C.WORKER_HOOK))
    assert sorted(p.name for p in tmp_path.iterdir()) == ["hidden"]


def test_a_worker_reports_its_modules(tmp_path):
    """With ``CM_BENCH_WORKER_DIR`` a process reports, as it exits, the
    top-level names of every module it loaded (the stand-in ``jaxlib``
    among them), and no trace."""
    reports = tmp_path / "reports"
    reports.mkdir()
    _probe(tmp_path, {C.DIR_ENV: str(reports)}, "import email.mime.text")
    (report,) = [json.loads(p.read_text()) for p in reports.iterdir()]
    assert {"email", "jaxlib", "sitecustomize"} <= set(report["modules"])
    assert "email.mime" not in report["modules"] and "torch" not in report["modules"]
    assert set(report) == {"proc_id", "modules"} and report["proc_id"] == -1
    assert R.forbidden_modules(report["modules"]) == ["jaxlib"]


def test_a_run_whose_worker_loads_a_forbidden_module_gives_no_result(tmp_path, monkeypatch,
                                                                        capsys):
    """A whole run of the chain cell on two CPU workers, each of which
    loads a stand-in ``jaxlib``: the run names it and prints no line."""
    hidden = tmp_path / "hidden"
    hidden.mkdir()
    (hidden / "jaxlib.py").write_text("")
    (hidden / "sitecustomize.py").write_text("import jaxlib\n")
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(hidden), os.environ.get("PYTHONPATH")) if p))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    bench = R.load_benchmark()
    cell, _, _ = R.load_cell(bench, CELL)
    res = C.run_chain(dict(cell, chips=2), _config(), MIX, R.cell_metrics(bench, cell, False),
                      9, 0, False, device="cpu")
    assert res["worker_forbidden"] == ["jaxlib"]
    assert R.result_line(res, "cpu", False)["correct"] is True
    capsys.readouterr()
    assert R.finish(res, "cpu", False) == 3
    out, err = capsys.readouterr()
    assert out == "" and "jaxlib (a segment worker)" in err
