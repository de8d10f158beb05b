"""The window's arithmetic, the last line's form, the trace reductions and
the run's refusal without a card."""

import json
import subprocess
import sys

import pytest

from benchmark import run as R
from benchmark import trace as T


class FakeClock:
    def __init__(self):
        self.now = 0

    def __call__(self):
        return self.now


@pytest.mark.parametrize("job_s,seconds,want_jobs", [(3.0, 10, 4), (4.0, 8, 2), (20.0, 10, 1), (0.5, 0, 1)])
def test_no_job_starts_after_the_seconds(job_s, seconds, want_jobs):
    clock = FakeClock()
    starts = []

    def job():
        starts.append(clock.now)
        clock.now += int(job_s * 1e9)
        return {"t1": clock.now, "cycles": 1000}

    jobs, w0, w1 = R.run_window(job, seconds, clock)
    assert len(jobs) == want_jobs
    assert all(s - w0 < max(seconds, 1e-9) * 1e9 or s == w0 for s in starts)
    assert w1 == jobs[-1]["t1"] == w0 + int(job_s * 1e9) * want_jobs
    rate = R.reader("cycles_per_s")({"jobs": jobs, "window_s": (w1 - w0) / 1e9})
    assert rate == pytest.approx(1000 / job_s)


def _res(trace):
    res = {"checks": {"wrong_answers": {"value": 0, "limit": 0},
                      "rejected_proofs": {"value": 1, "limit": 0},
                      "jobs_answered": 3, "proofs_verified": 2, "reasons": ["x"]},
           "jobs": 3, "peak_bytes": 123, "metrics": {"setup_s": {"value": 1.5, "unit": "s"}}}
    if trace:
        res["device_extra"] = {"busy_s": 1.0, "window_s": 4.0}
        res["breakdown"] = {"device_ops": [["k", 0.5]], "idle_gaps": [["vm_adapter", 1.0]]}
    return res


@pytest.mark.parametrize("trace", [False, True])
def test_the_last_line(trace):
    line = R.result_line(_res(trace), "NVIDIA H100 80GB HBM3", trace)
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is False and line["failed"] == 1 and line["attempted"] == 3
    assert list(line["checks"]) == ["wrong_answers", "rejected_proofs"]
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert line["device"]["busy_s"] == 1.0 and line["device"]["window_s"] == 4.0
    json.dumps(line)


def test_union_gaps_and_labels():
    ev = [("a", 10, 5), ("b", 12, 10), ("c", 40, 5)]
    assert T.union_ns([(s, s + d) for _, s, d in ev]) == 17
    gaps = T.idle_gaps(ev, 0, 50)
    assert gaps == [(0, 10), (22, 40), (45, 50)]
    spans = [("vm_adapter", 0, 20), ("prove:pcs", 20, 50)]
    assert T.label_gaps(gaps, spans) == {"vm_adapter": 10, "prove:pcs": 23}
    assert T.by_name(ev + [("a", 0, 1)]) == {"a": 6, "b": 10, "c": 5}


def test_idle_share_and_launches_readers():
    rec = {"events": [("k", 10, 5), ("Memcpy HtoD", 30, 10), ("k", 45, 5)],
           "t0_ns": 0, "t1_ns": 100, "jobs": [{}, {}]}
    assert R.reader("device_idle_share")(rec) == pytest.approx(80.0)
    assert R.reader("launches_per_proof")(rec) == 1.0
    assert R.reader("kernA_roofline")(rec) is None
    assert R.reader("device_idle_share")({"jobs": [{}]}) is None


def test_refuses_without_a_card(tmp_path):
    """On a machine with no card the run exits non-zero and prints no line."""
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fib_loop.100k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=R.ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_without_the_port(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files: no
    result, a non-zero exit."""
    import shutil

    shutil.copy(R.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(R.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fib_loop.100k",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
