"""``python -m cairo_m_tpu_torch.bench``, the port's counterpart of the
repository's ``bench.py``, on the CPU:

- the bench's protocol at fib(40) on ``cpu``, at test scale
  (set_test_scale(10, 8), test_config(n_queries=8, pow_bits=2)): its timed
  proof hashes to tests/golden/fib40_proof_sha256.json (the reference's
  proof of the Python VM's input, which the native input equals; bench.py's
  source compiles to the same program as the golden's) and verifies;
- its line carries exactly the keys bench.py writes;
- in a fresh interpreter that cannot import JAX or cairo_m_tpu: with no
  ``--device`` and no card, one line with ``value`` 0.0 and the missing
  device as its error, exit code 1; under SIGTERM during the first
  production-scale prove on ``cpu``, one line and exit code 75.
"""

import json
import os
import select
import signal
import subprocess
import time

import pytest
import torch

from cairo_m_tpu_torch import bench
from torch_port_helpers import (
    GOLDEN_DIR,
    both_at_test_scale,
    configs,
    no_jax_command,
    proof_sha256,
)

REPO = os.path.dirname(os.path.dirname(GOLDEN_DIR))
# the keys of bench.py's line on a finished run, each with the line of
# bench.py that writes it
LINE_KEYS = {
    "metric": 57, "value": 58, "unit": 59, "vs_baseline": 60, "detail": 61,
}
DETAIL_KEYS = {
    "stage": 92, "n_cycles": 92, "prove_s": 92,
    "adapter_s": 186, "warmup_s": 187, "phases": 188, "device": 189,
    "verified": 192,
}
# written on the other exit paths: after the warm-up alone, and on an error
DETAIL_KEYS_ELSE = {"note": 177, "error": 203, "traceback": 204}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("BENCH_FIB_ITERS", None)
    return env


@pytest.fixture(scope="module")
def fib40_run():
    with both_at_test_scale():
        return bench.run(40, configs()[1], "cpu")


def test_bench_py_writes_these_keys():
    with open(os.path.join(REPO, "bench.py")) as f:
        src = f.read().splitlines()
    for keys in (LINE_KEYS, DETAIL_KEYS, DETAIL_KEYS_ELSE):
        for key, lineno in keys.items():
            text = src[lineno - 1]
            assert f'"{key}"' in text or f"{key}=" in text, (key, lineno, text)


def test_bench_source_is_bench_py_s():
    with open(os.path.join(REPO, "bench.py")) as f:
        assert bench.FIB_SRC in f.read()


def test_bench_proof_equals_golden(fib40_run):
    _, proof = fib40_run
    with open(os.path.join(GOLDEN_DIR, "fib40_proof_sha256.json")) as f:
        assert proof_sha256(proof) == json.load(f)["sha256"]


def test_bench_line_has_bench_py_keys(fib40_run):
    line, _ = fib40_run
    assert list(line) == list(LINE_KEYS)
    assert set(line["detail"]) == set(DETAIL_KEYS)
    assert line["metric"] == "fibonacci_cycles_proved_per_sec"
    assert line["unit"] == "cycles/s"


def test_bench_line_values(fib40_run):
    line, _ = fib40_run
    d = line["detail"]
    assert d["stage"] == "done" and d["verified"] is True
    assert d["n_cycles"] == 330 and d["device"] == "cpu"
    # prove_s is rounded to milliseconds, the value from the unrounded seconds
    assert line["value"] == pytest.approx(330 / d["prove_s"], rel=1e-3)
    assert line["vs_baseline"] == round(line["value"] / 1e6, 4)
    assert set(d["phases"]) == {"trace", "interaction", "composition", "pcs", "total",
                                "poseidon2_witness"}
    assert d["warmup_s"] > 0 and d["adapter_s"] > 0


def test_bench_without_a_card_prints_one_line_and_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available: the default device exists")
    res = subprocess.run(no_jax_command("cairo_m_tpu_torch.bench"),
                         capture_output=True, text=True, cwd=REPO, env=_env(),
                         timeout=300)
    assert res.returncode == 1, res.stderr[-3000:]
    (out,) = res.stdout.splitlines()
    line = json.loads(out)
    assert line["value"] == 0.0 and line["vs_baseline"] == 0.0
    assert "no CUDA device" in line["detail"]["error"]
    assert "traceback" in line["detail"] and "n_cycles" not in line["detail"]


def test_bench_sigterm_during_the_first_prove_exits_75():
    """Production scale on the CPU, stopped once the bench says it is
    proving: the handler writes the line between two torch operations."""
    proc = subprocess.Popen(
        no_jax_command("cairo_m_tpu_torch.bench", ["--device", "cpu"]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, cwd=REPO, env=_env())
    try:
        deadline = time.time() + 300
        seen = b""
        while b"proving fib(100000)" not in seen:
            left = deadline - time.time()
            ready, _, _ = select.select([proc.stderr], [], [], max(left, 0))
            chunk = os.read(proc.stderr.fileno(), 65536) if ready else b""
            assert chunk, f"no 'proving' line: {seen[-3000:]!r}"
            seen += chunk
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 75, err[-3000:]
    (text,) = out.decode().splitlines()
    line = json.loads(text)
    assert line["value"] == 0.0
    assert line["detail"] == {"stage": "adapter_done"}
