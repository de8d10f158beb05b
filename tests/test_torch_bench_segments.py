"""``python -m cairo_m_tpu_torch.bench_segments``, the port's counterpart of
the repository's ``scripts/bench_segments.py``, on the CPU at test scale
(set_test_scale(10, 8), test_config(n_queries=8, pow_bits=2)):

- fib(40) (330 cycles) cut at ``SEG_MAX_STEPS=100`` gives four segments,
  proved in turn in this process; their digests equal
  tests/golden/fib40_segments_sha256.json in order, the root chain holds
  and every proof verifies;
- its line carries exactly the keys scripts/bench_segments.py writes;
- in a fresh interpreter that cannot import JAX or cairo_m_tpu, with no
  ``--device`` and no card, it fails naming the missing device.
"""

import json
import os
import subprocess

import pytest
import torch

from cairo_m_tpu_torch import bench_segments, profile
from torch_port_helpers import (
    GOLDEN_DIR,
    SEGMENT_MAX_STEPS,
    both_at_test_scale,
    configs,
    no_jax_command,
    proof_sha256,
)

REPO = os.path.dirname(os.path.dirname(GOLDEN_DIR))
SCRIPT = os.path.join(REPO, "scripts", "bench_segments.py")
# the keys of scripts/bench_segments.py's line, in order, each with the line
# of the script that writes it
LINE_KEYS = {
    "metric": 93, "value": 94, "unit": 95, "segments": 96,
    "total_cycles": 97, "prove_s": 98, "adapter_s": 99, "warm_value": 100,
    "warm_segments": 101, "per_segment": 102, "root_chain_ok": 103,
    "all_verified": 104, "wall_s": 105, "device": 106,
}


@pytest.fixture(scope="module")
def fib40_chain():
    with both_at_test_scale():
        return bench_segments.run(40, SEGMENT_MAX_STEPS, configs()[1], "cpu")


def test_script_writes_these_keys():
    with open(SCRIPT) as f:
        src = f.read().splitlines()
    for key, lineno in LINE_KEYS.items():
        assert src[lineno - 1].strip().startswith(f'"{key}":'), (key, lineno)


def test_knobs_and_source_are_the_script_s():
    with open(SCRIPT) as f:
        text = f.read()
    assert profile.FIB_SRC in text
    assert 'os.environ.get("SEG_FIB_ITERS", "1250000")' in text
    assert bench_segments.DEFAULT_ITERS == 1_250_000
    assert 'str((1 << 20) - 1)' in text
    assert bench_segments.DEFAULT_MAX_STEPS == (1 << 20) - 1


def test_segment_proofs_equal_golden(fib40_chain):
    _, proofs = fib40_chain
    with open(os.path.join(GOLDEN_DIR, "fib40_segments_sha256.json")) as f:
        want = json.load(f)["sha256"]
    assert len(want) == 4
    assert [proof_sha256(p) for p in proofs] == want


def test_line_has_the_script_s_keys(fib40_chain):
    line, _ = fib40_chain
    assert list(line) == list(LINE_KEYS)
    assert line["metric"] == "fib10m_cycles_proved_per_sec"
    assert line["unit"] == "cycles/s"


def test_line_values(fib40_chain):
    line, _ = fib40_chain
    assert line["root_chain_ok"] is True and line["all_verified"] is True
    assert line["segments"] == 4 and line["total_cycles"] == 330
    assert [c for c, _ in line["per_segment"]] == [100, 100, 100, 30]
    assert line["warm_segments"] == 3 and line["device"] == "cpu"
    assert line["value"] == pytest.approx(330 / line["prove_s"], rel=1e-2)
    assert line["warm_value"] > 0 and line["wall_s"] >= line["prove_s"]


def test_without_a_card_it_fails_without_jax():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available: the default device exists")
    env = dict(os.environ, OMP_NUM_THREADS="1", SEG_FIB_ITERS="40",
               SEG_MAX_STEPS=str(SEGMENT_MAX_STEPS))
    res = subprocess.run(no_jax_command("cairo_m_tpu_torch.bench_segments"),
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=300)
    assert res.returncode == 1 and res.stdout == ""
    assert "no CUDA device is available" in res.stderr
    assert "AssertionError" not in res.stderr  # no module of JAX was loaded
