"""Chained continuation segments of cairo_m_tpu_torch, on the CPU at test
scale (set_test_scale(10, 8), test_config(n_queries=8, pow_bits=2)).

fibonacci(40) (330 cycles) is cut into segments of at most 100 steps by the
native VM's resume path and proved by two worker processes:

- every segment's proof hashes to the reference's
  (tests/golden/fib40_segments_sha256.json) and the root chain holds;
- a worker runs with ``jax`` and ``cairo_m_tpu`` made unimportable;
- the chain check raises on an incomplete set and on a broken chain.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from cairo_m_tpu_torch.parallel.segments import (
    check_chain,
    prove_segments_multiprocess,
)
from torch_port_helpers import (
    FIB_SRC,
    SEGMENT_MAX_STEPS,
    reference_fib40_segment_digests,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GOLDEN = os.path.join(TESTS, "golden", "fib40_segments_sha256.json")
TEST_SCALE = {"rc_big_bits": 10, "bitwise_log": 8}
TEST_CONFIG = {"n_queries": 8, "pow_bits": 2}


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)["sha256"]


def _digest(proof_obj) -> str:
    return hashlib.sha256(json.dumps(proof_obj, sort_keys=True).encode()).hexdigest()


@pytest.fixture
def one_thread(monkeypatch):
    """Workers are fresh interpreters: one intra-op thread each keeps them
    from oversubscribing the cores beside the other test workers."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def test_two_workers_match_reference_digests(one_thread):
    records = prove_segments_multiprocess(
        FIB_SRC, "main", [40], SEGMENT_MAX_STEPS, devices=["cpu", "cpu"],
        n_processes=2, test_scale=TEST_SCALE, test_config=TEST_CONFIG,
    )
    assert [_digest(r["proof"]) for r in records] == _golden()
    assert [r["worker"] for r in records] == [0, 1, 0, 1]
    assert sum(r["n_steps"] for r in records) == 8 * 40 + 10
    for a, b in zip(records, records[1:]):
        assert a["final_root"] == b["initial_root"]
    # CPU tensors take the plain versions: no kernel launches
    assert all(set(r["launches"].values()) == {0} for r in records)


_NO_JAX_WORKER = """
import sys
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path.insert(0, {repo!r})
from cairo_m_tpu_torch.parallel.segments import _worker_main
_worker_main({argv!r})
assert not any(m.split(".")[0] in ("jax", "cairo_m_tpu") for m, v in sys.modules.items() if v)
"""


def test_worker_runs_without_jax(tmp_path, one_thread):
    """Worker 0 of 4 proves segment 0 alone, in an interpreter that cannot
    import JAX or the reference package."""
    with open(tmp_path / "job.json", "w") as f:
        json.dump({"source": FIB_SRC, "entrypoint": "main", "args": [40],
                   "max_steps": SEGMENT_MAX_STEPS, "test_scale": TEST_SCALE,
                   "test_config": TEST_CONFIG}, f)
    argv = ["--coordinator", "localhost:0", "--num-procs", "4", "--proc-id", "0",
            "--workdir", str(tmp_path), "--device", "cpu"]
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_WORKER.format(repo=REPO, argv=argv)],
        capture_output=True, text=True, cwd=REPO, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    with open(tmp_path / "proofs_0.json") as f:
        records = json.load(f)
    assert [r["segment"] for r in records] == [0]
    assert _digest(records[0]["proof"]) == _golden()[0]


def _record(k, initial, final):
    return {"segment": k, "initial_root": initial, "final_root": final}


@pytest.mark.parametrize("records, message", [
    ([_record(0, 1, 2), _record(2, 3, 4)], "incomplete"),
    ([_record(0, 1, 2), _record(0, 1, 2)], "incomplete"),
    ([_record(1, 2, 3), _record(0, 1, 5)], "chain broken"),
], ids=["missing", "duplicated", "broken_chain"])
def test_check_chain_raises(records, message):
    with pytest.raises(RuntimeError, match=message):
        check_chain(records)


def test_check_chain_sorts_an_intact_chain():
    records = [_record(2, 3, 4), _record(0, 1, 2), _record(1, 2, 3)]
    assert [r["segment"] for r in check_chain(records)] == [0, 1, 2]


def test_devices_required():
    with pytest.raises(ValueError):
        prove_segments_multiprocess(FIB_SRC, "main", [40], SEGMENT_MAX_STEPS,
                                    devices=[])


@pytest.mark.slow
def test_golden_digests_are_the_reference_proofs():
    assert reference_fib40_segment_digests() == _golden()
