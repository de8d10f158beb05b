"""On the card (marker ``cuda``; skips without one): one short run of
each cell end to end, at the cell's own size, comes out correct, and the
control on one seed reads rejected."""

import json
import subprocess
import sys

import pytest

from benchmark import run as R

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", ["fib_loop.100k", "sha256_1k.bench1k"])
def test_a_short_run_is_correct(cuda_card, cell):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                          "--seed", "2718281828", "--seconds", "1", "--trace", "0"],
                         cwd=R.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"


def test_the_control_reads_rejected(cuda_card):
    from benchmark.control import readings

    bench = R.load_benchmark()
    _, config, mix = R.load_cell(bench, "fib_loop.100k")
    for side, _, checks in readings(config, mix, [1414213562], device=cuda_card):
        assert checks["rejected_proofs"]["value"] == (0 if side == "program" else 1)
