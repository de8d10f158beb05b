"""What a run and the reference load: no module whose top-level name is
jax, jaxlib, flax or cairo_m_tpu (compared whole: cairo_m_tpu_torch is
the port), and the reference loads no part of the port either."""

import subprocess
import sys

from benchmark.run import ROOT

PROBE = """
import sys, importlib, pathlib
for m in {mods!r}:
    importlib.import_module(m)
for p in pathlib.Path('benchmark/metrics').glob('*.py'):
    from benchmark.run import reader
    reader(p.stem)
print(sorted({{m.split('.')[0] for m in sys.modules}}))
"""


def _loaded(mods):
    out = subprocess.run([sys.executable, "-c", PROBE.format(mods=mods)], cwd=ROOT,
                         capture_output=True, text=True, timeout=300, check=True)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    loaded = _loaded(["benchmark.run", "benchmark.control", "benchmark.trace", "benchmark.chain",
                      "cairo_m_tpu_torch.parallel.segments",
                      "benchmark.yardstick", "cairo_m_tpu_torch.prover.prove",
                      "cairo_m_tpu_torch.prover.verify", "cairo_m_tpu_torch.compiler",
                      "cairo_m_tpu_torch.prover.adapter.native_import"])
    assert not loaded & {"jax", "jaxlib", "flax", "cairo_m_tpu"}
    assert "cairo_m_tpu_torch" in loaded


def test_the_reference_loads_neither_package():
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, benchmark.reference.verify, benchmark.reference.answers.fib_loop, "
         "benchmark.reference.answers.sha256_1k, benchmark.reference.answers.fib_chain; print(sorted({m.split('.')[0] for m in sys.modules}))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "cairo_m_tpu", "cairo_m_tpu_torch", "torch"}
