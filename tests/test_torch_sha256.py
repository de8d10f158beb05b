"""The SHA-256 example (examples/sha256/sha256.cm) in cairo_m_tpu_torch,
held to ``hashlib`` and to the JAX reference: the port's counterpart of
tests/test_sha256_example.py.  ``main`` hashes "abc" (the JAX package's
README proof); ``bench1k`` hashes a 1 KiB message in 16 blocks, the Rust
reference's second prover benchmark, a 292,715-step trace that keeps 30
components busy, 12 of them u32 opcodes.

Tier-1:

- the port's Python VM, its native VM core (return values read back from
  the prover input's output cells) and its command line's ``run`` give the
  digest words of ``hashlib.sha256``, for both entry points;
- at production scale, the port's native prover input equals the JAX
  package's native prover input, and the command line's route (Python VM
  + adapter, as ``prove`` runs it) equals the port's native route;
- constraint level (`WitnessInputChecks`, witnesses ``sha256_main`` and
  ``sha256_bench1k`` of tests/golden/witnesses.json): equal traces, the
  live components, the native input equal to the reference's Python VM +
  adapter, constraints and LogUp balance in both packages (``bench1k``'s
  constraints and balance in the slow tier: ~60 s in each package).

The slow tier proves both entry points with the port on the CPU at
``REGULAR_96_BITS``: each proof equals the committed reference digest
(tests/golden/sha256_<entry>_production_sha256.json), is byte-equal to the
live reference proof, and each package verifies the other's.
"""

import contextlib
import hashlib
import io
import os
import struct

import pytest

from cairo_m_tpu_torch import cli
from torch_port_helpers import (
    PRODUCTION_SCALE,
    REPO_DIR,
    WITNESSES,
    WitnessInputChecks,
    WitnessProofChecks,
    assert_same_data,
    both_at_scale,
    witness_program,
)

SRC_FILE = os.path.join(REPO_DIR, WITNESSES["sha256_main"]["source_file"])
MESSAGES = {
    "main": b"abc",
    # word j of block i is i*16 + j, big-endian (tests/test_sha256_example.py)
    "bench1k": b"".join(struct.pack(">I", i * 16 + j) for i in range(16) for j in range(16)),
}
ENTRIES = sorted(MESSAGES)


def digest_words(data: bytes):
    d = hashlib.sha256(data).digest()
    return [int.from_bytes(d[i * 4: i * 4 + 4], "big") for i in range(8)]


def native_return_words(pi):
    """The eight u32 return values of a native prover input, read from its
    output cells (two 16-bit limbs each, low first)."""
    slots = [pi.final_memory[a][0][0] for a in pi.public_address_ranges.output]
    assert len(slots) == 16
    return [slots[2 * i] | slots[2 * i + 1] << 16 for i in range(8)]


@pytest.fixture(scope="module")
def program():
    return witness_program("cairo_m_tpu_torch", "sha256_main")


@pytest.fixture(scope="module")
def production():
    with both_at_scale(PRODUCTION_SCALE):
        yield


@pytest.fixture(scope="module")
def native_inputs(program, production):
    """entry point -> the port's native prover input at production scale."""
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input

    return {ep: native_prover_input(program, ep, []) for ep in ENTRIES}


@pytest.fixture(scope="module")
def python_runs(program, production):
    """entry point -> the port's Python VM run."""
    from cairo_m_tpu_torch.vm.runner import run_cairo_program

    return {ep: run_cairo_program(program, ep, []) for ep in ENTRIES}


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """The program compiled by the port's command line: its JSON file."""
    out = tmp_path_factory.mktemp("sha256") / "sha256.json"
    assert _cli(["compile", SRC_FILE, "-o", str(out)])[0] == 0
    return str(out)


def _cli(argv):
    """(exit code, standard output) of the port's command line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("ep", ENTRIES)
def test_python_vm_matches_hashlib(python_runs, ep):
    res = python_runs[ep]
    assert res.return_values[0].flatten() == digest_words(MESSAGES[ep])
    if ep == "bench1k":  # the bitwise-heavy long trace of the bench workload
        assert len(res.vm.segments[0].trace) > 100_000


@pytest.mark.parametrize("ep", ENTRIES)
def test_native_core_matches_hashlib(native_inputs, ep):
    pi = native_inputs[ep]
    assert native_return_words(pi) == digest_words(MESSAGES[ep])
    if ep == "bench1k":
        assert pi.total_steps > 100_000


@pytest.mark.parametrize("ep", ENTRIES)
def test_cli_run_matches_hashlib(compiled, ep):
    rc, out = _cli(["run", compiled, "--entrypoint", ep])
    assert rc == 0
    assert out.strip().splitlines() == [str(digest_words(MESSAGES[ep]))]


@pytest.mark.parametrize("ep", ENTRIES)
def test_native_input_equals_reference_native_input(native_inputs, production, ep):
    """The two packages' native VM cores and adapters (each compiling the
    file with its own compiler) give the same prover input."""
    from cairo_m_tpu.prover.adapter.native_import import native_prover_input

    ref = native_prover_input(witness_program("cairo_m_tpu", "sha256_main"), ep, [])
    assert_same_data(ref, native_inputs[ep])


@pytest.mark.parametrize("ep", ENTRIES)
def test_cli_route_equals_native_route(compiled, native_inputs, production, ep):
    """``prove``'s route (the compiled file, the Python VM, the adapter)
    gives the prover input of the native route."""
    from cairo_m_tpu_torch.prover.adapter.adapter import import_from_runner_output
    from cairo_m_tpu_torch.vm.runner import RunnerOptions, run_cairo_program

    res = run_cairo_program(cli._load_program(compiled), ep, [],
                            RunnerOptions(max_steps=(1 << 20) - 1))
    (seg,) = res.vm.segments
    assert_same_data(import_from_runner_output(seg, res.public_address_ranges),
                     native_inputs[ep])


class TestSha256Main(WitnessInputChecks):
    name = "sha256_main"


class TestSha256Bench1k(WitnessInputChecks):
    name = "sha256_bench1k"

    @pytest.mark.slow
    def test_constraints_hold_in_both_packages(self, ref_input, port_input):
        """~60 s in each package on one core: beyond the Tier-1 budget of
        this file, so the slow tier runs it."""
        super().test_constraints_hold_in_both_packages(ref_input, port_input)


class TestSha256MainProof(WitnessProofChecks):
    name = "sha256_main"
    pytestmark = pytest.mark.slow


class TestSha256Bench1kProof(WitnessProofChecks):
    name = "sha256_bench1k"
    pytestmark = pytest.mark.slow
