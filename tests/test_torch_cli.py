"""The prove/verify command line of cairo_m_tpu_torch, in process on the CPU
at test scale: ``cli.config_for`` is swapped for test_config(n_queries=8,
pow_bits=2) of the file's framing and the tables are shrunk
(set_test_scale(10, 8)).

fibonacci(40) (330 cycles) with ``--max-steps 200`` runs as two
continuation segments, proved under both framings:

- the proof file has the reference's format and every segment verifies;
- the two segments' roots chain, ``verify`` accepts the file and rejects it
  with the segments swapped or a claimed sum tampered;
- ``--device`` is required, and ``cuda`` without a card is an error;
- ``--from-trace`` on the trace files of ``run --trace-output`` gives the
  same proofs as running the VM.
"""

import contextlib
import io
import json

import pytest
import torch

from cairo_m_tpu_torch import cli
from cairo_m_tpu_torch.prover import config
from cairo_m_tpu_torch.prover.prove import Proof
from torch_port_helpers import FIB_SRC, P, both_at_test_scale

PROVE_ARGS = ["--arguments", "40", "--max-steps", "200", "--device", "cpu"]


def _run(argv):
    """(exit code, standard output) of the command line."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def test_scale_cli():
    with both_at_test_scale(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(cli, "config_for", lambda framing: config.test_config(
            n_queries=8, pow_bits=2, framing=framing))
        yield


@pytest.fixture(scope="module")
def program(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    (d / "fib.cm").write_text(FIB_SRC)
    rc, _ = _run(["compile", str(d / "fib.cm"), "-o", str(d / "fib.json")])
    assert rc == 0
    return str(d / "fib.json")


def _prove(program, framing, tmp_path_factory):
    """(framing, proof file, prove's standard output)."""
    path = tmp_path_factory.mktemp("proof") / "proof.json"
    rc, text = _run(["prove", program, *PROVE_ARGS, "--verify",
                     "--framing", framing, "-o", str(path)])
    assert rc == 0
    return framing, path, text


@pytest.fixture(scope="module")
def native_proved(program, test_scale_cli, tmp_path_factory):
    return _prove(program, "native", tmp_path_factory)


@pytest.fixture(scope="module")
def stwo_proved(program, test_scale_cli, tmp_path_factory):
    return _prove(program, "stwo", tmp_path_factory)


@pytest.fixture(params=["native", "stwo"])
def proved(request):
    return request.getfixturevalue(f"{request.param}_proved")


def _segments(path):
    with open(path) as f:
        return json.load(f)


def test_prove_writes_reference_format(proved):
    framing, path, text = proved
    obj = _segments(path)
    assert set(obj) == {"segments", "framing"}
    assert obj["framing"] == framing
    assert len(obj["segments"]) == 2
    for seg in obj["segments"]:
        Proof.from_json_obj(seg)
    assert "segment 0: verified=True" in text
    assert "segment 1: verified=True" in text
    assert "return: 102334155" in text  # fibonacci(40)


def test_segment_roots_chain(proved):
    _, path, _ = proved
    first, second = (Proof.from_json_obj(s) for s in _segments(path)["segments"])
    assert first.public_data.final_root == second.public_data.initial_root
    assert first.public_data.initial_root != second.public_data.initial_root


def test_verify_accepts(proved):
    _, path, _ = proved
    rc, text = _run(["verify", str(path), "--device", "cpu"])
    assert rc == 0
    assert text.splitlines() == ["segment 0: OK", "segment 1: OK", "proof verified"]


def _swap(obj):
    obj["segments"].reverse()


def _claimed_sum(obj):
    c = obj["segments"][0]["claimed_sums"][-1]
    c[0] = (c[0] + 1) % P


@pytest.mark.parametrize("tamper, message", [
    (_swap, "segment 1: continuation root mismatch"),
    (_claimed_sum, "segment 0: INVALID"),
], ids=["swapped_segments", "claimed_sum"])
def test_verify_rejects(proved, tmp_path, tamper, message):
    _, path, _ = proved
    obj = _segments(path)
    tamper(obj)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(obj))
    rc, text = _run(["verify", str(bad), "--device", "cpu"])
    assert rc == 1
    assert message in text


@pytest.mark.parametrize("argv", [
    ["prove", "program.json"],
    ["verify", "proof.json"],
], ids=["prove", "verify"])
def test_device_is_required(argv):
    with pytest.raises(SystemExit) as e:
        _run(argv)
    assert e.value.code == 2


def test_cuda_without_a_card_is_an_error(program, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        _run(["prove", program, *PROVE_ARGS[:-1], "cuda"])


def test_from_trace_proves_the_same_segments(native_proved, program, tmp_path):
    _, path, _ = native_proved
    trace = tmp_path / "trace.bin"
    rc, _ = _run(["run", program, "--arguments", "40", "--max-steps", "200",
                  "--trace-output", str(trace)])
    assert rc == 0
    out = tmp_path / "from_trace.json"
    rc, _ = _run(["prove", program, "--from-trace", str(trace), "--device", "cpu",
                  "-o", str(out)])
    assert rc == 0
    assert _segments(out) == _segments(path)
