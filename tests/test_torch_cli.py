"""The prove/verify command line of cairo_m_tpu_torch, in process on the CPU
at test scale: ``cli.config_for`` is swapped for test_config(n_queries=8,
pow_bits=2) of the file's framing and the tables are shrunk
(set_test_scale(10, 8)).

fibonacci(40) (330 cycles) with ``--max-steps 200`` runs as two
continuation segments, proved under both framings:

- the proof file has the reference's format and every segment verifies;
- the two segments' roots chain, ``verify`` accepts the file and rejects it
  with the segments swapped or a claimed sum tampered;
- ``--device`` defaults to the card, and ``cuda`` without a card is an error
  (given or by default), never a quiet move to the CPU;
- ``--from-trace`` on the trace files of ``run --trace-output`` gives the
  same proofs as running the VM;
- ``compile``, ``run``, ``fmt``, ``init``, ``build`` and ``wasm`` are the
  port's own and print and write what the JAX package's command line does;
- in a fresh interpreter that can import neither ``jax`` nor
  ``cairo_m_tpu``, compile -> run -> prove -> verify go through.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

import test_wasm
from cairo_m_tpu import cli as reference_cli
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
def test_device_is_required(argv, monkeypatch):
    """The device defaults to the card: with none there the command stops
    at once (before it opens its file) and does not move to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cuda: .*no CUDA device"):
        _run(argv)


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


def _run_both(argv_of, tmp_path):
    """Run a command line of both packages, each in a directory of its
    own; -> [(exit code, output with the directory's name taken out, files
    written)] for the reference and the port."""
    results = []
    for name, main in (("reference", reference_cli.main), ("port", cli.main)):
        d = tmp_path / name
        d.mkdir()
        out = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(out):
            rc = main(argv_of(d))
        files = {}
        for root, _, names in os.walk(d):
            for f in names:
                path = os.path.join(root, f)
                with open(path, "rb") as fh:
                    files[os.path.relpath(path, d)] = fh.read()
        results.append((rc, out.getvalue().replace(str(d), "<dir>"), files))
    return results


U32_SRC = "fn main(a: u32, b: u32) -> u32 { return (a * b) ^ (a + b); }\n"
UGLY_SRC = "fn   main( n:felt)->felt{let a=n+1;\nreturn a*2 ;}\n"
BAD_SRC = "fn main() -> felt { return x; }\n"


def _compile(src, *flags):
    def argv(d):
        (d / "p.cm").write_text(src)
        return ["compile", str(d / "p.cm"), "-o", str(d / "p.json"), *flags]
    return argv


def _run_program(d):
    (d / "p.cm").write_text(U32_SRC)
    assert cli.main(["compile", str(d / "p.cm"), "-o", str(d / "p.json")]) == 0
    return ["run", str(d / "p.json"), "--arguments", "77", "123456",
            "--trace-output", str(d / "t.bin")]


def _fmt(*flags):
    def argv(d):
        (d / "ugly.cm").write_text(UGLY_SRC)
        return ["fmt", *flags, str(d / "ugly.cm")]
    return argv


def _init_build(d):
    assert cli.main(["init", str(d / "proj"), "--name", "demo"]) == 0
    return ["build", str(d / "proj"), "-o", str(d / "demo.json")]


def _wasm(d):
    (d / "m.wasm").write_bytes(test_wasm._mem_rw_module())
    return ["wasm", str(d / "m.wasm")]


def _not_wasm(d):
    (d / "m.wasm").write_bytes(b"not wasm at all")
    return ["wasm", str(d / "m.wasm")]


HOST_COMMANDS = {
    "compile": _compile(FIB_SRC),
    "compile_opt_none": _compile(U32_SRC, "--opt", "none"),
    "compile_error": _compile(BAD_SRC),
    "run_with_trace": _run_program,
    "fmt": _fmt(),
    "fmt_check": _fmt("--check"),
    "init": lambda d: ["init", str(d / "proj"), "--name", "demo"],
    "init_build": _init_build,
    "wasm": _wasm,
    "wasm_error": _not_wasm,
}


@pytest.mark.parametrize("name", sorted(HOST_COMMANDS))
def test_host_commands_match_reference(name, tmp_path):
    want, got = _run_both(HOST_COMMANDS[name], tmp_path)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]
    assert want[0] == (1 if name in ("compile_error", "fmt_check", "wasm_error") else 0)


_CHAIN_SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path.insert(0, {repo!r})
from cairo_m_tpu_torch import cli
from cairo_m_tpu_torch.prover import config
config.set_test_scale(10, 8)
cli.config_for = lambda framing: config.test_config(
    n_queries=8, pow_bits=2, framing=framing)
d = {tmp!r}
for argv in (
    ["compile", d + "/fib.cm", "-o", d + "/fib.json"],
    ["run", d + "/fib.json", "--arguments", "40", "--max-steps", "200"],
    ["prove", d + "/fib.json", "--arguments", "40", "--max-steps", "200",
     "--device", "cpu", "-o", d + "/proof.json"],
    ["verify", d + "/proof.json", "--device", "cpu"],
):
    rc = cli.main(argv)
    assert rc == 0, (argv, rc)
assert not any(m.split(".")[0] in ("jax", "cairo_m_tpu") for m, v in sys.modules.items() if v)
"""


def test_cli_chain_runs_without_jax_or_reference(tmp_path, native_proved):
    """compile -> run -> prove -> verify in an interpreter that can import
    neither JAX nor the JAX package; the proof file equals the one proved
    in this process."""
    (tmp_path / "fib.cm").write_text(FIB_SRC)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _CHAIN_SCRIPT.format(repo=repo, tmp=str(tmp_path))],
        capture_output=True, text=True, cwd=repo, timeout=900,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert "102334155" in lines  # run's return value, fibonacci(40)
    assert lines[-3:] == ["segment 0: OK", "segment 1: OK", "proof verified"]
    _, path, _ = native_proved
    assert _segments(tmp_path / "proof.json") == _segments(path)
