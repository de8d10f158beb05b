"""A WASM-compiled program proved by cairo_m_tpu_torch, held to the JAX
reference: the port's counterpart of tests/test_wasm.py's
``test_memory_module_proves``.

The modules are the JAX package's test modules, committed as hex in their
golden files (tests/golden/wasm_*_sha256.json, each made by the JAX package
on the CPU): ``memrw`` (a linear-memory store and load,
tests/test_wasm.py:199-208, with the input of :283-289) and ``sumsq`` (the
sum-of-squares memory loop of :246-263 over one full 64 KiB page).

Tier-1 (test scale for the proofs):

- the committed bytes equal tests/test_wasm.py's builders;
- both packages' WASM frontends compile each module to the same program;
- the port's native prover input equals the JAX package's, component by
  component and column by column (``memrw`` at test scale, ``sumsq`` at
  production scale: 557,060 steps);
- the port's proof of ``memrw`` on the CPU hashes to
  ``wasm_memrw_proof_sha256.json``, and each package's verifier gives the
  recorded verdict on it;
- the command line's ``wasm -> prove --device cpu --verify -> verify``
  chain runs in an interpreter that can import neither JAX nor the JAX
  package, and its proof is the golden's;
- ``sumsq``'s square of a local reads one cell twice at one clock, whose
  clock-difference lookup lies outside its table in both packages alike:
  the fault behind both verifiers' rejection of its production proof.

The slow tier proves the production goldens with the port on the CPU: both
WASM modules at ``REGULAR_96_BITS``, fibonacci(10,000) under
``STWO_FRAMING_96_BITS`` and the last (resumed) segment of the
fibonacci(600,000) chain.
"""

import json
import os
import subprocess
import sys

import pytest

import test_wasm
from torch_port_helpers import (
    CHAIN_PROVED,
    STWO_FIB_ITERS,
    WASM_GOLDENS,
    assert_same_data,
    assert_traces_identical,
    chain_inputs,
    cross_reject,
    cross_verify,
    load_golden,
    proof_sha256,
    bench_fib_program,
    wasm_config,
    wasm_input,
    wasm_program,
    wasm_scale,
)

MODULES = {"memrw": "wasm_memrw_proof", "sumsq": "wasm_sumsq_production"}


def sumsq_module():
    """The module of tests/test_wasm.py's test_memory_sum_loop (:246-263):
    write i*i to mem[4i] for i in 0..n, then sum the words back.  A verbatim
    copy of that test's body, which it builds inline rather than through a
    builder; `test_committed_sumsq_runs_as_test_memory_sum_loop` ties the
    committed bytes to that test's behaviour."""
    LG0, LG1, LG2, LS1, LS2 = (test_wasm.LG0, test_wasm.LG1, test_wasm.LG2,
                               test_wasm.LS1, test_wasm.LS2)
    i32c, memarg = test_wasm.i32c, test_wasm._memarg
    load, store = test_wasm.I32_LOAD, test_wasm.I32_STORE
    body = (
        i32c(0) + LS1
        + b"\x03\x40"
        + LG1 + i32c(4) + b"\x6c" + LG1 + LG1 + b"\x6c" + store + memarg()
        + LG1 + i32c(1) + b"\x6a" + LS1
        + LG1 + LG0 + b"\x49" + b"\x0d\x00"
        + b"\x0b"
        + i32c(0) + LS2 + i32c(0) + LS1
        + b"\x03\x40"
        + LG2 + LG1 + i32c(4) + b"\x6c" + load + memarg() + b"\x6a" + LS2
        + LG1 + i32c(1) + b"\x6a" + LS1
        + LG1 + LG0 + b"\x49" + b"\x0d\x00"
        + b"\x0b"
        + LG2
    )
    return test_wasm.module([(1, 1)], [0], {"sumsq": 0}, [(2, body)], mem_pages=1)


BUILDERS = {"memrw": test_wasm._mem_rw_module, "sumsq": sumsq_module}


@pytest.mark.parametrize("name", WASM_GOLDENS)
def test_committed_module_equals_test_wasm_builder(name):
    g = load_golden(name)
    assert bytes.fromhex(g["module_hex"]) == BUILDERS[g["entrypoint"]]()


def test_committed_sumsq_runs_as_test_memory_sum_loop():
    """The committed sumsq bytes through the JAX package's frontend and VM
    (``test_wasm.run``) at n = 20, as test_memory_sum_loop runs its module."""
    w = bytes.fromhex(load_golden("wasm_sumsq_production")["module_hex"])
    n = 20
    assert test_wasm.run(w, "sumsq", [n]) == sum(i * i for i in range(n)) & 0xFFFFFFFF


def test_sumsq_runs_one_full_page():
    """n = 16,384 words fill the module's one 64 KiB page, and the run fits
    one segment under the production cap."""
    g = load_golden("wasm_sumsq_production")
    assert g["args"] == [16384, 0] and 4 * g["args"][0] == 1 << 16
    assert g["cycles"] < (1 << 20) - 1


@pytest.mark.parametrize("module", sorted(MODULES))
def test_both_frontends_compile_the_same_program(module):
    ref = wasm_program("cairo_m_tpu", MODULES[module])
    port = wasm_program("cairo_m_tpu_torch", MODULES[module])
    assert port.to_json() == ref.to_json()
    assert list(port.entrypoints) == [module]


@pytest.fixture(scope="module")
def memrw_inputs():
    """(reference, port) native prover inputs of memrw at test scale."""
    with wasm_scale("wasm_memrw_proof"):
        yield (wasm_input("cairo_m_tpu", "wasm_memrw_proof"),
               wasm_input("cairo_m_tpu_torch", "wasm_memrw_proof"))


def test_memrw_native_input_equals_reference(memrw_inputs):
    ref, port = memrw_inputs
    assert_same_data(ref, port)
    assert port.total_steps == load_golden("wasm_memrw_proof")["cycles"]


def test_memrw_traces_equal_reference(memrw_inputs):
    """Every component's trace columns, bit for bit."""
    with wasm_scale("wasm_memrw_proof"):
        assert_traces_identical(*memrw_inputs)


def test_sumsq_native_input_equals_reference():
    """557,060 steps at production scale: the linear-memory loop and its
    i32 wraparound through both packages' lowering, VM and adapter."""
    with wasm_scale("wasm_sumsq_production"):
        ref = wasm_input("cairo_m_tpu", "wasm_sumsq_production")
        port = wasm_input("cairo_m_tpu_torch", "wasm_sumsq_production")
    assert_same_data(ref, port)
    assert port.total_steps == load_golden("wasm_sumsq_production")["cycles"]
    # the return value: the sum of i*i over the page, wrapped to 32 bits
    n = load_golden("wasm_sumsq_production")["args"][0]
    lo, hi = (port.final_memory[a][0][0] for a in port.public_address_ranges.output)
    assert lo | hi << 16 == sum(i * i for i in range(n)) & 0xFFFFFFFF


def _out_of_table_lookups(package, pi):
    """(component, entry index) of every range-check lookup with a non-zero
    multiplicity whose value lies outside its table, in ``package``."""
    import importlib

    import numpy as np

    reg = importlib.import_module(f"{package}.prover.components.registry")
    rels = importlib.import_module(f"{package}.prover.relations").Relations()
    framework = importlib.import_module(f"{package}.prover.stark.framework")
    scale = importlib.import_module(f"{package}.prover.config").SCALE
    comps = reg.ComponentSet(rels)
    with pytest.raises(IndexError):  # the debug route's histogram of the tables
        comps.write_traces(pi)
    bits = {id(rels.range_check_8): 8, id(rels.range_check_16): 16,
            id(rels.range_check_20): scale.rc_big_bits}
    out = []
    for comp in comps.all:
        if comp.zero_witness or comp.name.startswith(("range_check", "bitwise")):
            continue
        pp = comp.preprocessed_columns() if comp.n_preprocessed_cols else ()
        for k, e in enumerate(framework._entries_host(comp, comp.trace_rows, pp)):
            if id(e.relation) not in bits:
                continue
            n = 1 << comp.log_size
            mult = np.broadcast_to(e.multiplicity.as_ext().v[0], (n,))
            vals = np.broadcast_to(e.values[0].v, (n,)).astype(np.int64)
            bad = (mult != 0) & (vals >= 1 << bits[id(e.relation)])
            if bad.any():
                out.append((comp.name, k, sorted(set(vals[bad].tolist()))))
    return out


def test_same_cell_operands_fault_is_shared():
    """sumsq squares a local (``i * i``: both operands of
    u32_store_mul_fp_fp read one cell at one clock), so the second read's
    clock difference range-checks -1 (P - 1), outside the table: in both
    packages alike.  The provers' table counts drop that lookup, as the
    reference's scatter does, so LogUp does not balance and both verifiers
    reject the production proof (the golden's ``rejected_with``).  A
    repair belongs to both packages at once."""
    with wasm_scale("wasm_memrw_proof"):
        ref_prog = wasm_program("cairo_m_tpu", "wasm_sumsq_production")
        port_prog = wasm_program("cairo_m_tpu_torch", "wasm_sumsq_production")
        from cairo_m_tpu.prover.adapter.native_import import native_prover_input as r_input
        from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input

        ref = _out_of_table_lookups("cairo_m_tpu", r_input(ref_prog, "sumsq", [20, 0]))
        port = _out_of_table_lookups("cairo_m_tpu_torch",
                                     native_prover_input(port_prog, "sumsq", [20, 0]))
    P = (1 << 31) - 1
    assert port == ref == [("u32_store_mul_fp_fp", 13, [P - 1]),
                           ("u32_store_mul_fp_fp", 16, [P - 1])]
    assert not load_golden("wasm_sumsq_production")["verifies"]


@pytest.fixture(scope="module")
def memrw_proof(memrw_inputs):
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m

    with wasm_scale("wasm_memrw_proof"):
        return prove_cairo_m(memrw_inputs[1], wasm_config("cairo_m_tpu_torch",
                                                          "wasm_memrw_proof"),
                             device="cpu")


def test_memrw_proof_matches_golden(memrw_proof):
    assert proof_sha256(memrw_proof) == load_golden("wasm_memrw_proof")["sha256"]


def _hold_to_verdict(name, proof):
    """Each package's verifier gives the golden's recorded verdict on the
    port's proof (its bytes are the reference's: the digests are equal):
    it accepts, or it rejects with the reference's message."""
    g = load_golden(name)
    cfgs = tuple(wasm_config(pkg, name) for pkg in ("cairo_m_tpu", "cairo_m_tpu_torch"))
    with wasm_scale(name):
        if g["verifies"]:
            cross_verify(proof, proof, cfgs)
        else:
            cross_reject((proof,), cfgs, g["rejected_with"])


def test_memrw_proof_cross_verified(memrw_proof):
    _hold_to_verdict("wasm_memrw_proof", memrw_proof)


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
    ["wasm", d + "/memrw.wasm", "-o", d + "/memrw.json"],
    ["prove", d + "/memrw.json", "--entrypoint", "memrw", "--arguments", "3", "999",
     "--device", "cpu", "--verify", "-o", d + "/proof.json"],
    ["verify", d + "/proof.json", "--device", "cpu"],
):
    rc = cli.main(argv)
    assert rc == 0, (argv, rc)
assert not any(m.split(".")[0] in ("jax", "cairo_m_tpu") for m, v in sys.modules.items() if v)
"""


def test_cli_chain_runs_without_jax(tmp_path):
    """wasm -> prove --verify -> verify in an interpreter that can import
    neither JAX nor the JAX package; the proof file's one segment is the
    golden's proof (the command line's Python VM + adapter route gives the
    native route's input)."""
    g = load_golden("wasm_memrw_proof")
    (tmp_path / "memrw.wasm").write_bytes(bytes.fromhex(g["module_hex"]))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _CHAIN_SCRIPT.format(repo=repo, tmp=str(tmp_path))],
        capture_output=True, text=True, cwd=repo, timeout=600,
        env={**os.environ, "OMP_NUM_THREADS": "1"},
    )
    assert res.returncode == 0, res.stderr
    lines = res.stdout.strip().splitlines()
    assert "segment 0: verified=True" in lines
    assert "return: 999" in lines
    assert lines[-2:] == ["segment 0: OK", "proof verified"]
    with open(tmp_path / "proof.json") as f:
        (segment,) = json.load(f)["segments"]
    import hashlib

    digest = hashlib.sha256(json.dumps(segment, sort_keys=True).encode()).hexdigest()
    assert digest == g["sha256"]


# ---------------------------------------------------------------------------
# Slow tier: the production goldens proved by the port on the CPU
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("name", ["wasm_memrw_production", "wasm_sumsq_production"])
def test_wasm_production_proof_matches_golden(name):
    """sumsq's proof holds poseidon2's 443 columns at 2^19 rows (2^20 in
    the composition) as int64 tensors: on the CPU it needs more host memory
    than 62 GiB (the JAX package's proof peaked at 27.3 GiB); the card
    proves it in 30.2 GiB of device memory (chip_smoke.py phase 14)."""
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m

    with wasm_scale(name):
        proof = prove_cairo_m(wasm_input("cairo_m_tpu_torch", name),
                              wasm_config("cairo_m_tpu_torch", name), device="cpu")
    assert proof_sha256(proof) == load_golden(name)["sha256"]
    _hold_to_verdict(name, proof)


@pytest.mark.slow
def test_stwo_production_proof_matches_golden():
    from cairo_m_tpu_torch.prover import config
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m
    from cairo_m_tpu_torch.prover.verify import verify_cairo_m

    g = load_golden("fib10k_stwo_production")
    pi = native_prover_input(bench_fib_program("cairo_m_tpu_torch"), "main", [STWO_FIB_ITERS])
    assert pi.total_steps == g["cycles"]
    proof = prove_cairo_m(pi, config.STWO_FRAMING_96_BITS, device="cpu")
    assert proof_sha256(proof) == g["sha256"]
    assert verify_cairo_m(proof, config.STWO_FRAMING_96_BITS, device="cpu") == g["verifies"]


@pytest.mark.slow
def test_chain_last_segment_matches_golden():
    """The port's native VM runs the five segments, their steps and roots
    those the reference recorded; its proof of the last, resumed segment
    is the reference's."""
    from cairo_m_tpu_torch.prover import config
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m

    want = load_golden("fib600k_segments_production")["segments"]
    got = []
    for k, pi in enumerate(chain_inputs("cairo_m_tpu_torch")):
        got.append({"segment": k, "n_steps": pi.total_steps,
                    "initial_root": pi.merkle_trees.initial_root,
                    "final_root": pi.merkle_trees.final_root})
        if k == len(want) - 1:
            assert k == CHAIN_PROVED[-1]
            proof = prove_cairo_m(pi, config.REGULAR_96_BITS, device="cpu")
            assert proof_sha256(proof) == want[k]["sha256"]
    assert got == [{key: s[key] for key in got[0]} for s in want]
