"""Shared inputs for the differential tests of cairo_m_tpu_torch against the
JAX reference package (tests/test_torch_*.py).

Inputs are made with numpy from a seed (or by the reference's own VM and
adapter) and handed to both packages; outputs are compared bit for bit —
the arithmetic is exact, so the tolerance is zero.
"""

from __future__ import annotations

import contextlib
import hashlib
import importlib
import json
import os
import sys

import numpy as np
import pytest
import torch

P = (1 << 31) - 1

# The tests run in several pytest-xdist workers beside JAX's compiler
# threads; a full intra-op pool per worker oversubscribes the cores and
# slows the port's many small ops by an order of magnitude, while one
# thread costs a test-scale proof little.
torch.set_num_threads(1)

FIB_SRC = """
fn main(n: felt) -> felt {
    let a = 0; let b = 1; let i = 0;
    while i != n { let t = a + b; a = b; b = t; i = i + 1; }
    return a;
}
"""


def to_t(a) -> torch.Tensor:
    """uint32 NumPy array -> int64 CPU tensor (the port's carrier)."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def to_np(t) -> np.ndarray:
    return np.asarray(t).astype(np.uint32) if not isinstance(t, torch.Tensor) \
        else t.cpu().numpy().astype(np.uint32)


TEST_SCALE = (10, 8)  # (rc_big_bits, bitwise_log) of set_test_scale
PRODUCTION_SCALE = (20, 18)


@contextlib.contextmanager
def both_at_scale(scale):
    """Set the preprocessed tables of BOTH packages (each has its own
    ProtocolScale) to ``scale`` = (rc_big_bits, bitwise_log); restore the
    scales they had afterwards, so the context nests."""
    from cairo_m_tpu.prover import config as rcfg
    from cairo_m_tpu_torch.prover import config as tcfg

    saved = [(cfg, cfg.SCALE.key()) for cfg in (rcfg, tcfg)]
    for cfg, _ in saved:
        cfg.SCALE.rc_big_bits, cfg.SCALE.bitwise_log = scale
    try:
        yield
    finally:
        for cfg, (rc_big_bits, bitwise_log) in saved:
            cfg.SCALE.rc_big_bits = rc_big_bits
            cfg.SCALE.bitwise_log = bitwise_log


def both_at_test_scale():
    """Shrink the preprocessed tables of both packages (set_test_scale(10,
    8)) for the duration of the context."""
    return both_at_scale(TEST_SCALE)


def configs(framing="native"):
    """(reference, port) test configs: 8 queries, 2 PoW bits."""
    from cairo_m_tpu.prover import config as rcfg
    from cairo_m_tpu_torch.prover import config as tcfg

    return (
        rcfg.test_config(n_queries=8, pow_bits=2, framing=framing),
        tcfg.test_config(n_queries=8, pow_bits=2, framing=framing),
    )


def make_static_input(import_from_runner_output, n_cells=5):
    """The static-memory segment of tests/test_prover_static.py, through the
    given package's adapter (built from that package's own ISA classes)."""
    package = import_from_runner_output.__module__.split(".")[0]
    PublicAddressRanges = importlib.import_module(
        f"{package}.isa.program").PublicAddressRanges
    state = importlib.import_module(f"{package}.isa.state")
    Segment, State = state.Segment, state.State

    mem = {
        i: ((i + 1, 2 * i, 3 * i, (7 * i) % 11), 0, 0) for i in range(n_cells)
    }
    seg = Segment(initial_memory=mem, memory_trace=[], trace=[State(0, 0)])
    return import_from_runner_output(seg, PublicAddressRanges.new(0, 0, 0))


def reference_fib_input(n: int):
    """Reference ProverInput of fib-n via the Python VM + adapter."""
    from cairo_m_tpu.compiler import compile_cairo
    from cairo_m_tpu.isa.abi_codec import InputValue
    from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output
    from cairo_m_tpu.vm.runner import run_cairo_program

    out = compile_cairo(FIB_SRC)
    res = run_cairo_program(out.program, "main", [InputValue.number(n)])
    return import_from_runner_output(res.vm.segments[0], res.public_address_ranges)


def proof_json(proof) -> str:
    return json.dumps(proof.to_json_obj(), sort_keys=True)


def proof_sha256(proof) -> str:
    return hashlib.sha256(proof_json(proof).encode()).hexdigest()


# a module of the port run as ``python -m`` in a fresh interpreter where
# neither JAX nor the JAX package can be imported; it fails if either was
# loaded all the same
_NO_JAX_MODULE = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path.insert(0, {repo!r})
sys.argv = [{module!r}, *{argv!r}]
try:
    runpy.run_module({module!r}, run_name="__main__")
finally:
    loaded = [m for m, v in sys.modules.items()
              if v is not None and m.split(".")[0] in ("jax", "cairo_m_tpu")]
    assert not loaded, loaded
"""


def no_jax_command(module: str, argv=()) -> list:
    """The command that runs ``python -m module *argv`` without JAX."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return [sys.executable, "-c",
            _NO_JAX_MODULE.format(repo=repo, module=module, argv=list(argv))]


def reference_fib40_proof(framing="native"):
    """The reference's fib-40 proof at test scale, test_config(8, 2): the
    proof whose digest tests/golden/fib40_proof_sha256.json (native) or
    tests/golden/fib40_stwo_proof_sha256.json (stwo) records."""
    from cairo_m_tpu.prover.prove import prove_cairo_m

    with both_at_test_scale():
        return prove_cairo_m(reference_fib_input(40), configs(framing)[0])


# fib-40 (330 cycles) cut into continuation segments of at most 100 steps
SEGMENT_MAX_STEPS = 100


def reference_fib40_segment_digests():
    """Digests of the reference's per-segment proofs of fib-40 cut at
    SEGMENT_MAX_STEPS (native VM continuation), at test scale with
    test_config(8, 2): what tests/golden/fib40_segments_sha256.json
    records."""
    from cairo_m_tpu.compiler import compile_cairo
    from cairo_m_tpu.prover.adapter.native_import import (
        native_segment_prover_inputs,
    )
    from cairo_m_tpu.prover.prove import prove_cairo_m

    program = compile_cairo(FIB_SRC).program
    with both_at_test_scale():
        return [
            proof_sha256(prove_cairo_m(pi, configs()[0]))
            for pi in native_segment_prover_inputs(
                program, "main", [40], SEGMENT_MAX_STEPS
            )
        ]


def cross_verify(rproof, tproof, cfgs=None):
    """Each package's verifier accepts the other's proof, after a round
    trip through JSON; ``cfgs`` = (reference, port) configs, by default
    `configs()` (call at test scale)."""
    from cairo_m_tpu.prover.prove import Proof as RProof
    from cairo_m_tpu.prover.verify import verify_cairo_m as r_verify
    from cairo_m_tpu_torch.prover.prove import Proof
    from cairo_m_tpu_torch.prover.verify import verify_cairo_m

    rcfg, tcfg = cfgs or configs()
    assert r_verify(RProof.from_json_obj(json.loads(proof_json(tproof))), rcfg)
    assert verify_cairo_m(
        Proof.from_json_obj(json.loads(proof_json(rproof))), tcfg, device="cpu"
    )


def run_kernel_stream(prog, lanes, rows, consts):
    """NumPy model of ``csrc/wtape.cu``'s shared-memory kernel: runs the
    encoded instruction stream of a `wtape.KernelProgram` over (B, n) bank
    rows, block by block of ``lanes`` lanes, with the kernel's addressing
    (one flag bit per question, register operands as byte offsets
    premultiplied by ``lanes``, constant operands replaced by their values) and M31 arithmetic.
    -> (n_out, n) uint32."""
    instrs, bank_off = prog.encode(lanes)
    rows = np.asarray(rows, np.uint64)
    consts = np.asarray(consts, np.uint64)
    B, n = rows.shape
    blocks = -(-n // lanes)
    padded = np.zeros((B, blocks * lanes), np.uint64)
    padded[:, :n] = rows
    file = np.zeros((blocks, prog.n_regs * lanes), np.uint64)
    j = np.arange(lanes)

    def reg(off):  # byte offset of a register -> the block's lanes' words
        assert off % (4 * lanes) == 0
        return off // 4 + j

    for b in range(B):
        if bank_off[b] >= 0:
            file[:, reg(bank_off[b])] = padded[b].reshape(blocks, lanes)
    out = np.zeros((prog.n_out, blocks * lanes), np.uint64)
    n_instrs = len(prog.op)
    # zero padding to whole chunks plus the two chunks the kernel fetches ahead
    assert len(instrs) % 32 == 0 and len(instrs) >= n_instrs + 64
    assert not instrs[n_instrs:].any()
    assert n_instrs % prog.width == 0
    A_CONST, B_NO_LOAD, OUT, MUL, SUB = 1, 2, 4, 8, 16
    for base in range(0, n_instrs, prog.width):
        # one bundle: every operand is read before any result is written
        bundle = instrs[base : base + prog.width].tolist()
        vals = []
        for x, y, z, w in bundle:
            a = consts[y] if x & A_CONST else file[:, reg(y)]
            if x & OUT:
                b = None
            else:
                b = consts[z] if x & B_NO_LOAD else file[:, reg(z)]
            vals.append((a, b))
        for (x, y, z, w), (a, b) in zip(bundle, vals):
            if x & OUT:
                out[z] = a.reshape(-1)
            elif x & MUL:
                file[:, reg(w)] = (a * b) % P
            elif x & SUB:
                file[:, reg(w)] = (a + P - b) % P
            else:
                file[:, reg(w)] = (a + b) % P
    return out[:, :n].astype(np.uint32)


def random_wide_plan(seed: int, n_bank: int = 12, n_ops: int = 300, n_out: int = 6):
    """(plan, run-time constant vector) of a random M31 expression DAG over
    ``n_bank`` bank rows, static and run-time constants: ``n_ops`` random
    add / sub / mul instructions over earlier values, ``n_out`` outputs
    (one of them twice, and one a bare bank row, which the scheduler
    materialises as a copy)."""
    from cairo_m_tpu_torch.prover.stark import wtape

    rng = np.random.default_rng(seed)
    rec = wtape.WideRecorder()
    ops = wtape.WideOps(rec)
    pool = [rec.bank_src("t", i, 0) for i in range(n_bank)]
    pool += [rec.const(int(v)) for v in rng.integers(2, P, size=4)]
    pool += [rec.dyn_const(("k", i)) for i in range(3)]
    emit = (ops.badd, ops.bsub, ops.bmul)
    values = []
    for _ in range(n_ops):
        a, b = (pool[i] for i in rng.integers(0, len(pool), size=2))
        v = emit[int(rng.integers(0, 3))](a, b)
        pool.append(v)
        values.append(v)
    outs = [values[i] for i in rng.integers(len(values) // 2, len(values), size=n_out - 2)]
    outs += [outs[0], pool[0]]
    plan = wtape.schedule_wide(rec, outs)
    consts = plan.const_values(
        {("k", i): int(v) for i, v in enumerate(rng.integers(0, P, size=3))})
    return plan, consts


def constant_free_plan():
    """(plan, constants): two products of bank rows and their difference.
    No instruction reads a constant (the vector holds only the schedule's
    NOP operand), and the steps depend on each other, so every bundle of
    the kernel's program is short."""
    from cairo_m_tpu_torch.prover.stark import wtape

    rec = wtape.WideRecorder()
    ops = wtape.WideOps(rec)
    a, b, c = (rec.bank_src("t", i, 0) for i in range(3))
    ab = ops.bmul(a, b)
    plan = wtape.schedule_wide(rec, [ops.bsub(ab, ops.bmul(b, c)), ab])
    return plan, plan.const_values({})


def wide_sum_plan(n_bank: int):
    """(plan, constants) that reads every one of ``n_bank`` bank rows: their
    sum, and the sum times a run-time constant.  Every bank row holds a
    register in the kernel's program, so a large ``n_bank`` is a register
    file that shared memory cannot hold."""
    from cairo_m_tpu_torch.prover.stark import wtape

    rec = wtape.WideRecorder()
    ops = wtape.WideOps(rec)
    terms = [ops.embed(rec.bank_src("t", i, 0)) for i in range(n_bank)]
    total = ops.etree_sum(terms)[0]
    plan = wtape.schedule_wide(rec, [total, ops.bmul(total, rec.dyn_const("k"))])
    return plan, plan.const_values({"k": 123456789})


# ---------------------------------------------------------------------------
# Witnesses: programs whose runs make every AIR component live.  Their
# sources, arguments and scales are plain data in tests/golden/witnesses.json
# (the JAX package's own test programs, copied, and one program assembled
# from the ISA's instructions), which chip_smoke.py reads too.
# ---------------------------------------------------------------------------

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")

with open(os.path.join(GOLDEN_DIR, "witnesses.json")) as _f:
    WITNESSES = json.load(_f)

SCALES = {"test": TEST_SCALE, "production": PRODUCTION_SCALE}


def witness_scale(name):
    """Context: both packages at the witness's protocol scale."""
    return both_at_scale(SCALES[WITNESSES[name]["scale"]])


REPO_DIR = os.path.dirname(os.path.dirname(GOLDEN_DIR))


def witness_entrypoint(name) -> str:
    """The entry point the witness runs: ``entrypoint``, else ``main``."""
    return WITNESSES[name].get("entrypoint", "main")


def witness_program(package: str, name: str):
    """The witness's Program, compiled by (or loaded with) ``package``'s own
    compiler and ISA classes: an assembled ``program``, a ``source_file``
    of the repository, or the inline ``source``."""
    w = WITNESSES[name]
    if "program" in w:
        Program = importlib.import_module(f"{package}.isa.program").Program
        return Program.from_json(json.dumps(w["program"]))
    compile_cairo = importlib.import_module(f"{package}.compiler").compile_cairo
    if "source_file" in w:
        with open(os.path.join(REPO_DIR, w["source_file"])) as f:
            return compile_cairo(f.read(), w["source_file"]).program
    return compile_cairo("\n".join(w["source"]) + "\n").program


def witness_config(package: str, name: str, framing="native"):
    """test_config(8, 2) at test scale; REGULAR_96_BITS at production."""
    cfg = importlib.import_module(f"{package}.prover.config")
    if WITNESSES[name]["scale"] == "production":
        assert framing == "native"
        return cfg.REGULAR_96_BITS
    return cfg.test_config(n_queries=8, pow_bits=2, framing=framing)


def reference_witness_input(name):
    """Reference ProverInput of the witness via the Python VM + adapter
    (call at the witness's scale: the clock range check reads it)."""
    from cairo_m_tpu.isa.abi_codec import InputValue
    from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output
    from cairo_m_tpu.vm.runner import run_cairo_program

    res = run_cairo_program(witness_program("cairo_m_tpu", name), witness_entrypoint(name),
                            [InputValue.number(a) for a in WITNESSES[name]["args"]])
    return import_from_runner_output(res.vm.segments[0], res.public_address_ranges)


def port_native_witness_input(name):
    """The port's own ProverInput of the witness: its compiler, native VM
    core and adapter."""
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input

    program = witness_program("cairo_m_tpu_torch", name)
    entrypoint = witness_entrypoint(name)
    return native_prover_input(program, entrypoint,
                               call_slots(program, WITNESSES[name]["args"], entrypoint))


def call_slots(program, args, entrypoint="main"):
    """Scalar arguments of ``entrypoint`` in the call-slot encoding the
    native VM takes: a felt is one slot, a u32 two 16-bit limbs (low
    first)."""
    out = []
    for p, a in zip(program.get_entrypoint(entrypoint).params, args, strict=True):
        out += [a & 0xFFFF, a >> 16] if p.ty.kind == "u32" else [a]
    return out


def golden_file(name, framing="native"):
    kind = "production" if WITNESSES[name]["scale"] == "production" else "proof"
    stwo = "_stwo" if framing == "stwo" else ""
    return os.path.join(GOLDEN_DIR, f"{name}{stwo}_{kind}_sha256.json")


def golden_digest(name, framing="native"):
    with open(golden_file(name, framing)) as f:
        return json.load(f)["sha256"]


def reference_witness_proof(name, framing="native"):
    """The reference's proof of the witness (Python VM + adapter) at its
    scale and config: the proof whose digest golden_file(name, framing)
    records."""
    from cairo_m_tpu.prover.prove import prove_cairo_m

    with witness_scale(name):
        return prove_cairo_m(reference_witness_input(name),
                             witness_config("cairo_m_tpu", name, framing))


def cross_reject(proofs, cfgs, reason="composition polynomial mismatch at OODS"):
    """Each package's verifier rejects each package's proof with a message
    that holds ``reason``: by default at the OODS check (the proofs of a
    component whose constraints exceed the composition's degree:
    tests/test_torch_plans.py DEGREE_4)."""
    import re

    from cairo_m_tpu.prover.prove import Proof as RProof
    from cairo_m_tpu.prover.verify import VerificationError as RError
    from cairo_m_tpu.prover.verify import verify_cairo_m as r_verify
    from cairo_m_tpu_torch.prover.prove import Proof
    from cairo_m_tpu_torch.prover.verify import VerificationError, verify_cairo_m

    rcfg, tcfg = cfgs
    for proof in proofs:
        obj = json.loads(proof_json(proof))
        with pytest.raises(RError, match=re.escape(reason)):
            r_verify(RProof.from_json_obj(obj), rcfg)
        with pytest.raises(VerificationError, match=re.escape(reason)):
            verify_cairo_m(Proof.from_json_obj(obj), tcfg, device="cpu")


def assert_same_data(a, b, path="input"):
    """Two values built by the two packages (dataclasses, dicts, sequences,
    NumPy arrays, ints) hold the same data, field by field."""
    import dataclasses

    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            assert_same_data(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same_data(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, path
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same_data(x, y, f"{path}[{i}]")
    else:
        assert a == b, path


class WitnessFixtures:
    """Class-scoped inputs of the witness ``name`` (set by the subclass),
    built with both packages at the witness's scale."""

    name = None
    framing = "native"

    @pytest.fixture(scope="class", autouse=True)
    def _scale(self):
        with witness_scale(self.name):
            yield

    @pytest.fixture(scope="class")
    def ref_input(self, _scale):
        return reference_witness_input(self.name)

    @pytest.fixture(scope="class")
    def port_input(self, ref_input):
        """The reference's input carried over as plain data."""
        from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input

        return from_reference_prover_input(ref_input)

    @pytest.fixture(scope="class")
    def native_input(self, _scale):
        return port_native_witness_input(self.name)

    def cfgs(self):
        return tuple(witness_config(pkg, self.name, self.framing)
                     for pkg in ("cairo_m_tpu", "cairo_m_tpu_torch"))


def assert_traces_identical(ref_input, port_input):
    """Every component's trace columns, bit for bit, and its size, each
    package writing the traces of its own input (call at the inputs'
    scale)."""
    from cairo_m_tpu.prover.components.registry import ComponentSet as RComponentSet
    from cairo_m_tpu.prover.relations import Relations as RRelations
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet
    from cairo_m_tpu_torch.prover.relations import Relations

    rcomps, tcomps = RComponentSet(RRelations()), ComponentSet(Relations())
    rcomps.write_traces(ref_input)
    tcomps.write_traces(port_input)
    for r, t in zip(rcomps.all, tcomps.all, strict=True):
        assert (t.name, t.log_size, t.zero_witness) == (r.name, r.log_size, r.zero_witness)
        assert len(t.trace_rows) == len(r.trace_rows), t.name
        for k, (x, y) in enumerate(zip(r.trace_rows, t.trace_rows)):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f"{t.name} column {k}")


class WitnessInputChecks(WitnessFixtures):
    """The witness's prover input, constraint level (no commitment)."""

    def test_traces_identical(self, ref_input, port_input):
        """Every component's trace columns, bit for bit, and its size."""
        assert_traces_identical(ref_input, port_input)

    def test_live_components(self, port_input):
        """The witness keeps busy exactly the components that
        tests/golden/witnesses.json names for it."""
        from cairo_m_tpu_torch.prover.components.registry import ComponentSet
        from cairo_m_tpu_torch.prover.relations import Relations

        comps = ComponentSet(Relations())
        comps.write_traces(port_input)
        live = [c.name for c in comps.all if not c.zero_witness]
        assert live == WITNESSES[self.name]["live"]

    def test_constraints_hold_in_both_packages(self, ref_input, port_input):
        from cairo_m_tpu.prover import debug_tools as rdebug
        from cairo_m_tpu_torch.prover import debug_tools

        assert rdebug.assert_constraints(ref_input, raise_on_failure=False) == []
        assert debug_tools.assert_constraints(port_input, raise_on_failure=False) == []
        assert rdebug.relation_tracker(ref_input) == {}
        assert debug_tools.relation_tracker(port_input) == {}

    def test_native_input_equals_reference_input(self, port_input, native_input):
        """The port's compiler + native VM core + adapter give the input the
        reference's Python VM + adapter gave, field by field."""
        assert_same_data(port_input, native_input)


class WitnessProofChecks(WitnessFixtures):
    """The port's proof of the witness (its own compiler, native VM and
    adapter) on the CPU, held to the reference."""

    @pytest.fixture(scope="class")
    def port_proof(self, native_input):
        from cairo_m_tpu_torch.prover.prove import prove_cairo_m

        return prove_cairo_m(native_input, self.cfgs()[1], device="cpu")

    def test_port_proof_matches_golden(self, port_proof):
        assert proof_sha256(port_proof) == golden_digest(self.name, self.framing)

    @pytest.mark.slow
    def test_reference_proof_byte_equal_and_cross_verified(self, port_proof):
        """The live reference proof is the golden, byte-equal to the port's,
        and each package verifies the other's; where witnesses.json records
        a fault of both packages ("verifies": false), each package rejects
        both proofs instead."""
        rproof = reference_witness_proof(self.name, self.framing)
        assert proof_sha256(rproof) == golden_digest(self.name, self.framing)
        assert proof_json(port_proof) == proof_json(rproof)
        if WITNESSES[self.name].get("verifies", True):
            cross_verify(rproof, port_proof, self.cfgs())
        else:
            cross_reject((rproof, port_proof), self.cfgs())


class WitnessChecks(WitnessInputChecks, WitnessProofChecks):
    pass


# ---------------------------------------------------------------------------
# The user paths held to the JAX package at production scale: a WASM-compiled
# program, the stwo framing and the continuation chain's resumed segments.
# Each golden file records its input as plain data (a WASM module as hex) and
# the command that regenerates it: reference_golden_record(name).
# ---------------------------------------------------------------------------

# fibonacci(10,000) = 80,010 cycles under STWO_FRAMING_96_BITS
STWO_FIB_ITERS = 10_000
# fibonacci(600,000) = 4,800,010 cycles cut at the production cap into five
# segments; the reference proves the first, the second and the last (indices
# as in the segment workers' records)
CHAIN_FIB_ITERS = 600_000
CHAIN_CAP = (1 << 20) - 1
CHAIN_PROVED = (0, 1, 4)

WASM_GOLDENS = ("wasm_memrw_proof", "wasm_memrw_production", "wasm_sumsq_production")


def load_golden(name) -> dict:
    """tests/golden/<name>_sha256.json"""
    with open(os.path.join(GOLDEN_DIR, f"{name}_sha256.json")) as f:
        return json.load(f)


def wasm_program(package: str, name: str):
    """The Program ``package``'s own WASM frontend compiles from the module
    bytes the golden ``name`` records."""
    compile_wasm = importlib.import_module(f"{package}.wasm").compile_wasm
    return compile_wasm(bytes.fromhex(load_golden(name)["module_hex"])).program


def wasm_scale(name):
    """Context: both packages at the WASM golden's protocol scale."""
    return both_at_scale(SCALES[load_golden(name)["scale"]])


def wasm_config(package: str, name: str):
    """test_config(8, 2) at test scale; REGULAR_96_BITS at production."""
    cfg = importlib.import_module(f"{package}.prover.config")
    if load_golden(name)["scale"] == "production":
        return cfg.REGULAR_96_BITS
    return cfg.test_config(n_queries=8, pow_bits=2)


def wasm_input(package: str, name: str):
    """``package``'s ProverInput of the WASM golden: its compiler, native VM
    and adapter, the arguments in the call-slot encoding (call at the
    golden's scale)."""
    g = load_golden(name)
    nimp = importlib.import_module(f"{package}.prover.adapter.native_import")
    return nimp.native_prover_input(wasm_program(package, name), g["entrypoint"], g["args"])


def bench_fib_program(package: str):
    """bench.py's fibonacci source compiled by ``package``."""
    from cairo_m_tpu_torch.bench import FIB_SRC as BENCH_FIB_SRC

    return importlib.import_module(f"{package}.compiler").compile_cairo(BENCH_FIB_SRC).program


def chain_inputs(package: str):
    """Generator of ``package``'s ProverInputs of the five segments of
    fibonacci(CHAIN_FIB_ITERS) cut at CHAIN_CAP."""
    nimp = importlib.import_module(f"{package}.prover.adapter.native_import")
    return nimp.native_segment_prover_inputs(
        bench_fib_program(package), "main", [CHAIN_FIB_ITERS], CHAIN_CAP)


def _reference_verdict(proof, cfg):
    """(accepted, seconds, reason) of the JAX package's verifier."""
    import time

    from cairo_m_tpu.prover.verify import VerificationError, verify_cairo_m

    t = time.time()
    try:
        ok, reason = bool(verify_cairo_m(proof, cfg)), None
    except VerificationError as e:
        ok, reason = False, str(e)
    return ok, round(time.time() - t, 2), reason


def _host_peak_gib():
    import resource

    return round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20, 2)


def reference_golden_record(name) -> dict:
    """Prove the golden ``name``'s input with the JAX package on the CPU and
    verify it with the JAX package: -> the digest(s), cycles, seconds, the
    verifier's verdict and the process's host peak, what the golden file
    records (``wasm_*``, ``fib10k_stwo_production``,
    ``fib600k_segments_production``)."""
    import time

    from cairo_m_tpu.prover import config as rcfg
    from cairo_m_tpu.prover.prove import prove_cairo_m

    def one(pi, cfg):
        t = time.time()
        proof = prove_cairo_m(pi, cfg)
        prove_s = round(time.time() - t, 2)
        ok, verify_s, reason = _reference_verdict(proof, cfg)
        rec = {"sha256": proof_sha256(proof), "cycles": pi.total_steps,
               "prove_s": prove_s, "verifies": ok, "verify_s": verify_s}
        if reason:
            rec["rejected_with"] = reason
        return rec

    if name in WASM_GOLDENS:
        with wasm_scale(name):
            rec = one(wasm_input("cairo_m_tpu", name), wasm_config("cairo_m_tpu", name))
    elif name == "fib10k_stwo_production":
        from cairo_m_tpu.prover.adapter.native_import import native_prover_input

        pi = native_prover_input(bench_fib_program("cairo_m_tpu"), "main", [STWO_FIB_ITERS])
        rec = one(pi, rcfg.STWO_FRAMING_96_BITS)
    elif name == "fib600k_segments_production":
        segments = []
        for k, pi in enumerate(chain_inputs("cairo_m_tpu")):
            seg = {"segment": k, "n_steps": pi.total_steps,
                   "initial_root": pi.merkle_trees.initial_root,
                   "final_root": pi.merkle_trees.final_root}
            if k in CHAIN_PROVED:
                seg.update(one(pi, rcfg.REGULAR_96_BITS))
                seg.pop("cycles")
            segments.append(seg)
        rec = {"segments": segments}
    else:
        raise KeyError(name)
    rec["host_peak_gib"] = _host_peak_gib()
    return rec
