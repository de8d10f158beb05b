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

import numpy as np
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


@contextlib.contextmanager
def both_at_test_scale():
    """Shrink the preprocessed tables of BOTH packages (each has its own
    ProtocolScale); restore the scales they had afterwards, so the context
    nests."""
    from cairo_m_tpu.prover import config as rcfg
    from cairo_m_tpu_torch.prover import config as tcfg

    saved = [(cfg, cfg.SCALE.key()) for cfg in (rcfg, tcfg)]
    for cfg, _ in saved:
        cfg.set_test_scale(rc_big_bits=10, bitwise_log=8)
    try:
        yield
    finally:
        for cfg, (rc_big_bits, bitwise_log) in saved:
            cfg.SCALE.rc_big_bits = rc_big_bits
            cfg.SCALE.bitwise_log = bitwise_log


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


def cross_verify(rproof, tproof):
    """Each package's verifier accepts the other's proof, after a round
    trip through JSON (call at test scale)."""
    from cairo_m_tpu.prover.prove import Proof as RProof
    from cairo_m_tpu.prover.verify import verify_cairo_m as r_verify
    from cairo_m_tpu_torch.prover.prove import Proof
    from cairo_m_tpu_torch.prover.verify import verify_cairo_m

    rcfg, tcfg = configs()
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
