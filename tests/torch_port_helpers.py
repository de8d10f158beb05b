"""Shared inputs for the differential tests of cairo_m_tpu_torch against the
JAX reference package (tests/test_torch_*.py).

Inputs are made with numpy from a seed (or by the reference's own VM and
adapter) and handed to both packages; outputs are compared bit for bit —
the arithmetic is exact, so the tolerance is zero.
"""

from __future__ import annotations

import contextlib
import hashlib
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
    given package's adapter."""
    from cairo_m_tpu.isa.program import PublicAddressRanges
    from cairo_m_tpu.isa.state import Segment, State

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
