"""The whole prover of cairo_m_tpu_torch vs the JAX reference on
fibonacci(40), at test scale (set_test_scale(10, 8),
test_config(n_queries=8, pow_bits=2)).

- both packages give byte-identical proof JSON for the same input, and
  each package's verifier accepts the other's proof;
- the reference proof's digest is the committed golden
  (tests/golden/fib40_proof_sha256.json, which chip_smoke.py checks on the
  card), so the golden cannot go stale;
- the port's own path (native VM + native adapter) proves to that digest.
"""

import json
import os

import pytest

from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.prove import prove_cairo_m
from torch_port_helpers import (
    FIB_SRC,
    both_at_test_scale,
    configs,
    cross_verify,
    proof_json,
    proof_sha256,
    reference_fib40_proof,
    reference_fib_input,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "fib40_proof_sha256.json")

_, TCFG = configs()


@pytest.fixture(scope="module", autouse=True)
def _test_scale():
    with both_at_test_scale():
        yield


@pytest.fixture(scope="module")
def proofs():
    """(reference proof, port proof on the CPU) of the same fib-40 input."""
    rproof = reference_fib40_proof()
    pi = from_reference_prover_input(reference_fib_input(40))
    return rproof, prove_cairo_m(pi, TCFG, device="cpu")


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)["sha256"]


def test_proof_json_identical(proofs):
    rproof, tproof = proofs
    assert proof_json(tproof) == proof_json(rproof)


def test_each_verifier_accepts_the_other_proof(proofs):
    cross_verify(*proofs)


def test_golden_digest_is_the_reference_proof(proofs):
    rproof, _ = proofs
    assert proof_sha256(rproof) == _golden()


def test_native_input_proves_to_golden_digest():
    program = compile_cairo(FIB_SRC).program
    proof = prove_cairo_m(native_prover_input(program, "main", [40]), TCFG,
                          device="cpu")
    assert proof_sha256(proof) == _golden()
