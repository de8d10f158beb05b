"""`Proof.program_id` in cairo_m_tpu_torch vs the JAX reference, as
tests/test_prover_e2e.py holds the reference's (test_program_id,
test_external_poseidon2_constants), at test scale: the port proves, and the
reference's id is computed from the port's proof JSON, never from an object
of the port."""

import json

import pytest

from cairo_m_tpu.hash import poseidon2_params as rparams
from cairo_m_tpu.prover.prove import Proof as RProof
from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.hash import poseidon2_params as tparams
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.prove import Proof, prove_cairo_m
from cairo_m_tpu_torch.prover.verify import verify_cairo_m
from torch_port_helpers import FIB_SRC, both_at_test_scale, configs, proof_json

_, TCFG = configs()

SQ_SRC = """
fn main(n: felt) -> felt {
    let a = 0; let i = 0;
    while i != n { a = a + n; i = i + 1; }
    return a;
}
"""
ALT_SEED = "external/zkhash-stand-in/v1"


@pytest.fixture(scope="module", autouse=True)
def _test_scale():
    with both_at_test_scale():
        yield


def _prove(src, arg):
    program = compile_cairo(src).program
    proof = prove_cairo_m(native_prover_input(program, "main", [arg]), TCFG, device="cpu")
    assert verify_cairo_m(proof, TCFG, device="cpu")
    return proof


def _reference_id(proof):
    """The reference's program id of the port's proof, from its JSON."""
    return RProof.from_json_obj(json.loads(proof_json(proof))).program_id()


@pytest.fixture(scope="module")
def proofs():
    return {name: _prove(src, arg)
            for name, src, arg in (("fib5", FIB_SRC, 5), ("fib9", FIB_SRC, 9),
                                   ("sq", SQ_SRC, 6))}


def test_same_program_same_id(proofs):
    assert proofs["fib5"].program_id() == proofs["fib9"].program_id()


def test_other_program_other_id(proofs):
    assert proofs["fib5"].program_id() != proofs["sq"].program_id()


def test_id_survives_json_round_trip(proofs):
    rt = Proof.from_json_obj(json.loads(proof_json(proofs["fib5"])))
    assert rt.program_id() == proofs["fib5"].program_id()


@pytest.mark.parametrize("name", ["fib5", "fib9", "sq"])
def test_id_equals_reference(proofs, name):
    tid = proofs[name].program_id()
    assert type(tid) is int
    assert tid == _reference_id(proofs[name])


def test_id_under_swapped_poseidon2_params(proofs):
    """Another Poseidon2 instance, installed in both packages: the port's
    proof still verifies, its id and roots change, and both packages give
    the same id."""
    base = proofs["fib5"]
    with tparams.use_params(tparams.Poseidon2Params.generate(ALT_SEED)), \
            rparams.use_params(rparams.Poseidon2Params.generate(ALT_SEED)):
        swapped = _prove(FIB_SRC, 5)
        tid = swapped.program_id()
        assert tid == _reference_id(swapped)
        # the id of the base proof follows the installed instance too
        assert base.program_id() == _reference_id(base) == tid
    assert tid != proofs["fib5"].program_id()
    assert swapped.public_data.initial_root != base.public_data.initial_root
