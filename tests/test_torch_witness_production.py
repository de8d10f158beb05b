"""cairo_m_tpu_torch vs the JAX reference at production scale (clock range
check 2^20, bitwise table 2^18, REGULAR_96_BITS) on the witnesses that need
the bitwise table (tests/golden/witnesses.json): ``allops`` (the reference's
all-opcodes program) and ``u32_bitwise`` (its u32 program: every
u32_store_{and,or,xor} opcode, the u32 immediates).  A proof with a bitwise
opcode is unsound below bitwise_log=18, so these have no test-scale proof.

Tier-1 holds them at constraint level (equal traces, constraints and LogUp
balance in both packages, the native input equal to the reference's); the
slow tier proves them with the port on the CPU against the committed
production digests, and with the reference.  ``allops``'s proofs fail the
OODS check in both packages (its `<=` runs store_le_fp_imm, whose
constraints exceed the composition's degree): the slow tier holds both
verifiers to rejecting them, and a test-scale program with `<=` shows the
fault in Tier-1.  The coverage test: every one of the 45 components is
live in at least one witness."""

import os

import pytest

from cairo_m_tpu_torch.prover.components.registry import ComponentSet
from cairo_m_tpu_torch.prover.relations import Relations
from torch_port_helpers import (
    WITNESSES,
    WitnessInputChecks,
    WitnessProofChecks,
    both_at_test_scale,
    configs,
    cross_reject,
    golden_file,
)


class TestAllops(WitnessInputChecks):
    name = "allops"


class TestU32Bitwise(WitnessInputChecks):
    name = "u32_bitwise"


class TestAllopsProof(WitnessProofChecks):
    name = "allops"
    pytestmark = pytest.mark.slow


class TestU32BitwiseProof(WitnessProofChecks):
    name = "u32_bitwise"
    pytestmark = pytest.mark.slow


# the two `<=` of the allops program: store_le_fp_imm alone
LE_SRC = """
fn main(x: felt) -> felt {
    let le1 = x <= 100;
    let le2 = x <= 2000000000;
    return le1 + le2 * 2;
}
"""


def test_le_proofs_fail_the_oods_check_in_both_packages():
    """store_le_fp_imm's degree-4 constraints (test_torch_plans.py
    DEGREE_4): at test scale too, the port's proof of allops's two `<=`
    holds every constraint row by row, and yet both packages' verifiers
    reject it at the OODS check, as they reject allops's proofs (the
    second `<=` keeps other arcs than the padding rows do)."""
    from cairo_m_tpu_torch.compiler import compile_cairo
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.debug_tools import assert_constraints
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m

    with both_at_test_scale():
        pi = native_prover_input(compile_cairo(LE_SRC).program, "main", [500])
        comps = ComponentSet(Relations())
        comps.write_traces(pi)
        assert "store_le_fp_imm" in [c.name for c in comps.all if not c.zero_witness]
        assert assert_constraints(pi, raise_on_failure=False) == []
        proof = prove_cairo_m(pi, configs()[1], device="cpu")
        cross_reject([proof], configs())


# components that no witness makes live, each with its reason; every
# opcode the compiler cannot emit has a witness assembled from the ISA
EXPECTED_MISSING = {}


def test_every_component_is_live_in_a_witness():
    names = [c.name for c in ComponentSet(Relations()).all]
    live = {n for w in WITNESSES.values() for n in w["live"]}
    assert len(names) == 45
    assert [n for n in names if n not in live] == sorted(EXPECTED_MISSING)
    assert live <= set(names)


def test_every_witness_has_its_golden():
    files = [golden_file(n) for n in WITNESSES] + [golden_file("u32_stress", "stwo")]
    assert all(os.path.exists(f) for f in files), files
    assert {w["scale"] for w in WITNESSES.values()} == {"test", "production"}
