"""The stwo framing of cairo_m_tpu_torch vs the JAX reference, at test scale
(set_test_scale(10, 8), test_config(n_queries=8, pow_bits=2,
framing="stwo")).

- the mixed-degree Merkle tree: roots and decommitment JSON identical to
  the reference's on seeded random columns; both verifiers accept the
  opening and reject a flipped witness word;
- the static-memory segment: byte-identical proof JSON, each package's
  verifier accepts the other's proof, the native verifier rejects it, and
  tampered proofs are rejected;
- a native proof and a stwo proof in one process do not share the
  preprocessed commitment;
- the port's fib-40 proof hashes to tests/golden/fib40_stwo_proof_sha256.json.
"""

import json
import os

import numpy as np
import pytest

from cairo_m_tpu.compiler import compile_cairo
from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output as r_import
from cairo_m_tpu.prover.prove import Proof as RProof
from cairo_m_tpu.prover.prove import prove_cairo_m as r_prove
from cairo_m_tpu.prover.stark import stwo_merkle as r_stwo
from cairo_m_tpu.prover.verify import verify_cairo_m as r_verify
from cairo_m_tpu_torch.prover import config, prove
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.prove import Proof, prove_cairo_m
from cairo_m_tpu_torch.prover.stark import stwo_merkle
from cairo_m_tpu_torch.prover.verify import VerificationError, verify_cairo_m
from torch_port_helpers import (
    FIB_SRC,
    P,
    both_at_test_scale,
    configs,
    make_static_input,
    proof_json,
    proof_sha256,
    reference_fib40_proof,
)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                      "fib40_stwo_proof_sha256.json")

RCFG, TCFG = configs("stwo")
_, TCFG_NATIVE = configs()


def _golden():
    with open(GOLDEN) as f:
        return json.load(f)["sha256"]


# ---------------------------------------------------------------------------
# mixed-degree Merkle tree
# ---------------------------------------------------------------------------


def _random_columns(seed):
    """Columns of logs 0..6 (1-40 per log, shuffled commit order) and up to
    three random positions to open in each log from 1 to 6, drawn
    independently per log, so the opening needs column witness values as
    well as hash witness digests."""
    rng = np.random.default_rng(seed)
    logs = [l for l in range(7) for _ in range(int(rng.integers(1, 41)))]
    logs = [logs[i] for i in rng.permutation(len(logs))]
    cols = [rng.integers(0, P, size=1 << l, dtype=np.uint32) for l in logs]
    qpl = {l: sorted(set(rng.integers(0, 1 << l, size=3).tolist())) for l in range(1, 7)}
    return logs, cols, qpl


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_root_and_decommitment_match_reference(seed):
    logs, cols, qpl = _random_columns(seed)
    tree = stwo_merkle.StwoMerkleTree(cols)
    rtree = r_stwo.StwoMerkleTree(cols)
    assert tree.root() == rtree.root()
    queried, dec = tree.decommit(qpl)
    rqueried, rdec = rtree.decommit(qpl)
    got = stwo_merkle.StwoPhaseOpening(queried, dec).to_json_obj()
    assert got == r_stwo.StwoPhaseOpening(rqueried, rdec).to_json_obj()
    for verify in (stwo_merkle.verify_decommitment, r_stwo.verify_decommitment):
        assert verify(tree.root(), logs, qpl, queried, dec)


@pytest.mark.parametrize("witness", ["hash_witness", "column_witness"])
def test_both_verifiers_reject_a_flipped_witness_word(witness):
    logs, cols, qpl = _random_columns(3)
    tree = stwo_merkle.StwoMerkleTree(cols)
    queried, dec = tree.decommit(qpl)
    bad = stwo_merkle.StwoDecommitment(list(dec.hash_witness), list(dec.column_witness))
    if witness == "hash_witness":
        h = bytearray(bad.hash_witness[0])
        h[0] ^= 1
        bad.hash_witness[0] = bytes(h)
    else:
        bad.column_witness[0] ^= 1
    rbad = r_stwo.StwoDecommitment(bad.hash_witness, bad.column_witness)
    assert not stwo_merkle.verify_decommitment(tree.root(), logs, qpl, queried, bad)
    assert not r_stwo.verify_decommitment(tree.root(), logs, qpl, queried, rbad)


def test_hash_node_matches_reference():
    children = (bytes(range(32)), bytes(range(32, 64)))
    values = list(range(1, 20))
    assert stwo_merkle.hash_node(children, values) == r_stwo.hash_node(children, values)
    assert stwo_merkle.hash_node(None, values[:16]) == r_stwo.hash_node(None, values[:16])


def test_production_configs_are_96_bits():
    assert config.STWO_FRAMING_96_BITS.framing == "stwo"
    assert config.STWO_FRAMING_96_BITS.security_bits() == 96
    assert config.REGULAR_96_BITS.security_bits() == 96


# ---------------------------------------------------------------------------
# whole proofs
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def _test_scale():
    with both_at_test_scale():
        yield


@pytest.fixture(scope="module")
def proofs():
    """(reference proof, port proof on the CPU) of the static segment."""
    pi = make_static_input(r_import)
    return r_prove(pi, RCFG), prove_cairo_m(
        from_reference_prover_input(pi), TCFG, device="cpu"
    )


def test_proof_json_identical(proofs):
    rproof, tproof = proofs
    assert proof_json(tproof) == proof_json(rproof)
    assert all(len(phase) == 1 for phase in tproof.pcs_proof.phase_roots)


def test_each_verifier_accepts_the_other_proof(proofs):
    rproof, tproof = proofs
    assert r_verify(RProof.from_json_obj(json.loads(proof_json(tproof))), RCFG)
    assert verify_cairo_m(
        Proof.from_json_obj(json.loads(proof_json(rproof))), TCFG, device="cpu"
    )


def test_native_verifier_rejects_stwo_proof(proofs):
    _, tproof = proofs
    with pytest.raises(VerificationError):
        verify_cairo_m(tproof, TCFG_NATIVE, device="cpu")


def _claimed_sum(proof):
    c = list(proof.claimed_sums[-1])
    c[0] = (c[0] + 1) % P
    proof.claimed_sums[-1] = tuple(c)


def _opening(proof):
    q = proof.pcs_proof.decommitments[1].queried
    ci = next(i for i, col in enumerate(q) if col)
    q[ci][0] = (q[ci][0] + 1) % P


@pytest.mark.parametrize("tamper", [_claimed_sum, _opening],
                         ids=["claimed_sum", "opening"])
def test_port_rejects_tampered_proof(proofs, tamper):
    _, tproof = proofs
    bad = Proof.from_json_obj(json.loads(proof_json(tproof)))
    tamper(bad)
    with pytest.raises(VerificationError):
        verify_cairo_m(bad, TCFG, device="cpu")


def test_native_then_stwo_in_one_process(proofs):
    """The preprocessed commitment is cached per framing: a stwo proof made
    after a native one gives the bytes a fresh process gives (the
    reference's), and the verifier, which reads the same cache, accepts."""
    rproof, _ = proofs
    prove._PRE_PHASE_CACHE.clear()
    pi = from_reference_prover_input(make_static_input(r_import))
    prove_cairo_m(pi, TCFG_NATIVE, device="cpu")
    tproof = prove_cairo_m(pi, TCFG, device="cpu")
    assert proof_json(tproof) == proof_json(rproof)
    assert verify_cairo_m(tproof, TCFG, device="cpu")


def test_fib40_proves_to_golden_digest():
    program = compile_cairo(FIB_SRC).program
    proof = prove_cairo_m(native_prover_input(program, "main", [40]), TCFG,
                          device="cpu")
    assert proof_sha256(proof) == _golden()


@pytest.mark.slow
def test_golden_digest_is_the_reference_proof():
    assert proof_sha256(reference_fib40_proof("stwo")) == _golden()
