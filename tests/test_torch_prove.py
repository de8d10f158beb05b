"""The whole prover of cairo_m_tpu_torch vs the JAX reference on the
static-memory segment of tests/test_prover_static.py, at test scale
(set_test_scale(10, 8), test_config(n_queries=8, pow_bits=2)).

- both packages give byte-identical proof JSON, and each package's verifier
  accepts the other's proof;
- the port rejects a tampered claimed sum and tampered public data;
- with ``jax`` and ``cairo_m_tpu`` made unimportable, a fresh interpreter
  imports the port and proves the segment to the reference's digest (a
  subprocess, because this process imported JAX in conftest.py).

fibonacci(40) is tests/test_torch_prove_fib.py: the two reference proofs
cost minutes of jit each, and separate files let pytest-xdist run them on
separate workers.
"""

import json
import os
import subprocess
import sys

import pytest

from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output as r_import
from cairo_m_tpu.prover.prove import prove_cairo_m as r_prove
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from cairo_m_tpu_torch.prover.prove import Proof, prove_cairo_m
from cairo_m_tpu_torch.prover.verify import VerificationError, verify_cairo_m
from torch_port_helpers import (
    P,
    both_at_test_scale,
    configs,
    cross_verify,
    make_static_input,
    proof_json,
    proof_sha256,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)

RCFG, TCFG = configs()


@pytest.fixture(scope="module", autouse=True)
def _test_scale():
    with both_at_test_scale():
        yield


@pytest.fixture(scope="module")
def proofs():
    """(reference proof, port proof on the CPU) of the static segment."""
    pi = make_static_input(r_import)
    rproof = r_prove(pi, RCFG)
    tproof = prove_cairo_m(from_reference_prover_input(pi), TCFG, device="cpu")
    return rproof, tproof


def test_proof_json_identical(proofs):
    rproof, tproof = proofs
    assert proof_json(tproof) == proof_json(rproof)


def test_each_verifier_accepts_the_other_proof(proofs):
    cross_verify(*proofs)


def _claimed_sum(proof):
    c = list(proof.claimed_sums[-1])
    c[0] = (c[0] + 1) % P
    proof.claimed_sums[-1] = tuple(c)


def _public_data(proof):
    proof.public_data.initial_root ^= 1


@pytest.mark.parametrize("tamper", [_claimed_sum, _public_data],
                         ids=["claimed_sum", "public_data"])
def test_port_rejects_tampered_proof(proofs, tamper):
    _, tproof = proofs
    bad = Proof.from_json_obj(json.loads(proof_json(tproof)))
    tamper(bad)
    with pytest.raises(VerificationError):
        verify_cairo_m(bad, TCFG, device="cpu")


_NO_JAX_SCRIPT = """
import sys
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path[:0] = [{repo!r}, {tests!r}]
import torch_port_helpers as h
from cairo_m_tpu_torch.prover import config
from cairo_m_tpu_torch.prover.adapter.adapter import import_from_runner_output
from cairo_m_tpu_torch.prover.prove import prove_cairo_m
config.set_test_scale(10, 8)
pi = h.make_static_input(import_from_runner_output)
proof = prove_cairo_m(pi, config.test_config(n_queries=8, pow_bits=2), device="cpu")
assert not any(m.split(".")[0] in ("jax", "cairo_m_tpu") for m, v in sys.modules.items() if v)
print(h.proof_sha256(proof))
"""


def test_port_proves_without_jax(proofs):
    rproof, _ = proofs
    script = _NO_JAX_SCRIPT.format(repo=REPO, tests=TESTS)
    res = subprocess.run(
        [sys.executable, "-c", script], capture_output=True, text=True,
        cwd=REPO, timeout=600,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == proof_sha256(rproof)

