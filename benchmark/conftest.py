"""The benchmark's own tests (``python3 -m pytest benchmark``): on the CPU
at the tests' protocol scale; those marked ``cuda`` need a card and skip
without one, deciding in a fixture."""

import copy

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA device (skips without one)")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    return "cuda"


SMALL_SECURITY = {"pow_bits": 2, "log_blowup": 1, "log_last_layer_degree_bound": 0,
                  "n_queries": 8}
SMALL_SCALE = {"rc_big_bits": 10, "bitwise_log": 8}


def small(config: dict) -> dict:
    """A configuration at the tests' protocol scale (small tables, 8
    queries, 2 PoW bits): the production tables would make every proof on
    the CPU take minutes."""
    c = copy.deepcopy(config)
    c["security"] = dict(SMALL_SECURITY)
    c["scale"] = dict(SMALL_SCALE)
    return c


@pytest.fixture(scope="session")
def small_proof():
    """(proof JSON object, the port's Proof) of fib(40) at the tests' scale,
    made by the port on the CPU."""
    from cairo_m_tpu_torch.compiler import compile_cairo
    from cairo_m_tpu_torch.prover import config as pc
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m

    from benchmark.run import ROOT, port_security

    pc.set_test_scale(SMALL_SCALE["rc_big_bits"], SMALL_SCALE["bitwise_log"])
    try:
        prog = compile_cairo((ROOT / "benchmark/programs/fib_loop.cm").read_text()).program
        pi = native_prover_input(prog, "main", [40])
        proof = prove_cairo_m(pi, port_security({"security": SMALL_SECURITY}), {}, device="cpu")
    finally:
        pc.set_production_scale()
    return proof.to_json_obj(), proof
