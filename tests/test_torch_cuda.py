"""The port's CUDA kernels against their plain torch versions on the card,
bit for bit, and a test-scale proof on the card against the same proof on
the CPU.  Every test needs a CUDA device (marker ``cuda``) and skips
without one.  The file imports no JAX, so it also runs on a machine that
has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from cairo_m_tpu.compiler import compile_cairo
from cairo_m_tpu_torch import kernels
from cairo_m_tpu_torch.hash import blake2s
from cairo_m_tpu_torch.prover import config
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.components.registry import ComponentSet
from cairo_m_tpu_torch.prover.prove import prove_cairo_m
from cairo_m_tpu_torch.prover.relations import Relations
from cairo_m_tpu_torch.prover.stark import framework, wtape
from cairo_m_tpu_torch.prover.stark.air import logup_shift_scalar
from torch_port_helpers import FIB_SRC, P, proof_json

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fib40(cuda_device):
    """(test-scale prover input, relations, components) of fibonacci(40),
    with relation parameters from a fixed stand-in channel."""

    class _Channel:
        i = 0

        def draw_felt(self):
            self.i += 1
            return (self.i * 12345 % P, self.i, 7, 11)

    config.set_test_scale(10, 8)
    try:
        pi = native_prover_input(compile_cairo(FIB_SRC).program, "main", [40])
        relations = Relations()
        comps = ComponentSet(relations)
        comps.write_traces(pi)
        relations.draw(_Channel())
        yield pi, relations, comps
    finally:
        config.set_production_scale()


@pytest.mark.parametrize(
    "K,n", [(1, 32), (4, 1 << 12), (16, 1 << 16), (17, 1 << 10), (512, 1 << 8)]
)
def test_blake2s_kernel_matches_plain(cuda_device, K, n):
    rng = np.random.default_rng(K)
    cols = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(K, n), dtype=np.int64)
    ).to(cuda_device)
    before = kernels.launches["blake2s_leaves"]
    got = blake2s.hash_leaves(cols)
    assert kernels.launches["blake2s_leaves"] == before + 1
    want = torch.stack(blake2s.hash_words(list(cols)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["interaction", "composition"])
@pytest.mark.parametrize("name", ["store_add_fp_fp", "poseidon2", "range_check_8"])
def test_wtape_kernel_matches_plain(fib40, cuda_device, kind, name):
    _, relations, comps = fib40
    comp = next(c for c in comps.all if c.name == name)
    if kind == "interaction":
        plan, _ = framework.interaction_plan(comp, relations)
        elog = comp.log_size
        consts = plan.const_values(framework._DynResolver(relations))
    else:
        plan = framework.composition_plan(comp, relations)
        elog = comp.log_size + 1
        apows = [(1, 0, 0, 0)] + [(3 + i, 1, 4, 1) for i in range(600)]
        consts = plan.const_values(framework._DynResolver(
            relations, shift=logup_shift_scalar((1, 2, 3, 4), comp.log_size),
            apows=apows))
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(
        rng.integers(0, P, size=(len(plan.used_bank), 1 << elog), dtype=np.int64)
    ).to(cuda_device)
    before = kernels.launches["wtape_run_plan"]
    got = wtape.run_plan(rows, consts, plan)
    assert kernels.launches["wtape_run_plan"] > before
    want = wtape.run_plan(rows.cpu(), consts, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("framing", ["native", "stwo"])
def test_cuda_proof_equals_cpu_proof(fib40, framing):
    pi, _, _ = fib40
    cfg = config.test_config(n_queries=8, pow_bits=2, framing=framing)
    kernels.reset_launches()
    cuda_proof = prove_cairo_m(pi, cfg, device="cuda")
    # the stwo trees are hashed on the host: only the wide-tape kernel runs
    used = kernels.launches if framing == "native" else {
        "wtape_run_plan": kernels.launches["wtape_run_plan"]}
    assert all(n > 0 for n in used.values()), kernels.launches
    assert proof_json(cuda_proof) == proof_json(prove_cairo_m(pi, cfg, device="cpu"))
