"""The span recorder of cairo_m_tpu_torch (`prover/observe.py`), on the CPU
at the tests' scale (set_test_scale(10, 8), test_config(n_queries=8,
pow_bits=2)), fibonacci(40):

- the proof is byte-equal with the recorder on and off;
- with no recorder active nothing is stored;
- spans nest: every child lies inside its parent, and every span of a
  proof shares the ``prove`` root's id;
- ``timing``'s phases are their spans' durations;
- the PCS steps tile the ``pcs`` phase;
- two identical warm proofs count the same ``pulls``, more than 0;
- after the plan and preprocessed caches are cleared, the first proof
  records ``plan_record`` and ``preprocessed`` spans, the next none;
- ``vm`` and ``adapter`` come from `native_prover_input`, as roots.
"""

import json
import os

import pytest

from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.prover import config as tcfg
from cairo_m_tpu_torch.prover import observe
from cairo_m_tpu_torch.prover import prove as prove_mod
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.stark import framework
from torch_port_helpers import FIB_SRC, GOLDEN_DIR, both_at_test_scale, proof_sha256

PCS_STEPS = ("oods", "sample", "alphas", "quotients", "fri", "pow_grind", "decommit")


def _recorded_proof(program, cfg, timing=None):
    with observe.record() as rec:
        pi = native_prover_input(program, "main", [40])
        proof = prove_mod.prove_cairo_m(pi, cfg, timing, device="cpu")
        spans, counts = rec.drain()
    return proof, spans, counts


@pytest.fixture(scope="module")
def runs():
    """A cold proof (plan and preprocessed caches cleared), two warm ones,
    all recorded, and one with no recorder."""
    cfg = tcfg.test_config(n_queries=8, pow_bits=2)
    with both_at_test_scale():
        program = compile_cairo(FIB_SRC).program
        framework._PLAN_CACHE.clear()
        prove_mod._PRE_PHASE_CACHE.clear()
        cold = _recorded_proof(program, cfg)
        timing = {}
        warm = _recorded_proof(program, cfg, timing)
        warm2 = _recorded_proof(program, cfg)
        assert observe._active is None
        plain = prove_mod.prove_cairo_m(
            native_prover_input(program, "main", [40]), cfg, device="cpu")
    return {"cold": cold, "warm": warm, "warm2": warm2, "plain": plain,
            "timing": timing}


def _by_id(spans):
    return {s.id: s for s in spans}


def _prove_root(spans):
    (root,) = [s for s in spans if s.name == "prove"]
    return root


def test_proof_bytes_equal_with_the_recorder_on_and_off(runs):
    with open(os.path.join(GOLDEN_DIR, "fib40_proof_sha256.json")) as f:
        want = json.load(f)["sha256"]
    assert proof_sha256(runs["plain"]) == want
    for key in ("cold", "warm", "warm2"):
        assert proof_sha256(runs[key][0]) == want


def test_nothing_is_stored_without_a_recorder(runs):
    assert observe._active is None
    assert observe.span("a", x=1) is observe.span("b")
    with observe.span("a"):
        observe.count("pulls")
    with observe.record() as rec:
        assert rec.drain() == ([], {})
    # a proof with no recorder keeps its phases to itself
    assert observe._phases is None


@pytest.mark.parametrize("key", ["cold", "warm"])
def test_spans_nest_under_one_root(runs, key):
    _, spans, _ = runs[key]
    by_id = _by_id(spans)
    root = _prove_root(spans)
    for s in spans:
        assert s.start <= s.end
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start and s.end <= p.end, (s, p)
            assert s.root == p.root
        if s.name in ("vm", "adapter"):
            assert s.parent is None and s.root == s.id
        elif s.start >= root.start:
            assert s.root == root.id, s
    assert [s.name for s in spans if s.parent == root.id] == [
        "trace", "interaction", "composition", "pcs"]


def test_timing_is_the_phase_spans(runs):
    _, spans, _ = runs["warm"]
    timing = runs["timing"]
    root = _prove_root(spans)
    phases = {s.name: s.seconds for s in spans if s.parent == root.id}
    assert set(timing) == {"trace", "interaction", "composition", "pcs", "total"}
    for name, seconds in phases.items():
        assert timing[name] == seconds
    assert timing["total"] == root.seconds


@pytest.mark.parametrize("key", ["cold", "warm"])
def test_pcs_steps_tile_the_phase(runs, key):
    _, spans, _ = runs[key]
    (pcs,) = [s for s in spans if s.name == "pcs"]
    steps = [s for s in spans if s.parent == pcs.id]
    assert [s.name for s in steps] == list(PCS_STEPS)
    covered = sum(s.end - s.start for s in steps)
    assert covered >= 0.99 * (pcs.end - pcs.start)


def test_warm_proofs_count_the_same_pulls(runs):
    (_, spans, counts), (_, _, counts2) = runs["warm"], runs["warm2"]
    assert counts == counts2
    assert counts["pulls"] > 0
    assert counts["pulls"] == sum(1 for s in spans if s.name == "pull")


def test_cold_spans_fire_on_cache_misses_only(runs):
    names = {key: {s.name for s in runs[key][1]} for key in ("cold", "warm", "warm2")}
    assert {"plan_record", "preprocessed"} <= names["cold"]
    for key in ("warm", "warm2"):
        assert not {"plan_record", "preprocessed"} & names[key]
    kinds = {s.attrs["kind"] for s in runs["cold"][1] if s.name == "plan_record"}
    assert kinds == {"interaction", "tcount", "composition"}


def test_dispatch_spans_name_stage_and_component(runs):
    _, spans, _ = runs["warm"]
    dispatch = [s for s in spans if s.name == "dispatch"]
    by_stage = {}
    for s in dispatch:
        by_stage.setdefault(s.attrs["stage"], []).append(s.attrs["component"])
    assert by_stage["interaction"] == by_stage["composition"]
    assert len(by_stage["interaction"]) == 11  # fib(40)'s live components


def test_vm_and_adapter_come_from_native_prover_input(runs):
    _, spans, _ = runs["warm"]
    vm, adapter = [s for s in spans if s.parent is None and s.name != "prove"]
    assert (vm.name, adapter.name) == ("vm", "adapter")
    assert vm.end <= adapter.start <= adapter.end <= _prove_root(spans).start
