"""bigmem (`benchmark/programs/bigmem.cm`, a16z/zkvm-benchmarks
programs/bigmem): an array of n u32 filled and read back, so the memory
trees, the ``merkle`` and ``poseidon2`` components and ``clock_update``
carry the proof.  Held to the JAX package at test scale:

- the native core's batched Poseidon2 against `hash2_np`, and the
  adapter's partial Merkle trees and prover input against the JAX
  package's on seeded random memories with public addresses;
- the port's ``poseidon2`` witness on the CPU against the JAX package's
  `write_trace`, column by column;
- ``fill_sum(v, n)`` proved by the port on the CPU (its compiler, native VM
  and adapter) at an n whose writes and reads lie within the clock range
  check's span and at one whose lie beyond it (``clock_update`` rows):
  byte-equal to the JAX package's proof (its Python VM and adapter), each
  package verifying the other's, the output the benchmark's answer, the
  proof accepted by the benchmark's plain reference verifier; the tree
  spans and the hash counter of the recorder.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from benchmark.reference import verify as ref_verify
from benchmark.reference.answers import bigmem as answers
from benchmark.reference.scale import SecurityConfig, protocol_scale
from cairo_m_tpu.compiler import compile_cairo as r_compile_cairo
from cairo_m_tpu.isa import program as r_program
from cairo_m_tpu.isa import state as r_state
from cairo_m_tpu.isa.abi_codec import InputValue
from cairo_m_tpu.prover.adapter import adapter as r_adapter
from cairo_m_tpu.prover.components.generic import (
    Poseidon2Component as RPoseidon2Component)
from cairo_m_tpu.prover.prove import prove_cairo_m as r_prove_cairo_m
from cairo_m_tpu.prover.relations import Relations as RRelations
from cairo_m_tpu.vm.runner import run_cairo_program
from cairo_m_tpu_torch import native
from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.hash import poseidon2_params as tparams
from cairo_m_tpu_torch.hash.poseidon2 import hash2_np
from cairo_m_tpu_torch.isa import program as t_program
from cairo_m_tpu_torch.isa import state as t_state
from cairo_m_tpu_torch.prover import observe
from cairo_m_tpu_torch.prover.adapter import adapter as t_adapter
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.components.generic import (
    Poseidon2Component, poseidon2_witness)
from cairo_m_tpu_torch.prover.prove import prove_cairo_m
from cairo_m_tpu_torch.prover.relations import Relations
from cairo_m_tpu_torch.prover.stark import pcs, quotients, wtape
from torch_port_helpers import (
    REPO_DIR, TEST_SCALE, P, assert_same_data, both_at_test_scale, configs,
    cross_verify, proof_json)

with open(f"{REPO_DIR}/benchmark/programs/bigmem.cm") as _f:
    SRC = _f.read()
V = 0xFFFFFFF7  # the sum wraps past 2^32
# (n, whether the gap from an element's write to its read, ~21 n cycles,
# passes the test scale's clock range check span of 2^10 - 1)
SIZES = [(40, False), (64, True)]
ALT_PARAMS = tparams.Poseidon2Params.generate("external/zkhash-stand-in/v1")


@pytest.mark.parametrize("params", [None, ALT_PARAMS], ids=["default", "alt"])
@pytest.mark.parametrize("n", [1, 7, 4096, 4097, 30_001])
def test_native_hash2_equals_hash2_np(n, params):
    """The native core's batch (split over threads above 4,096 hashes)
    against the NumPy hash, under the active and another instance; the
    edge values 0 and p - 1 among the inputs."""
    params = params or tparams.active_params()
    rng = np.random.default_rng(n)
    left = rng.integers(0, P, n, dtype=np.uint32)
    right = rng.integers(0, P, n, dtype=np.uint32)
    left[::5], right[1::5] = 0, P - 1
    got = native.poseidon2_hash2(left, right, params)
    np.testing.assert_array_equal(got, hash2_np(left, right, params))


def _random_memory_input(package, seed: int):
    """A static segment's prover input through ``package``'s Python
    adapter: a dense block of cells and far ones up to the heap's top,
    with random values, under public ranges (program, input, output) that
    give the leaves of both trees multiplicity 2."""
    state = {"cairo_m_tpu": r_state, "cairo_m_tpu_torch": t_state}[package]
    prog = {"cairo_m_tpu": r_program, "cairo_m_tpu_torch": t_program}[package]
    adapter = {"cairo_m_tpu": r_adapter, "cairo_m_tpu_torch": t_adapter}[package]
    rng = np.random.default_rng(seed)
    n_dense = int(rng.integers(40, 400))
    far = rng.integers(n_dense, (1 << 28) - 1, size=int(rng.integers(1, 60)))
    addrs = sorted(set(range(n_dense)) | {int(a) for a in far} | {(1 << 28) - 1})
    values = rng.integers(0, P, size=(len(addrs), 4))
    mem = {a: (tuple(int(x) for x in v), 0, 0) for a, v in zip(addrs, values)}
    seg = state.Segment(initial_memory=mem, memory_trace=[], trace=[state.State(0, 0)])
    ranges = prog.PublicAddressRanges.new(n_dense // 2, 3, 2)
    return adapter.import_from_runner_output(seg, ranges)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prover_input_on_random_memories_equals_reference(seed):
    """Nodes, roots and Poseidon2 inputs of both trees, field by field,
    the port's built with the native hash."""
    ref = _random_memory_input("cairo_m_tpu", seed)
    port = _random_memory_input("cairo_m_tpu_torch", seed)
    assert_same_data(from_reference_prover_input(ref), port)
    assert len(port.poseidon2_inputs) == 2 * len(port.merkle_trees.initial_nodes["index"])


@pytest.mark.parametrize("n", [0, 1, 16, 1000, 5000])
def test_witness_equals_reference_write_trace(n):
    """The port's ``poseidon2`` columns on the CPU (`poseidon2_witness`,
    and the component's host rows), padded rows included, against the JAX
    package's `Poseidon2Component.write_trace` on the same states, column
    by column."""
    rng = np.random.default_rng(n)
    states = np.zeros((n, 16), np.uint32)
    states[:, :2] = rng.integers(0, P, size=(n, 2), dtype=np.uint32)
    states[n // 2:, 2:] = rng.integers(0, P, size=(n - n // 2, 14), dtype=np.uint32)
    states[::7, 3] = P - 1
    pi = SimpleNamespace(poseidon2_inputs=states)
    ref = RPoseidon2Component(RRelations()).write_trace(pi)
    rows = 1 << ref.log_size
    got = poseidon2_witness(torch.from_numpy(states.view(np.int32)), rows)
    assert got.shape == (Poseidon2Component.n_trace_cols, rows) == (
        len(ref.trace_rows), rows)
    comp = Poseidon2Component(Relations()).write_trace(pi)
    assert (comp.log_size, comp.non_padded_length, comp.zero_witness) == (
        ref.log_size, ref.non_padded_length, ref.zero_witness)
    for k, col in enumerate(ref.trace_rows):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(col, np.int64),
                                      err_msg=f"column {k}")
        np.testing.assert_array_equal(comp.trace_rows[k], col, err_msg=f"column {k}")


def test_answer_holds_the_programs_size():
    """The benchmark's answer is `fill_sum` at the size `main` calls and
    the configuration states."""
    with open(f"{REPO_DIR}/benchmark/configs/bigmem.json") as f:
        cfg = json.load(f)
    assert cfg["n_elements"] == answers.N == 128_000 and cfg["reduced"] == []
    assert f"return fill_sum(v, {answers.N});" in SRC
    assert answers.output_slots([V]) == answers.fill_sum_slots(V, answers.N)
    assert answers.fill_sum_slots(0xFFFFFFF7, 4096) == [28672, 65535, 65527, 65535]


@pytest.fixture(scope="module", params=SIZES, ids=[f"n{n}" for n, _ in SIZES])
def fill_sum(request):
    """fill_sum(V, n) at test scale: the port's input (native core, under a
    recorder), proof and recorded spans; the JAX package's input (Python
    VM and adapter) and proof."""
    n, crosses = request.param
    rcfg, tcfg = configs()
    with both_at_test_scale():
        program = compile_cairo(SRC).program
        with observe.record() as rec:
            pi = native_prover_input(program, "fill_sum", [V & 0xFFFF, V >> 16, n], 1 << 30)
            spans, counts = rec.drain()
        proof = prove_cairo_m(pi, tcfg, device="cpu")
        res = run_cairo_program(r_compile_cairo(SRC).program, "fill_sum",
                                [InputValue.number(V), InputValue.number(n)])
        rpi = r_adapter.import_from_runner_output(res.vm.segments[0],
                                                  res.public_address_ranges)
        rproof = r_prove_cairo_m(rpi, rcfg)
    return SimpleNamespace(n=n, crosses=crosses, pi=pi, proof=proof, spans=spans,
                           counts=counts, rpi=rpi, rproof=rproof)


def test_input_equals_reference_and_crosses_the_clock_span(fill_sum):
    assert_same_data(from_reference_prover_input(fill_sum.rpi), fill_sum.pi)
    assert bool(fill_sum.pi.clock_update_data) == fill_sum.crosses


def test_proof_byte_equal_to_reference_and_cross_verified(fill_sum):
    assert proof_json(fill_sum.proof) == proof_json(fill_sum.rproof)
    with both_at_test_scale():
        cross_verify(fill_sum.rproof, fill_sum.proof)


def test_output_is_the_benchmarks_answer(fill_sum):
    pd = fill_sum.proof.public_data
    assert [tuple(e[1]) for e in pd.input if e is not None] == [
        (x, 0, 0, 0) for x in answers.input_slots([V])] + [(fill_sum.n, 0, 0, 0)]
    assert [tuple(e[1]) for e in pd.output if e is not None] == [
        (x, 0, 0, 0) for x in answers.fill_sum_slots(V, fill_sum.n)]


def test_benchmark_reference_accepts_the_proof(fill_sum):
    _, tcfg = configs()
    fri = tcfg.fri_config
    cfg = SecurityConfig(pow_bits=tcfg.pow_bits, log_blowup=fri.log_blowup_factor,
                         log_last_layer_degree_bound=fri.log_last_layer_degree_bound,
                         n_queries=fri.n_queries)
    with protocol_scale(*TEST_SCALE):
        ref_verify.verify(json.loads(proof_json(fill_sum.proof)), cfg)


def test_tree_spans_and_hash_counter(fill_sum):
    """One ``merkle_tree`` span a tree inside ``adapter``, its ``nodes``
    the tree's, and ``poseidon2_hashes`` every hash the poseidon2 AIR
    proves."""
    by_id = {s.id: s for s in fill_sum.spans}
    trees = [s for s in fill_sum.spans if s.name == "merkle_tree"]
    assert [s.attrs["tree"] for s in trees] == ["initial", "final"]
    assert all(by_id[s.parent].name == "adapter" for s in trees)
    mt = fill_sum.pi.merkle_trees
    assert [s.attrs["nodes"] for s in trees] == [
        len(mt.initial_nodes["index"]), len(mt.final_nodes["index"])]
    assert fill_sum.counts["poseidon2_hashes"] == len(fill_sum.pi.poseidon2_inputs)


def test_blocked_lde_and_gathers_give_the_same_proof(fill_sum, monkeypatch):
    """The commit's LDE in column blocks, the composition's bank gathered
    a few rows at a time and the quotients read in chunks that split the
    phases' runs: the proof is byte-equal to the one made whole."""
    _, tcfg = configs()
    monkeypatch.setattr(pcs, "_LDE_BLOCK_VALUES", 1 << 9)
    monkeypatch.setattr(wtape, "_GATHER_VALUES", 1 << 9)
    monkeypatch.setattr(quotients, "_ROW_CHUNK", 3)
    with both_at_test_scale():
        proof = prove_cairo_m(fill_sum.pi, tcfg, device="cpu")
    assert proof_json(proof) == proof_json(fill_sum.proof)
