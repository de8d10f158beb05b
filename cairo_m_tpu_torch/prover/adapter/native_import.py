"""ProverInput from the native VM+adapter core (vectorized assembly).

`native_prover_input(program, entrypoint, args)` = run + witness-prep in
one native pass (~100x the Python path), producing the same ProverInput as
`vm.runner` + `adapter.import_from_runner_output` (cross-tested in
tests/test_native_vm.py).  Scalar felt/u32/bool arguments only; fall back
to the Python path for array arguments.

`native_segment_prover_inputs(program, entrypoint, args, max_steps)` is the
continuation path (reference `vm/mod.rs:177-227` + `tests/prover.rs:204-243`):
the native core stops at the segment cap, exports the full memory image
(locals / heap / sparse far-gap cells), and `cm_run_resume` restarts the
next segment with that image as its clock-0 snapshot — so
``final_root(k) == initial_root(k+1)`` holds for the per-segment proofs.
"""

from __future__ import annotations

import numpy as np

from ... import native
from .. import observe
from ...isa.instruction import SPECS_BY_OPCODE
from ...isa.program import PublicAddressRanges
from .adapter import MerkleTreesData, OpcodeBundles, ProverInput, rc_limit

P = (1 << 31) - 1
REC = 37  # fixed bundle record size (see vm_core.cpp)
MAX_ADDRESS = (1 << 28) - 1


def _assemble(raw, snapshot, ranges, initial_registers) -> ProverInput:
    """Shared RunResult -> ProverInput assembly.

    ``snapshot``: addr -> (value4, 0, 0) — the segment's clock-0 memory
    image (program+entry cells for segment 0; the full previous memory for
    resumed segments)."""
    n_steps = int(raw["n_steps"])
    recs = raw["bundles"].reshape(n_steps, REC)
    pcs, fps, clocks, iprev = recs[:, 0], recs[:, 1], recs[:, 2], recs[:, 3]
    opcodes = recs[:, 4]
    words6 = recs[:, 6:12]
    opdata = recs[:, 13:].reshape(n_steps, 8, 3)

    states_by_opcodes = {}
    for op in np.unique(opcodes):
        op = int(op)
        spec = SPECS_BY_OPCODE[op]
        sel = opcodes == op
        # words6 already starts with the opcode word
        instr_words = words6[sel][:, : spec.size].copy()
        states_by_opcodes[op] = OpcodeBundles(
            op,
            pcs[sel].copy(), fps[sel].copy(), clocks[sel].copy(),
            iprev[sel].copy(),
            opdata[sel][:, : spec.memory_accesses].copy(),
            instr_words,
        )

    initial_memory = dict(snapshot)
    ie = raw["initial_extra"].reshape(-1, 5)
    for row in ie:
        initial_memory[int(row[0])] = (tuple(int(x) for x in row[1:5]), 0, 1)
    final_memory = dict(initial_memory)
    fm = raw["final_mem"].reshape(-1, 6)
    for row in fm:
        addr = int(row[0])
        # accessed: initial mult 1, final mult -1
        iv = initial_memory[addr]
        initial_memory[addr] = (iv[0], iv[1], 1)
        final_memory[addr] = (
            tuple(int(x) for x in row[1:5]), int(row[5]), P - 1
        )

    # public multiplicity fixups (same as adapter.import_from_runner_output)
    for addr in list(ranges.program) + list(ranges.input):
        if addr in initial_memory:
            v, c, _ = initial_memory[addr]
            initial_memory[addr] = (v, c, 0)
        if addr in final_memory and final_memory[addr][2] == 0:
            v, c, _ = final_memory[addr]
            final_memory[addr] = (v, c, P - 1)
    for addr in ranges.output:
        if addr in final_memory:
            v, c, _ = final_memory[addr]
            final_memory[addr] = (v, c, 0)
        if addr in initial_memory:
            v, c, _ = initial_memory[addr]
            initial_memory[addr] = (v, c, 1)

    cu = raw["clock_updates"].reshape(-1, 6)
    clock_update_data = [
        (int(r[0]), int(r[1]), tuple(int(x) for x in r[2:6])) for r in cu
    ]
    final_registers = (int(raw["final_pc"]), int(raw["final_fp"]))

    from .merkle import build_partial_merkle_tree

    initial_nodes, initial_root = build_partial_merkle_tree(
        initial_memory, "initial", ranges
    )
    final_nodes, final_root = build_partial_merkle_tree(
        final_memory, "final", ranges
    )

    def hash_inputs(nodes):
        n = len(nodes["index"])
        out = np.zeros((n, 16), dtype=np.uint32)
        out[:, 0] = nodes["left_value"]
        out[:, 1] = nodes["right_value"]
        return out

    poseidon2_inputs = np.concatenate(
        [hash_inputs(initial_nodes), hash_inputs(final_nodes)], axis=0
    )

    return ProverInput(
        initial_memory=initial_memory,
        final_memory=final_memory,
        clock_update_data=clock_update_data,
        initial_registers=initial_registers,
        final_registers=final_registers,
        states_by_opcodes=states_by_opcodes,
        merkle_trees=MerkleTreesData(
            initial_nodes, final_nodes, initial_root, final_root
        ),
        poseidon2_inputs=poseidon2_inputs,
        public_address_ranges=ranges,
        total_steps=n_steps,
    )


def _entry_snapshot(words, new_fp, args, M, K):
    """Segment-0 snapshot: program words + zero frame + args/call cells."""
    n_words = len(words)
    snapshot = {
        i: (tuple(int(x) for x in words[i]), 0, 0) for i in range(n_words)
    }
    for i in range(new_fp - n_words):
        snapshot.setdefault(n_words + i, ((0, 0, 0, 0), 0, 0))
    for i, a in enumerate(args):
        snapshot[new_fp - (M + K + 2) + i] = ((int(a), 0, 0, 0), 0, 0)
    snapshot[new_fp - 2] = ((new_fp, 0, 0, 0), 0, 0)
    snapshot[new_fp - 1] = ((n_words, 0, 0, 0), 0, 0)
    return snapshot


def native_prover_input(program, entrypoint: str, args, max_steps=1 << 32):
    """args: flat list of M31 ints (call-slot encoding done by the caller
    for scalars: u32 -> two limbs).  Single-segment only — raises when the
    run hits the cap; use `native_segment_prover_inputs` for continuation."""
    info = program.get_entrypoint(entrypoint)
    M = sum(p.ty.call_slot_size() for p in info.params)
    K = sum(r.ty.call_slot_size() for r in info.returns)
    assert len(args) == M, "native path takes call-slot-encoded scalar args"
    words = np.array(program.qm31_words(), dtype=np.uint32)
    fp_offset = M + K + 2
    with observe.span("vm"):
        raw = native.run_raw(
            words, info.pc, fp_offset, np.array(args, np.uint32), K, max_steps,
            rc_limit(), copy=False,
        )
    n_words = len(words)
    new_fp = n_words + fp_offset
    if raw["final_pc"] != n_words:
        raise RuntimeError("native run did not reach final pc (segment cap?)")
    with observe.span("adapter"):
        snapshot = _entry_snapshot(words, new_fp, args, M, K)
        ranges = PublicAddressRanges.new(n_words, M, K)
        pi = _assemble(raw, snapshot, ranges, (info.pc, new_fp))
        raw["free"]()  # all views consumed above; return buffers to native pool
    return pi


def native_segment_prover_inputs(program, entrypoint: str, args,
                                 max_steps: int):
    """Generator of per-segment ProverInputs for a capped continuation run.

    Each segment's initial memory is the previous segment's full final
    image, so consecutive Merkle roots chain:
    ``pi[k].merkle_trees.final_root == pi[k+1].merkle_trees.initial_root``.
    """
    info = program.get_entrypoint(entrypoint)
    M = sum(p.ty.call_slot_size() for p in info.params)
    K = sum(r.ty.call_slot_size() for r in info.returns)
    assert len(args) == M, "native path takes call-slot-encoded scalar args"
    words = np.array(program.qm31_words(), dtype=np.uint32)
    fp_offset = M + K + 2
    n_words = len(words)
    new_fp = n_words + fp_offset
    ranges = PublicAddressRanges.new(n_words, M, K)
    clock_limit = rc_limit()  # the scale when the run starts, for every segment

    raw = native.run_raw(
        words, info.pc, fp_offset, np.array(args, np.uint32), K, max_steps,
        clock_limit, copy=False,
    )
    snapshot = _entry_snapshot(words, new_fp, args, M, K)
    init_regs = (info.pc, new_fp)
    while True:
        pi = _assemble(raw, snapshot, ranges, init_regs)
        done = int(raw["final_pc"]) == n_words
        if done:
            raw["free"]()
            yield pi
            return
        # full memory image -> next segment's snapshot + native resume
        locals_ = raw["locals"].copy()
        heap = raw["heap"].copy()
        sparse = raw["sparse"].copy()
        raw["free"]()
        snapshot = {
            i: (tuple(int(x) for x in locals_[i]), 0, 0)
            for i in range(len(locals_))
        }
        for i in range(len(heap)):
            snapshot[MAX_ADDRESS - i] = (tuple(int(x) for x in heap[i]), 0, 0)
        for row in sparse:
            snapshot[int(row[0])] = (tuple(int(x) for x in row[1:5]), 0, 0)
        init_regs = pi.final_registers
        yield pi
        raw = native.run_resume_raw(
            locals_, heap, sparse,
            init_regs[0], init_regs[1], n_words, max_steps, clock_limit,
            copy=False,
        )
