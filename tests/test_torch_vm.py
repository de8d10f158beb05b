"""The VM, runner, trace files and native VM core that cairo_m_tpu_torch
keeps as its own copies vs the JAX package's originals.  Each package
compiles the source with its own compiler and runs it with its own VM; the
return values, the binary trace files (``trace_io``), the segment
boundaries and the native cores' ``ProverInput`` arrays must be equal.
Everything is integers and bytes: equality is exact.
"""

import os

import numpy as np
import pytest

from cairo_m_tpu import compiler as rcompiler
from cairo_m_tpu import native as rnative
from cairo_m_tpu.isa import abi_codec as rabi
from cairo_m_tpu.prover.adapter import native_import as rnative_import
from cairo_m_tpu.vm import runner as rrunner
from cairo_m_tpu.vm import trace_io as rtrace_io
from cairo_m_tpu_torch import compiler as tcompiler
from cairo_m_tpu_torch import native as tnative
from cairo_m_tpu_torch.isa import abi_codec as tabi
from cairo_m_tpu_torch.prover.adapter import native_import as tnative_import
from cairo_m_tpu_torch.vm import runner as trunner
from cairo_m_tpu_torch.vm import trace_io as ttrace_io
from torch_port_helpers import FIB_SRC

U32_SRC = """
fn main(n: u32) -> u32 {
    let acc: u32 = 1u32;
    let i: u32 = 0u32;
    while i != n {
        acc = (acc * 3u32 + i) ^ (acc / 7u32);
        i = i + 1u32;
    }
    return acc;
}
"""

REFERENCE = (rcompiler, rabi, rrunner, rtrace_io)
PORT = (tcompiler, tabi, trunner, ttrace_io)

# (source, argument, max_steps): one segment, a u32 program, a run cut into
# continuation segments
RUNS = {
    "fib": (FIB_SRC, 30, None),
    "u32": (U32_SRC, 25, None),
    "fib_segmented": (FIB_SRC, 40, 100),
}


def _run(side, src, arg, max_steps, out_dir):
    """(return values, {file name: bytes} of the trace files, steps per
    segment) of one package's compiler + runner + trace_io."""
    compiler, abi, runner, trace_io = side
    program = compiler.compile_cairo(src).program
    options = (runner.RunnerOptions(max_steps=max_steps) if max_steps
               else runner.RunnerOptions())
    res = runner.run_cairo_program(
        program, "main", [abi.InputValue.number(arg)], options)
    os.makedirs(out_dir)
    segs = res.vm.segments
    trace_io.write_binary_trace(segs, os.path.join(out_dir, "t.bin"))
    trace_io.write_binary_memory_trace(
        segs, res.vm.program_length, os.path.join(out_dir, "t_mem.bin"))
    trace_io.write_initial_memory(segs, os.path.join(out_dir, "t_initmem.bin"))
    files = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            files[name] = f.read()
    return ([v.flatten() for v in res.return_values], files,
            [len(s.trace) - 1 for s in segs])


@pytest.mark.parametrize("name", sorted(RUNS))
def test_runner_and_trace_files_equal(name, tmp_path):
    src, arg, max_steps = RUNS[name]
    want = _run(REFERENCE, src, arg, max_steps, str(tmp_path / "reference"))
    got = _run(PORT, src, arg, max_steps, str(tmp_path / "port"))
    assert got[0] == want[0]
    assert got[2] == want[2]
    assert sorted(got[1]) == sorted(want[1])
    for file_name, data in want[1].items():
        assert got[1][file_name] == data, file_name
    if max_steps:
        assert len(want[2]) > 1 and max(want[2]) <= max_steps


def test_trace_files_read_back(tmp_path):
    """The port's reader gives back the segments its writer wrote."""
    program = tcompiler.compile_cairo(FIB_SRC).program
    res = trunner.run_cairo_program(
        program, "main", [tabi.InputValue.number(40)],
        trunner.RunnerOptions(max_steps=100))
    base = str(tmp_path / "t.bin")
    segs = res.vm.segments
    ttrace_io.write_binary_trace(segs, base)
    ttrace_io.write_binary_memory_trace(
        segs, res.vm.program_length, str(tmp_path / "t_mem.bin"))
    ttrace_io.write_initial_memory(segs, str(tmp_path / "t_initmem.bin"))
    back = ttrace_io.segments_from_files(
        base, str(tmp_path / "t_mem.bin"), str(tmp_path / "t_initmem.bin"))
    assert len(back) == len(segs)
    for a, b in zip(back, segs):
        assert [(s.pc, s.fp) for s in a.trace] == [(s.pc, s.fp) for s in b.trace]
        assert list(a.memory_trace) == list(b.memory_trace)


def _assert_same_input(a, b):
    assert a.total_steps == b.total_steps
    assert a.initial_registers == b.initial_registers
    assert a.final_registers == b.final_registers
    assert a.initial_memory == b.initial_memory
    assert a.final_memory == b.final_memory
    assert a.clock_update_data == b.clock_update_data
    np.testing.assert_array_equal(a.poseidon2_inputs, b.poseidon2_inputs)
    assert a.merkle_trees.initial_root == b.merkle_trees.initial_root
    assert a.merkle_trees.final_root == b.merkle_trees.final_root
    for x, y in ((a.merkle_trees.initial_nodes, b.merkle_trees.initial_nodes),
                 (a.merkle_trees.final_nodes, b.merkle_trees.final_nodes)):
        assert sorted(x) == sorted(y)
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])
    assert sorted(a.states_by_opcodes) == sorted(b.states_by_opcodes)
    for op, x in a.states_by_opcodes.items():
        y = b.states_by_opcodes[op]
        for field in ("pc", "fp", "clock", "inst_prev_clock", "operands", "instr_words"):
            np.testing.assert_array_equal(getattr(x, field), getattr(y, field))
    ra, rb = a.public_address_ranges, b.public_address_ranges
    assert ([list(ra.program), list(ra.input), list(ra.output)]
            == [list(rb.program), list(rb.input), list(rb.output)])


@pytest.mark.parametrize("name, args", [("fib", [300]), ("u32", [25, 0])])
def test_native_cores_equal(name, args):
    """Each package's native core (the port builds its own at first use)."""
    src = RUNS[name][0]
    want = rnative_import.native_prover_input(
        rcompiler.compile_cairo(src).program, "main", args)
    got = tnative_import.native_prover_input(
        tcompiler.compile_cairo(src).program, "main", args)
    _assert_same_input(got, want)


def test_native_segments_equal():
    sides = [
        list(mod.native_segment_prover_inputs(
            comp.compile_cairo(FIB_SRC).program, "main", [40], 100))
        for mod, comp in ((rnative_import, rcompiler), (tnative_import, tcompiler))
    ]
    assert len(sides[0]) == len(sides[1]) == 4
    for want, got in zip(*sides):
        _assert_same_input(got, want)


def test_native_core_equals_python_vm():
    """The port's native core against the port's Python VM + adapter."""
    from cairo_m_tpu_torch.prover.adapter.adapter import import_from_runner_output

    program = tcompiler.compile_cairo(FIB_SRC).program
    res = trunner.run_cairo_program(program, "main", [tabi.InputValue.number(25)])
    want = import_from_runner_output(res.vm.segments[0], res.public_address_ranges)
    _assert_same_input(tnative_import.native_prover_input(program, "main", [25]), want)


def test_native_core_is_built_from_source():
    """No binary is committed: the library lies in the build directory,
    named by a hash of its source and flags."""
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert path == tnative.library_path() and os.path.exists(path)
    package = os.path.dirname(os.path.abspath(tnative.__file__))
    assert not [f for f in os.listdir(package) if f.endswith(".so")]
    assert rnative  # the reference keeps its own committed library


def test_failed_native_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "vm_core.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="failed"):
        tnative.build()
