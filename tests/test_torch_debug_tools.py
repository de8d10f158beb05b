"""The debug tools of cairo_m_tpu_torch (``prover/debug_tools.py``) vs the
JAX reference's, at test scale (set_test_scale(10, 8)): on the same inputs
``assert_constraints`` reports the same failures and ``relation_tracker``
the same unbalanced relation entries, for sound inputs (none) and for
inputs with one value tampered.
"""

import pytest

from cairo_m_tpu.prover import debug_tools as rdebug
from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output as r_import
from cairo_m_tpu_torch.prover import debug_tools
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from torch_port_helpers import both_at_test_scale, make_static_input, reference_fib_input


@pytest.fixture(scope="module", autouse=True)
def _test_scale():
    with both_at_test_scale():
        yield


def _static():
    return make_static_input(r_import)


def _fib():
    return reference_fib_input(10)


def _fib_final_memory_tampered():
    pi = _fib()
    addr = max(pi.final_memory)
    value, clock, mult = pi.final_memory[addr]
    pi.final_memory[addr] = ((value[0] + 1,) + tuple(value[1:]), clock, mult)
    return pi


def _fib_operand_tampered():
    """The sum written by the first store_add_fp_fp (opcode 0) is off by
    one: its constraint fails at row 0, and so does the LogUp balance."""
    pi = _fib()
    pi.states_by_opcodes[0].operands[0, -1, 2] += 1
    return pi


INPUTS = [_static, _fib, _fib_final_memory_tampered, _fib_operand_tampered]
IDS = ["static", "fib10", "fib10_final_memory_tampered", "fib10_operand_tampered"]


@pytest.mark.parametrize("make", INPUTS, ids=IDS)
def test_assert_constraints_matches_reference(make):
    pi = make()
    want = rdebug.assert_constraints(pi, raise_on_failure=False)
    got = debug_tools.assert_constraints(
        from_reference_prover_input(pi), raise_on_failure=False
    )
    assert got == want
    assert bool(got) == (make in (_fib_final_memory_tampered, _fib_operand_tampered))
    if make is _fib_operand_tampered:
        assert got[0] == "store_add_fp_fp: constraint 1 fails at row 0"


@pytest.mark.parametrize("make", INPUTS, ids=IDS)
def test_relation_tracker_matches_reference(make):
    pi = make()
    want = rdebug.relation_tracker(pi)
    got = debug_tools.relation_tracker(from_reference_prover_input(pi))
    assert got == want
    assert bool(got) == (make in (_fib_final_memory_tampered, _fib_operand_tampered))


def test_assert_constraints_raises_on_failure():
    with pytest.raises(debug_tools.ConstraintError, match="LogUp"):
        debug_tools.assert_constraints(
            from_reference_prover_input(_fib_final_memory_tampered())
        )
