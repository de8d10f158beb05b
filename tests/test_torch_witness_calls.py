"""cairo_m_tpu_torch vs the JAX reference on the witnesses of calls and
felt arithmetic at test scale (tests/golden/witnesses.json):
``recursion`` (call_abs_imm, ret, jnz_fp_imm), ``felt_ops`` (mul, div,
double deref, store_frame_pointer) and ``deref_heap`` (heap stores through
store_to_double_deref_fp_imm).  The checks are
torch_port_helpers.WitnessChecks."""

from torch_port_helpers import WitnessChecks


class TestRecursion(WitnessChecks):
    name = "recursion"


class TestFeltOps(WitnessChecks):
    name = "felt_ops"


class TestDerefHeap(WitnessChecks):
    name = "deref_heap"
