"""cairo_m_tpu_torch vs the JAX reference at test scale on
``fib400_clock`` (fibonacci(400): clock gaps beyond the test scale's 2^10 - 1
clock range make clock_update rows, which the port's native VM core must
cut as the Python adapter does) and ``asm_ops`` (a program assembled from
the ISA's instructions for the opcodes no compiled program emits:
jmp_rel_imm, store_double_deref_fp_fp, store_to_double_deref_fp_fp).  The
checks are torch_port_helpers.WitnessChecks."""

from torch_port_helpers import WitnessChecks


class TestFib400Clock(WitnessChecks):
    name = "fib400_clock"

    def test_clock_update_rows(self, native_input):
        assert len(native_input.clock_update_data) > 0


class TestAsmOps(WitnessChecks):
    name = "asm_ops"
