"""cairo_m_tpu_torch vs the JAX reference on the u32 witnesses at test
scale (tests/golden/witnesses.json): ``u32_stress`` (u32 add, sub, div_rem,
mul, eq and lt; range_check_8 and range_check_16), under the native and the
stwo framing, and ``u32_cast`` (the u32 -> felt cast: u32_store_lt_fp_imm
and assert_eq_fp_imm).

Per witness: equal trace columns, constraints and LogUp balance in both
packages, the port's native input equal to the reference's input, and the
port's proof on the CPU equal to the committed reference digest; the slow
tier adds the live reference proof, byte-equal, and cross-verification
(torch_port_helpers.WitnessChecks)."""

from torch_port_helpers import WitnessChecks, WitnessProofChecks


class TestU32Stress(WitnessChecks):
    name = "u32_stress"


class TestU32StressStwo(WitnessProofChecks):
    """The stwo framing's mixed-degree trees over this witness's column
    sizes."""

    name = "u32_stress"
    framing = "stwo"


class TestU32Cast(WitnessChecks):
    name = "u32_cast"
