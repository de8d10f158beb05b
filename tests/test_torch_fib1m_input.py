"""The prover input of the reference's largest single proof,
fibonacci(1,000,000) = 8,000,010 cycles in one segment (no step cap, the
production protocol scale), built by both packages on the CPU: compiler,
native VM core and adapter of each.  No proof is made: equal inputs,
traces and public data catch a host overflow at 8M cycles before the card
proves them (chip_smoke.py phase 10 holds the card's proof to
tests/golden/fib1m_card_proof_sha256.json).  ~35 s and ~5 GiB of host
memory.
"""

import numpy as np
import pytest

from torch_port_helpers import FIB_SRC, assert_same_data

ITERS = 1_000_000
CYCLES = 8_000_010


@pytest.fixture(scope="module")
def inputs():
    """(reference input, port input, reference components, port components),
    the components' traces written."""
    from cairo_m_tpu.compiler import compile_cairo as rcompile
    from cairo_m_tpu.prover.adapter.native_import import native_prover_input as rnative
    from cairo_m_tpu.prover.components.registry import ComponentSet as RComponentSet
    from cairo_m_tpu.prover.relations import Relations as RRelations
    from cairo_m_tpu_torch.compiler import compile_cairo
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet
    from cairo_m_tpu_torch.prover.relations import Relations

    rpi = rnative(rcompile(FIB_SRC).program, "main", [ITERS], max_steps=1 << 32)
    tpi = native_prover_input(compile_cairo(FIB_SRC).program, "main", [ITERS],
                              max_steps=1 << 32)
    rcomps, tcomps = RComponentSet(RRelations()), ComponentSet(Relations())
    rcomps.write_traces(rpi)
    tcomps.write_traces(tpi)
    return rpi, tpi, rcomps, tcomps


def test_one_segment_of_every_cycle(inputs):
    rpi, tpi, _, _ = inputs
    assert rpi.total_steps == tpi.total_steps == CYCLES


def test_log_sizes_equal(inputs):
    _, _, rcomps, tcomps = inputs
    assert tcomps.log_sizes() == rcomps.log_sizes()
    sizes = dict(zip((c.name for c in tcomps.all), tcomps.log_sizes()))
    # the sizes that have never been proved below 2^20 - 1 steps
    assert sizes["store_add_fp_imm"] == 22
    assert max(sizes.values()) == 22


def test_trace_columns_equal(inputs):
    """Every component's trace columns, bit for bit."""
    _, _, rcomps, tcomps = inputs
    for r, t in zip(rcomps.all, tcomps.all, strict=True):
        assert (t.name, t.log_size, t.zero_witness) == (r.name, r.log_size, r.zero_witness)
        assert len(t.trace_rows or []) == len(r.trace_rows or []), t.name
        for k, (x, y) in enumerate(zip(r.trace_rows or [], t.trace_rows or [])):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x),
                                          err_msg=f"{t.name} column {k}")


def test_public_data_equal(inputs):
    from cairo_m_tpu.prover.public_data import PublicData as RPublicData
    from cairo_m_tpu_torch.prover.public_data import PublicData

    rpi, tpi, _, _ = inputs
    assert PublicData.new(tpi).to_json_obj() == RPublicData.new(rpi).to_json_obj()


def test_inputs_equal_field_by_field(inputs):
    rpi, tpi, _, _ = inputs
    assert_same_data(rpi, tpi)


def test_clock_update_rows_present(inputs):
    """The return slot is written 8M cycles after it is allocated: the
    clock gaps beyond the 2^20 - 1 range check are split into
    clock_update rows, the same in both packages."""
    rpi, tpi, rcomps, tcomps = inputs
    assert len(tpi.clock_update_data) == len(rpi.clock_update_data) > 0
    (clock,) = [c for c in tcomps.all if c.name == "clock_update"]
    assert not clock.zero_witness
    assert clock.non_padded_length == len(tpi.clock_update_data)
