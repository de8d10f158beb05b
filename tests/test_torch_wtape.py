"""Wide-tape plans and their interpreter in cairo_m_tpu_torch vs the JAX
reference, on the fibonacci-40 witness at test scale.

- the recorded plans are identical in both packages;
- the plain torch interpreter equals the Pallas executor (interpreter mode,
  as tests/test_pallas.py runs it) on the plan that
  test_pallas_wide_tape_matches_scan uses, and the `lax.scan` interpreter on
  poseidon2's composition plan, which has more than 64 steps;
- `run_wide` (bank gathers, fft->row reorder, row shifts) equals the
  reference's on the same stacks;
- the instruction stream the CUDA kernel runs (`kernel_program`: NOPs
  dropped, instructions re-ordered into bundles, registers re-allocated,
  outputs stored when computed) gives the plan's outputs, through a NumPy
  model of the kernel, on every plan of the witness, on every plan of the
  components it leaves idle (taken from the witnesses of
  tests/golden/witnesses.json) and on random plans.

The CUDA kernels themselves are held to the plain interpreter in
tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest

from cairo_m_tpu.prover.components.registry import ComponentSet as RComponentSet
from cairo_m_tpu.prover.relations import Relations as RRelations
from cairo_m_tpu.prover.stark import framework as rframework
from cairo_m_tpu.prover.stark import wtape as rwtape
from cairo_m_tpu.prover.stark import wtape_pallas
from cairo_m_tpu.prover.stark.air import logup_shift_scalar as r_shift
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from cairo_m_tpu_torch.prover.components.registry import ComponentSet
from cairo_m_tpu_torch.prover.relations import Relations
from cairo_m_tpu_torch.prover.stark import framework, wtape
from cairo_m_tpu_torch.prover.stark.air import logup_shift_scalar
from torch_port_helpers import (
    P,
    WITNESSES,
    both_at_test_scale,
    constant_free_plan,
    port_native_witness_input,
    random_wide_plan,
    reference_fib_input,
    run_kernel_stream,
    to_np,
    to_t,
    wide_sum_plan,
    witness_scale,
)


class _Channel:
    """Deterministic stand-in for the Fiat-Shamir draws."""

    def __init__(self):
        self.i = 0

    def draw_felt(self):
        self.i += 1
        return (self.i * 12345 % P, self.i, 7, 11)


class _Side:
    def __init__(self, comps, relations, fw, shift_fn):
        self.comps, self.relations, self.fw, self.shift = comps, relations, fw, shift_fn

    def comp(self, name):
        return next(c for c in self.comps.all if c.name == name)

    def comp_consts(self, comp, plan):
        apows = [(1, 0, 0, 0)] + [(3 + i, 1, 4, 1) for i in range(600)]
        return plan.const_values(self.fw._DynResolver(
            self.relations, shift=self.shift((1, 2, 3, 4), comp.log_size),
            apows=apows))


@pytest.fixture(scope="module")
def sides():
    with both_at_test_scale():
        pi = reference_fib_input(40)
        rrel = RRelations()
        rcomps = RComponentSet(rrel)
        rcomps.write_traces(pi)
        rrel.draw(_Channel())
        trel = Relations()
        tcomps = ComponentSet(trel)
        tcomps.write_traces(from_reference_prover_input(pi))
        trel.draw(_Channel())
        yield (_Side(rcomps, rrel, rframework, r_shift),
               _Side(tcomps, trel, framework, logup_shift_scalar))


@pytest.fixture()
def wtape_interpret():
    saved = wtape_pallas._INTERPRET
    wtape_pallas._INTERPRET = True
    wtape_pallas._call.cache_clear()
    yield
    wtape_pallas._INTERPRET = saved
    wtape_pallas._call.cache_clear()


def _plan_fields(plan):
    return (plan.opc, plan.ia, plan.ib, plan.dst, plan.out_regs, plan.consts,
            plan.n_regs, plan.dyn_slots, plan.used_bank, plan.n_instrs)


def _assert_same_plan(a, b):
    for x, y in zip(_plan_fields(a), _plan_fields(b)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


@pytest.mark.parametrize("kind", ["interaction", "composition", "tcount"])
@pytest.mark.parametrize("name", ["store_add_fp_fp", "poseidon2", "memory", "jnz_fp_imm"])
def test_plans_identical(sides, kind, name):
    ref, port = sides
    with both_at_test_scale():
        if kind == "interaction":
            (rp, re), (tp, te) = (
                s.fw.interaction_plan(s.comp(name), s.relations) for s in sides
            )
            assert re == te
        elif kind == "composition":
            rp, tp = (s.fw.composition_plan(s.comp(name), s.relations) for s in sides)
        else:
            (rp, rm), (tp, tm) = (
                s.fw.table_count_plan(s.comp(name), s.relations) for s in sides
            )
            assert rm == tm
            if rp is None:
                assert tp is None
                return
        _assert_same_plan(rp, tp)


def _rows(plan, elog, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, P, size=(len(plan.used_bank), 1 << elog), dtype=np.uint32)


def _plain_vs_pallas(sides):
    """The body of `test_plain_matches_pallas_executor`; returns the
    reference's plan.

    The reference's ``run_plan`` caches its operand remap on the plan
    object (``_pallas_cache``), computed with the bank-row count of its
    first call, and ``framework.composition_plan`` caches the plan itself
    process-wide.  This call gives it unbucketed rows, so the cache must
    not outlive it: tests/test_pallas.py, run later in the same process,
    would read its constants at stale offsets."""
    ref, port = sides
    with both_at_test_scale():
        comp = port.comp("store_add_fp_fp")
        elog = comp.log_size + 1
        tplan = framework.composition_plan(comp, port.relations)
        rplan = rframework.composition_plan(ref.comp("store_add_fp_fp"), ref.relations)
        consts = port.comp_consts(comp, tplan)
    assert tplan.n_steps <= wtape_pallas.MAX_STEPS
    rows = _rows(tplan, elog, 0)
    try:
        want = np.asarray(wtape_pallas.run_plan(jnp.asarray(rows), consts, rplan, elog))
    finally:
        rplan.__dict__.pop("_pallas_cache", None)
    got = wtape.run_plan(to_t(rows), consts, tplan)
    np.testing.assert_array_equal(to_np(got), want)
    return rplan


def test_plain_matches_pallas_executor(sides, wtape_interpret):
    """The plan of tests/test_pallas.py::test_pallas_wide_tape_matches_scan."""
    _plain_vs_pallas(sides)


def test_pallas_executor_cache_does_not_outlive_the_test(sides, wtape_interpret):
    """After the comparison above, the reference's cached plan carries no
    operand remap, and the reference's own Pallas-vs-scan comparison
    (tests/test_pallas.py, bucketed bank rows) agrees in the same
    process."""
    import test_pallas

    rplan = _plain_vs_pallas(sides)
    assert "_pallas_cache" not in rplan.__dict__
    test_pallas.test_pallas_wide_tape_matches_scan()


def _scan_reference(plan, rows, consts, elog):
    """wtape._wide_kernel (the reference's lax.scan interpreter)."""
    S, W = plan.n_steps, plan.width
    Sb = rwtape._bucket(S, 16)
    n_out = len(plan.out_regs)
    ob = rwtape._bucket(n_out, 4)
    R = rwtape._bucket(plan.n_regs, 16)
    pad = lambda a, fill: np.concatenate(  # noqa: E731
        [a, np.full((Sb - S, W), fill, np.int32)]
    )
    opc, ia, ib, dst = (pad(plan.opc, 8), pad(plan.ia, 0), pad(plan.ib, 0),
                        pad(plan.dst, 0))
    out_regs = np.concatenate([plan.out_regs, np.zeros(ob - n_out, np.int32)])
    fn = rwtape._wide_kernel(rows.shape[0], Sb, W, R, ob, elog, 1)
    out = fn(jnp.asarray(rows), jnp.asarray(consts), jnp.asarray(opc),
             jnp.asarray(ia), jnp.asarray(ib), jnp.asarray(dst),
             jnp.asarray(out_regs))
    return np.asarray(out)[:n_out]


def test_plain_matches_scan_on_long_plan(sides):
    """poseidon2's composition plan: over 64 steps, where the TPU package
    leaves Pallas for the scan interpreter (the port has no such cap)."""
    ref, port = sides
    with both_at_test_scale():
        comp = port.comp("poseidon2")
        elog = comp.log_size + 1
        plan = framework.composition_plan(comp, port.relations)
        consts = port.comp_consts(comp, plan)
    assert plan.n_steps > wtape_pallas.MAX_STEPS
    rows = _rows(plan, elog, 1)
    want = _scan_reference(plan, rows, consts, elog)
    np.testing.assert_array_equal(to_np(wtape.run_plan(to_t(rows), consts, plan)), want)


@pytest.mark.parametrize("fft_order", [True, False])
def test_run_wide_matches_reference(sides, fft_order):
    """Bank prep + execution over multi-stack inputs with row shifts."""
    ref, port = sides
    with both_at_test_scale():
        comp = port.comp("store_add_fp_fp")
        elog = comp.log_size + 1
        plan = framework.composition_plan(comp, port.relations)
        consts = port.comp_consts(comp, plan)
    n = 1 << elog
    rng = np.random.default_rng(7)
    stacks = [rng.integers(0, P, size=(k, n), dtype=np.uint32) for k in (20, 0, 9, 1)]
    bounds = np.cumsum([0, 20, 0, 9])
    src = np.zeros(len(plan.used_bank), np.int64)
    sh = np.zeros(len(plan.used_bank), np.int64)
    for j, (kind, idx, offset) in enumerate(plan.used_bank):
        base = {"t": 0, "i": 2, "p": 2, "v": 3}[kind]
        size = stacks[base].shape[0]
        src[j] = bounds[base] + idx % size
        sh[j] = (2 * offset) % n
    want = np.asarray(rwtape.run_wide(
        [jnp.asarray(s) for s in stacks], src.astype(np.int32),
        sh.astype(np.uint32), consts, plan, elog, fft_order=fft_order))
    got = wtape.run_wide([to_t(s) for s in stacks], src, sh, consts, plan, elog,
                         fft_order=fft_order)
    np.testing.assert_array_equal(to_np(got), want)


def test_run_plan_rejects_bad_input(sides):
    ref, port = sides
    with both_at_test_scale():
        comp = port.comp("store_add_fp_fp")
        plan = framework.composition_plan(comp, port.relations)
    rows = to_t(_rows(plan, 4, 0))
    with pytest.raises(ValueError):
        wtape.run_plan(rows[:-1], plan.consts, plan)
    with pytest.raises(ValueError):
        wtape.run_plan(rows.int(), plan.consts, plan)



# the components that fibonacci(40) keeps busy; the opcode components also
# have a table-count plan
LIVE = ["memory", "merkle", "poseidon2", "range_check_20", "store_add_fp_fp",
        "store_sub_fp_fp", "store_add_fp_imm", "store_imm", "ret", "jmp_abs_imm",
        "jnz_fp_imm"]
# the components fibonacci(40) leaves idle: their plans are taken from the
# first witness of tests/golden/witnesses.json that keeps them busy
OTHERS = [c.name for c in ComponentSet(Relations()).all if c.name not in LIVE]
NO_TABLE = ("memory", "merkle", "poseidon2", "clock_update")  # no table-count plan
PLANS = ([("interaction", n) for n in LIVE] + [("composition", n) for n in LIVE]
         + [("tcount", n) for n in LIVE if n not in NO_TABLE]
         + [(k, n) for n in OTHERS for k in ("interaction", "composition", "tcount")
            if not (k == "tcount" and n in NO_TABLE)])


def _check_kernel_stream(plan, consts, n, seed, lanes, random_plan=False):
    prog = wtape.kernel_program(plan)
    assert len(prog.op) % prog.width == 0
    assert prog.n_out == len(plan.out_regs)
    # the schedule's NOP slots are gone: what is left are the plan's real
    # instructions, one store per output, and the fill of short bundles
    real = int((plan.dst != 0).sum())
    assert int((prog.op == 3).sum()) == prog.n_out
    assert len(prog.op) - prog.n_fill == real + prog.n_out
    if real >= 100 and not random_plan:
        assert prog.n_fill <= 0.1 * real  # the witness's plans fill their bundles
    rows = np.random.default_rng(seed).integers(
        0, P, size=(len(plan.used_bank), n), dtype=np.uint32)
    want = to_np(wtape.run_plan(to_t(rows), consts, plan))
    np.testing.assert_array_equal(run_kernel_stream(prog, lanes, rows, consts), want)
    return prog


@pytest.fixture(scope="module")
def witness_sides():
    """component name -> (its witness's scale context, the port's _Side of
    that witness) for every component that fibonacci(40) leaves idle."""
    out = {}
    for wname in WITNESSES:
        if len(out) == len(OTHERS):
            break  # the later witnesses (the SHA-256 example) add no component
        with witness_scale(wname):
            trel = Relations()
            tcomps = ComponentSet(trel)
            tcomps.write_traces(port_native_witness_input(wname))
            trel.draw(_Channel())
        side = _Side(tcomps, trel, framework, logup_shift_scalar)
        for c in tcomps.all:
            if not c.zero_witness and c.name in OTHERS:
                out.setdefault(c.name, (wname, side))
    assert sorted(out) == sorted(OTHERS)
    return out


@pytest.mark.parametrize("kind, name", PLANS, ids=[f"{k}-{n}" for k, n in PLANS])
def test_kernel_stream_matches_plain(request, sides, kind, name):
    """Every plan of every component, on the witness that keeps it busy:
    the kernel's stream through the NumPy model of the kernel ==
    `run_plan_plain` on the plan as scheduled."""
    if name in LIVE:
        port, scale = sides[1], both_at_test_scale()
    else:
        wname, port = request.getfixturevalue("witness_sides")[name]
        scale = witness_scale(wname)
    with scale:
        comp = port.comp(name)
        assert not comp.zero_witness
        if kind == "composition":
            plan = framework.composition_plan(comp, port.relations)
            consts = port.comp_consts(comp, plan)
        else:
            plan = (framework.interaction_plan(comp, port.relations)[0]
                    if kind == "interaction"
                    else framework.table_count_plan(comp, port.relations)[0])
            consts = plan.const_values(framework._DynResolver(port.relations))
    prog = _check_kernel_stream(plan, consts, 80, len(name), 32)
    # fewer registers than the schedule made for 32 slots a step, bank rows
    # included
    assert prog.n_regs <= plan.n_regs + len(plan.used_bank)
    # the range-check tables' compositions are few instructions over their
    # bank rows: there is little to re-allocate
    if kind == "composition" and not name.startswith("range_check_"):
        assert prog.n_regs < 0.7 * plan.n_regs


def test_witness_has_no_other_live_component(sides):
    _, port = sides
    assert sorted(c.name for c in port.comps.all if not c.zero_witness) == sorted(LIVE)


@pytest.mark.parametrize("lanes", [32, 64])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_stream_on_random_plans(seed, lanes):
    plan, consts = random_wide_plan(seed)
    # 200 lanes: a ragged last block
    _check_kernel_stream(plan, consts, 200, seed, lanes, random_plan=True)


def test_global_kernel_instruction_list_drops_only_nops():
    """The global-scratch kernel's list: the plan's real slots in step
    order; run one by one it gives the plan's outputs."""
    import torch

    plan, consts = random_wide_plan(4)
    rows = to_t(np.random.default_rng(4).integers(
        0, P, size=(len(plan.used_bank), 50), dtype=np.uint32))
    instrs, out_regs = wtape._plan_arrays(plan, rows.shape[0], rows.device,
                                          drop_nops=True)
    assert instrs.shape[0] == int((plan.dst != 0).sum()) < plan.opc.size
    got = wtape.run_plan_plain(rows, torch.from_numpy(np.asarray(consts, np.int64)),
                               instrs, out_regs, plan.n_regs, 1)
    assert torch.equal(got, wtape.run_plan(rows, consts, plan))


@pytest.mark.parametrize("n_regs, n, want", [
    (80, 1 << 20, 32),    # composition plans: shared memory limits the blocks
    (46, 1 << 18, 32),    # 29 blocks of 32 lanes an SM: still shared memory
    (35, 1 << 19, 64),    # 32 blocks an SM cap the 32-lane block: two lanes a thread
    (19, 1 << 21, 64),
    (33, 1 << 9, 32),     # a short domain: the most blocks to spread
    (548, 1 << 10, 32),   # poseidon2
    (1800, 1 << 10, 32),  # the largest file shared memory holds
    (1900, 1 << 10, None),
])
def test_pick_lanes(n_regs, n, want):
    assert wtape.pick_lanes(n_regs, n) == want
    if want:
        assert wtape.smem_bytes(n_regs, want) <= 232448


@pytest.mark.parametrize("lanes", [32, 64])
def test_kernel_stream_without_constants(lanes):
    """A plan that uses no constant and whose bundles are short: the NOPs
    that fill them name no constant either, so the stream runs on an empty
    constant vector (the kernel would look an index up in it)."""
    plan, consts = constant_free_plan()
    prog = wtape.kernel_program(plan)
    assert prog.n_fill > 0
    assert not (prog.a_const | prog.b_const).any()
    rows = np.random.default_rng(3).integers(0, P, size=(3, 70), dtype=np.uint32)
    want = to_np(wtape.run_plan(to_t(rows), consts, plan))
    got = run_kernel_stream(prog, lanes, rows, np.zeros(0, np.uint32))
    np.testing.assert_array_equal(got, want)
    a, b, c = rows.astype(np.uint64)
    assert want[0].tolist() == ((a * b + P - (b * c) % P) % P).tolist()


def test_run_plan_rejects_unknown_variant():
    plan, consts = random_wide_plan(0)
    rows = to_t(np.zeros((len(plan.used_bank), 4), np.uint32))
    with pytest.raises(ValueError, match="variant"):
        wtape.run_plan(rows, consts, plan, variant="fast")


def test_large_register_file_takes_the_global_kernel_by_rule():
    """Every bank row holds a register, so 2000 of them are beyond shared
    memory: `pick_lanes` says so (on the card `run_plan` then launches the
    global-scratch kernel; tests/test_torch_cuda.py).  The plan's stream is
    still right."""
    plan, consts = wide_sum_plan(2000)
    prog = wtape.kernel_program(plan)
    assert prog.n_regs >= 2000
    assert wtape.pick_lanes(prog.n_regs, 256) is None
    rows = np.random.default_rng(0).integers(0, P, size=(2000, 40), dtype=np.uint32)
    want = to_np(wtape.run_plan(to_t(rows), consts, plan))
    np.testing.assert_array_equal(run_kernel_stream(prog, 32, rows, consts), want)
    assert want[0].tolist() == (rows.astype(np.uint64).sum(axis=0) % P).tolist()
