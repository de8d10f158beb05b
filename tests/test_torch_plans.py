"""The constraint plans of every AIR component in cairo_m_tpu_torch vs the
JAX reference: the interaction, table-count and composition plan of each of
the 45 components, recorded by both packages on the traces of the static
segment (every component at its padded size), at test scale and, for the
two components whose plans read the protocol scale (range_check_20 and
bitwise), at production scale too.

Plans are recorded once per module and per side (recording is the prover's
cold-start cost), and compared field by field.  Each composition plan's
degree is held to what the composition's domain can hold."""

import numpy as np
import pytest

from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output as r_import
from cairo_m_tpu.prover.components.registry import ComponentSet as RComponentSet
from cairo_m_tpu.prover.relations import Relations as RRelations
from cairo_m_tpu.prover.stark import framework as rframework
from cairo_m_tpu_torch.prover.adapter.adapter import from_reference_prover_input
from cairo_m_tpu_torch.prover.components.registry import ComponentSet
from cairo_m_tpu_torch.prover.relations import Relations
from cairo_m_tpu_torch.prover.stark import framework
from torch_port_helpers import (
    PRODUCTION_SCALE,
    TEST_SCALE,
    both_at_scale,
    make_static_input,
)

NAMES = [c.name for c in ComponentSet(Relations()).all]
SCALED = ["range_check_20", "bitwise"]
KINDS = ["interaction", "composition", "tcount"]
CASES = ([("test", k, n) for n in NAMES for k in KINDS]
         + [("production", k, n) for n in SCALED for k in KINDS])
SCALES = {"test": TEST_SCALE, "production": PRODUCTION_SCALE}


def test_both_packages_list_the_same_components():
    assert len(NAMES) == 45
    assert [c.name for c in RComponentSet(RRelations()).all] == NAMES


class _Sides:
    """(reference, port) component sets with traces written, per scale,
    and the plans recorded from them, filled as the tests ask."""

    def __init__(self):
        self.sets = {}
        self.plans = {}

    def comps(self, scale):
        if scale not in self.sets:
            with both_at_scale(SCALES[scale]):
                pi = make_static_input(r_import)
                rrel = RRelations()
                rcomps = RComponentSet(rrel)
                rcomps.write_traces(pi)
                trel = Relations()
                tcomps = ComponentSet(trel)
                tcomps.write_traces(from_reference_prover_input(pi))
            self.sets[scale] = ((rcomps, rrel), (tcomps, trel))
        return self.sets[scale]

    def plan(self, scale, kind, name):
        key = (scale, kind, name)
        if key not in self.plans:
            out = []
            with both_at_scale(SCALES[scale]):
                for fw, (comps, rel) in zip((rframework, framework), self.comps(scale)):
                    comp = next(c for c in comps.all if c.name == name)
                    if kind == "interaction":
                        out.append(fw.interaction_plan(comp, rel))
                    elif kind == "composition":
                        out.append((fw.composition_plan(comp, rel), None))
                    else:
                        out.append(fw.table_count_plan(comp, rel))
            self.plans[key] = out
        return self.plans[key]


@pytest.fixture(scope="module")
def sides():
    return _Sides()


def _plan_fields(plan):
    return (plan.opc, plan.ia, plan.ib, plan.dst, plan.out_regs, plan.consts,
            plan.n_regs, plan.dyn_slots, plan.used_bank, plan.n_instrs)


@pytest.mark.parametrize("scale, kind, name", CASES,
                         ids=[f"{s}-{k}-{n}" for s, k, n in CASES])
def test_plans_identical(sides, scale, kind, name):
    (rp, rmeta), (tp, tmeta) = sides.plan(scale, kind, name)
    assert rmeta == tmeta
    if rp is None:  # a component that consumes no table
        assert kind == "tcount" and tp is None
        return
    assert tp is not None
    for x, y in zip(_plan_fields(rp), _plan_fields(tp)):
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def plan_degree(plan) -> int:
    """Degree of a plan's outputs as polynomials in the bank rows: trace,
    interaction and preprocessed rows have degree 1, the vanishing
    inverse and every constant 0; add and sub take the larger degree, mul
    the sum.  For a composition plan this is the largest constraint
    degree."""
    bank = [0 if kind == "v" else 1 for kind, _, _ in plan.used_bank]
    deg = {}
    for s in range(plan.n_steps):
        writes = []  # a step reads before it writes
        for w in range(plan.width):
            if plan.dst[s, w] == 0:  # NOP
                continue
            opc = int(plan.opc[s, w])
            op, spaces = opc // 9, ((opc // 3) % 3, opc % 3)
            d = [deg[i] if sp == 0 else bank[i] if sp == 1 else 0
                 for sp, i in zip(spaces, (int(plan.ia[s, w]), int(plan.ib[s, w])))]
            writes.append((int(plan.dst[s, w]), sum(d) if op == 2 else max(d)))
        deg.update(writes)
    return max(deg[int(r)] for r in plan.out_regs)


# The composition is evaluated on twice the trace's domain, which holds a
# quotient C / Z of a constraint C of degree at most 3 (degree 2N - 3 < 2N).
# store_le_fp_imm's arc constraints, enabler * keep * (arc_short * arc_long
# - ...), have degree 4: where a keep flag is not constant over the rows
# (padding rows keep arcs 0 and 1; `x <= 2000000000` with x = 500 keeps 0
# and 2) the quotient aliases on that domain, and the proof fails the OODS
# check in both packages (ROADMAP §3).
DEGREE_4 = {"store_le_fp_imm"}


@pytest.mark.parametrize("name", NAMES)
def test_composition_degree(sides, name):
    (rp, _), (tp, _) = sides.plan("test", "composition", name)
    deg = plan_degree(tp)
    assert plan_degree(rp) == deg
    assert deg == 4 if name in DEGREE_4 else 2 <= deg <= 3


@pytest.mark.parametrize("name", SCALED)
def test_scaled_plans_follow_the_scale(sides, name):
    """range_check_20 and bitwise take their size from the protocol scale:
    their production plans are recorded at the production table sizes."""
    test_comp, prod_comp = (
        next(c for c in sides.comps(s)[1][0].all if c.name == name)
        for s in ("test", "production"))
    assert prod_comp.log_size > test_comp.log_size
    assert prod_comp.log_size == {"range_check_20": 20, "bitwise": 18}[name]
