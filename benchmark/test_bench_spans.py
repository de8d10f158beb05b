"""`benchmark.spans` on synthetic records: each reader of the program's
spans, and the attribution of idle gaps to the innermost program span by
their midpoint, with the harness's label where no program span holds
one."""

from types import SimpleNamespace

import pytest

from benchmark import spans as sp


def S(id, name, start, end, parent=None, root=None, **attrs):
    return SimpleNamespace(id=id, name=name, start=start, end=end, parent=parent,
                           root=root or id, attrs=attrs)


def job(t0=0):
    """One job: vm [0, 10), adapter [10, 20), prove [20, 100) holding an
    interaction dispatch [30, 50) with a plan recorded inside [35, 45),
    and pcs [60, 100) holding two pulls [60, 70), [80, 90)."""
    t = t0
    spans = [
        S(1, "vm", t + 0, t + 10), S(2, "adapter", t + 10, t + 20),
        S(10, "prove", t + 20, t + 100),
        S(11, "interaction", t + 20, t + 60, parent=10, root=10),
        S(12, "dispatch", t + 30, t + 50, parent=11, root=10, stage="interaction",
          component="c"),
        S(13, "plan_record", t + 35, t + 45, parent=12, root=10),
        S(14, "pcs", t + 60, t + 100, parent=10, root=10),
        S(15, "pull", t + 60, t + 70, parent=14, root=10),
        S(16, "pull", t + 80, t + 90, parent=14, root=10),
    ]
    harness = [("vm_adapter", t + 0, t + 20), ("prove:trace", t + 20, t + 100),
               ("prove:sync", t + 100, t + 110)]
    return {"program_spans": spans, "program_counts": {"pulls": 2},
            "spans": harness}


def test_readers_of_window_jobs():
    rec = {"jobs": [job(0), job(1000)]}
    assert sp.vm_s(rec) == 10e-9
    assert sp.adapter_s(rec) == 10e-9
    assert sp.component_dispatch_s(rec) == 10e-9  # 20 less the plan's 10
    assert sp.host_pulls_per_proof(rec) == 2
    assert sp.pull_wait_s(rec) == 20e-9


def test_cold_readers():
    spans = [
        S(1, "prove", 0, 1000),
        S(2, "preprocessed", 10, 500, parent=1, root=1),
        S(3, "host_inverse", 20, 120, parent=2, root=1),
        S(4, "host_inverse", 30, 60, parent=3, root=1),  # nested: counted once
        S(5, "lde", 130, 300, parent=2, root=1),
        S(6, "plan_record", 600, 700, parent=1, root=1),
        S(7, "host_inverse", 700, 750, parent=1, root=1),
    ]
    rec = {"cold_spans": spans}
    assert sp.cold_plans_s(rec) == 100e-9
    assert sp.cold_inverses_s(rec) == 150e-9
    assert sp.cold_preprocessed_s(rec) == 390e-9  # 490 less the inverse's 100


@pytest.mark.parametrize("name", sorted(sp.READERS))
def test_readers_read_nothing_without_spans(name):
    rec = {"jobs": [{"vm_adapter_s": 1.0, "phases": {}}], "cold_prove_s": 1.0}
    assert sp.READERS[name](rec) is None


def test_idle_gaps_by_span_midpoint_and_fallback():
    jobs = [job(0)]
    gaps = [
        (2, 6),      # vm
        (36, 40),    # the plan inside the dispatch
        (28, 34),    # midpoint 31: the dispatch's own time
        (55, 59),    # interaction's own time
        (68, 82),    # midpoint 75: pcs between its pulls
        (84, 88),    # the second pull
        (102, 108),  # after the proof: the harness's sync
        (200, 210),  # in no span at all
    ]
    by, where = sp.idle_by_span(gaps, jobs)
    assert by == {
        "vm": 4, "prove/interaction/dispatch/plan_record": 4,
        "prove/interaction/dispatch": 6, "prove/interaction": 4,
        "prove/pcs": 14, "prove/pcs/pull": 4, "prove:sync": 6, "harness": 10,
    }
    # pcs holds only pulls: its own time is a step's
    assert where == {"leaf": 12, "step": 14, "phase_self": 10, "harness": 16}


def test_idle_gaps_by_span_over_jobs_with_reused_ids():
    jobs = [job(0), job(1000)]
    by, _ = sp.idle_by_span([(62, 64), (1062, 1068), (1002, 1004)], jobs)
    assert by == {"prove/pcs/pull": 8, "vm": 2}
