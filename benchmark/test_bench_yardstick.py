"""The rooflines' work, counted from a test-scale proof's shape, against
counts made another way: kernel A's trees against the trees the proof
opens, kernel B's bytes against the port's own column counts."""

import pytest

from benchmark import yardstick as Y
from benchmark.conftest import SMALL_SCALE, SMALL_SECURITY
from benchmark.reference.components.registry import ComponentSet
from benchmark.reference.relations import Relations
from benchmark.reference.scale import protocol_scale


def _comps(obj):
    comps = ComponentSet(Relations()).all
    for c, l in zip(comps, obj["log_sizes"]):
        c.log_size = l
    return comps


def test_kernel_a_trees_are_the_proofs_trees(small_proof):
    obj = small_proof[0]
    pcs = obj["pcs_proof"]
    opened = []
    for phase in (1, 2, 3):
        for cl, dec in sorted(pcs["decommitments"][phase].items(), key=lambda kv: int(kv[0])):
            opened.append((int(cl), len(dec["values"])))
    last = SMALL_SECURITY["log_blowup"] + SMALL_SECURITY["log_last_layer_degree_bound"]
    max_log = max(l for l, _ in opened)
    opened += [(max_log - 1 - i, len(d["values"]))
               for i, d in enumerate(pcs["fri_proof"]["inner_decommitments"])]
    with protocol_scale(**SMALL_SCALE):
        trees = Y.proof_trees(_comps(obj), obj["log_sizes"], 1, last)
    key = lambda t: (t[0], t[1])  # noqa: E731
    assert sorted(trees, key=key) == sorted(opened, key=key)


def test_tree_seconds_by_hand():
    # 2^20 leaves of 12 columns: one block a leaf (16 words padded)
    n = 1 << 20
    ops = (n + n - 1) * 648 / Y.INT32_OPS_PER_S
    leaf_bytes = n * (12 * 4 + 32) / Y.HBM_BYTES_PER_S
    assert leaf_bytes < n * 648 / Y.INT32_OPS_PER_S
    assert Y.tree_seconds(20, 12) == pytest.approx(ops)
    # 33 columns pad to 64 words: four blocks a leaf
    assert Y.tree_seconds(4, 33) == pytest.approx(
        max(16 * 4 * 648 / Y.INT32_OPS_PER_S, 16 * (33 * 4 + 32) / Y.HBM_BYTES_PER_S)
        + max(15 * 648 / Y.INT32_OPS_PER_S, 15 * 32 / Y.HBM_BYTES_PER_S))
    assert Y.INT32_OPS_PER_S == pytest.approx(16.727e12, rel=1e-4)


def test_kernel_b_bytes_against_the_ports_counts(small_proof):
    from cairo_m_tpu_torch.prover import config as pc
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet as PortSet
    from cairo_m_tpu_torch.prover.relations import Relations as PortRelations

    obj = small_proof[0]
    pc.set_test_scale(**SMALL_SCALE)
    try:
        port = PortSet(PortRelations()).all
        want = 0
        for c, l, s in zip(port, obj["log_sizes"], obj["claimed_sums"]):
            if any(s):
                t, i = c.n_trace_cols, 4 * c.n_interaction_cols()
                want += 4 * ((t + i) * 2**l + (t + i + 4) * 2**(l + 1))
    finally:
        pc.set_production_scale()
    with protocol_scale(**SMALL_SCALE):
        got = Y.kernel_b_bytes(_comps(obj), obj["log_sizes"], obj["claimed_sums"], 1)
    assert got == want > 0
