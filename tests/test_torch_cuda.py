"""The port's CUDA kernels against their plain torch versions on the card,
bit for bit, and a test-scale proof on the card against the same proof on
the CPU; on a machine of two cards or more, both kernels on every card and
fib-40 on two NCCL ranks, one card each.  Every test needs a CUDA device
(marker ``cuda``) and skips without one (the multi-card tests below two
cards).  The file imports neither JAX nor the JAX package, so it also
runs on a machine that has none:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from cairo_m_tpu_torch import kernels
from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.hash import blake2s, poseidon2_params
from cairo_m_tpu_torch.parallel.sharded import prove_sharded
from cairo_m_tpu_torch.prover import config
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.components import generic
from cairo_m_tpu_torch.prover.components.registry import ComponentSet
from cairo_m_tpu_torch.prover.prove import prove_cairo_m
from cairo_m_tpu_torch.prover.relations import Relations
from cairo_m_tpu_torch.prover.stark import fft, framework, merkle, wtape
from cairo_m_tpu_torch.prover.stark.air import logup_shift_scalar
from torch_port_helpers import (FIB_SRC, P, constant_free_plan, proof_json,
                                random_wide_plan, wide_sum_plan)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def cards(cuda_device):
    """Every visible card, where there are two or more."""
    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip(f"needs two CUDA cards or more, {count} visible")
    return [torch.device("cuda", k) for k in range(count)]


@pytest.fixture(scope="module")
def fib40(cuda_device):
    """(test-scale prover input, relations, components) of fibonacci(40),
    with relation parameters from a fixed stand-in channel."""

    class _Channel:
        i = 0

        def draw_felt(self):
            self.i += 1
            return (self.i * 12345 % P, self.i, 7, 11)

    config.set_test_scale(10, 8)
    try:
        pi = native_prover_input(compile_cairo(FIB_SRC).program, "main", [40])
        relations = Relations()
        comps = ComponentSet(relations)
        comps.write_traces(pi)
        relations.draw(_Channel())
        yield pi, relations, comps
    finally:
        config.set_production_scale()


@pytest.mark.parametrize(
    "K,n", [(1, 32), (4, 1 << 12), (16, 1 << 16), (17, 1 << 10), (512, 1 << 8),
            (1024, 32), (2048, 32)]
)
def test_blake2s_kernel_matches_plain(cuda_device, K, n):
    rng = np.random.default_rng(K)
    cols = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(K, n), dtype=np.int64)
    ).to(cuda_device)
    before = kernels.launches["blake2s_leaves"]
    got = blake2s.hash_leaves(cols)
    assert kernels.launches["blake2s_leaves"] == before + 1
    want = torch.stack(blake2s.hash_words(list(cols)))
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_blake2s_kernel_writes_into_a_strided_out_view(cuda_device):
    rng = np.random.default_rng(9)
    cols = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(20, 1000), dtype=np.int64)
    ).to(cuda_device)
    packed = torch.full((8, 1999), -1, dtype=torch.int64, device=cuda_device)
    blake2s.hash_leaves(cols, 32, out=packed[:, :1000])
    torch.cuda.synchronize()
    assert torch.equal(packed[:, :1000], blake2s.hash_leaves(cols.cpu(), 32).to(cuda_device))
    assert bool((packed[:, 1000:] == -1).all())


@pytest.mark.parametrize("tile", [None, 9, 11])
@pytest.mark.parametrize("m", [2, 1 << 9, 1 << 10, 1 << 15, 1 << 19])
def test_pyramid_kernel_matches_plain(cuda_device, m, tile):
    """One launch per tile of levels; every level bit for bit."""
    rng = np.random.default_rng(m)
    packed = torch.zeros((8, 2 * m - 1), dtype=torch.int64, device=cuda_device)
    packed[:, :m] = torch.from_numpy(
        rng.integers(0, 1 << 32, size=(8, m), dtype=np.int64)
    ).to(cuda_device)
    want = blake2s.merkle_pyramid_plain(packed.clone())
    before = dict(kernels.launches)
    got = blake2s.merkle_pyramid(packed, tile)
    torch.cuda.synchronize()
    assert got is packed
    n_launches = blake2s.pyramid_launches(m, tile)
    assert kernels.launches["blake2s_pyramid"] == before["blake2s_pyramid"] + n_launches
    assert sum(kernels.launches.values()) == sum(before.values()) + n_launches
    assert torch.equal(got, want)


@pytest.mark.parametrize("n_cols,log", [(3, 12), (16, 5), (453, 10), (2, 16)])
def test_merkle_tree_on_the_card_equals_cpu_tree(cuda_device, n_cols, log):
    rng = np.random.default_rng(n_cols + log)
    cols = torch.from_numpy(rng.integers(0, P, size=(n_cols, 1 << log), dtype=np.int64))
    positions = rng.integers(0, 1 << log, size=13).tolist()
    before = dict(kernels.launches)
    trees = [merkle.MerkleTree(c) for c in (cols.to(cuda_device), cols)]
    assert kernels.launches["blake2s_leaves"] == before["blake2s_leaves"] + 1
    assert kernels.launches["blake2s_pyramid"] == before[
        "blake2s_pyramid"] + blake2s.pyramid_launches(1 << log)
    assert trees[0].root() == trees[1].root()
    assert torch.equal(trees[0].packed.cpu(), trees[1].packed)
    decs = [merkle.finish_plans([merkle.DecommitPlan(t, positions)])[0] for t in trees]
    assert decs[0].to_json_obj() == decs[1].to_json_obj()
    assert merkle.verify_decommitment(trees[0].root(), log, n_cols, positions, decs[0])


@pytest.mark.parametrize("kind", ["interaction", "composition"])
@pytest.mark.parametrize("name", ["store_add_fp_fp", "poseidon2", "range_check_8"])
def test_wtape_kernel_matches_plain(fib40, cuda_device, kind, name):
    _, relations, comps = fib40
    comp = next(c for c in comps.all if c.name == name)
    if kind == "interaction":
        plan, _ = framework.interaction_plan(comp, relations)
        elog = comp.log_size
        consts = plan.const_values(framework._DynResolver(relations))
    else:
        plan = framework.composition_plan(comp, relations)
        elog = comp.log_size + 1
        apows = [(1, 0, 0, 0)] + [(3 + i, 1, 4, 1) for i in range(600)]
        consts = plan.const_values(framework._DynResolver(
            relations, shift=logup_shift_scalar((1, 2, 3, 4), comp.log_size),
            apows=apows))
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(
        rng.integers(0, P, size=(len(plan.used_bank), 1 << elog), dtype=np.int64)
    ).to(cuda_device)
    before = kernels.launches["wtape_run_plan"]
    got = wtape.run_plan(rows, consts, plan)
    assert kernels.launches["wtape_run_plan"] > before
    want = wtape.run_plan(rows.cpu(), consts, plan)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)


def _random_rows(plan, n, seed, device):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(
        rng.integers(0, P, size=(len(plan.used_bank), n), dtype=np.int64)
    ).to(device)


def _point(rng):
    return tuple(tuple(int(v) for v in rng.integers(0, P, 4)) for _ in range(2))


@pytest.mark.parametrize("seed, logs", [
    (0, [1, 4, 5, 6, 11]), (1, [12, 13, 16]), (2, [3, 4, 9, 12, 20])])
def test_point_eval_kernel_matches_plain(cuda_device, seed, logs):
    """One launch for a table of stacks of every tiling (columns shorter
    than a warp, whole columns a warp, segments of long ones), k from 1 to
    over a thousand, one to three points a stack, points shared between
    stacks: bit for bit the plain folds' values."""
    rng = np.random.default_rng(seed)
    points = [_point(rng) for _ in range(3)]
    jobs = []
    for log in logs:
        k = int(rng.choice([1, 3, 100, 1392])) if log < 14 else 2
        pts = [points[i] for i in rng.permutation(3)[: 1 + log % 3]]
        jobs.append((torch.from_numpy(rng.integers(0, P, size=(k, 1 << log),
                                                   dtype=np.int64)).to(cuda_device),
                     log, pts))
    before = kernels.launches["point_eval"]
    got = fft.eval_at_points(jobs)
    torch.cuda.synchronize()
    assert kernels.launches["point_eval"] == before + 1
    want = fft.eval_at_points([(c.cpu(), log, pts) for c, log, pts in jobs])
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("log, n", [(10, 1000), (20, 1 << 20), (20, 1_000_003)])
def test_poseidon2_witness_kernel_matches_plain(cuda_device, log, n):
    """``csrc/poseidon2.cu``: the poseidon2 component's 443 columns of
    2^log rows from n random input states (the rest padding: the zero
    state, enabler 0), in one launch, bit for bit the plain torch rounds'
    on the card."""
    rng = np.random.default_rng(log + n)
    states = torch.from_numpy(
        rng.integers(0, P, size=(n, 16), dtype=np.int64).astype(np.int32)
    ).to(cuda_device)
    params = poseidon2_params.active_params()
    before = kernels.launches["poseidon2_witness"]
    got = generic.poseidon2_witness(states, 1 << log, params)
    torch.cuda.synchronize()
    assert kernels.launches["poseidon2_witness"] == before + 1
    assert got.shape == (443, 1 << log) and got.dtype == torch.int64
    want = generic.poseidon2_witness_plain(states, 1 << log, params)
    for c in range(443):
        assert torch.equal(got[c], want[c]), f"column {c}"


@pytest.mark.parametrize("variant", ["smem", "global"])
@pytest.mark.parametrize("seed, n", [(0, 1 << 12), (1, 16), (2, 1000), (3, 1 << 15)])
def test_wtape_variants_match_plain_on_random_plans(cuda_device, seed, n, variant):
    """The shared-memory kernel and the global-scratch kernel, each forced,
    on random plans; ``n`` also below a warp and not a power of two."""
    plan, consts = random_wide_plan(seed)
    rows = _random_rows(plan, n, seed, cuda_device)
    name = "wtape_run_plan" if variant == "smem" else "wtape_run_plan_global"
    before = dict(kernels.launches)
    got = wtape.run_plan(rows, consts, plan, variant=variant)
    torch.cuda.synchronize()
    assert kernels.launches[name] == before[name] + 1
    assert sum(kernels.launches.values()) == sum(before.values()) + 1
    assert torch.equal(got.cpu(), wtape.run_plan(rows.cpu(), consts, plan))


def test_wtape_rule_sends_a_large_file_to_the_global_kernel(cuda_device):
    """More registers than shared memory holds: the rule, not a failed
    launch, picks the global-scratch kernel."""
    plan, consts = wide_sum_plan(2000)
    assert wtape.pick_lanes(wtape.kernel_program(plan).n_regs, 256) is None
    rows = _random_rows(plan, 256, 5, cuda_device)
    before = dict(kernels.launches)
    got = wtape.run_plan(rows, consts, plan)
    torch.cuda.synchronize()
    assert kernels.launches["wtape_run_plan_global"] == before["wtape_run_plan_global"] + 1
    assert kernels.launches["wtape_run_plan"] == before["wtape_run_plan"]
    assert torch.equal(got.cpu(), wtape.run_plan(rows.cpu(), consts, plan))
    with pytest.raises(ValueError, match="do not fit"):
        wtape.run_plan(rows, consts, plan, variant="smem")


@pytest.mark.parametrize("variant", ["smem64", "smem32", "global"])
def test_wtape_plan_without_constants(cuda_device, variant):
    """A plan that uses no constant, on an empty constant vector (a null
    pointer on the card): neither kernel looks a constant up, the fill of
    the short bundles included."""
    plan, consts = constant_free_plan()
    rows = _random_rows(plan, 3000, 11, cuda_device)
    empty = torch.zeros(0, dtype=torch.int64, device=cuda_device)
    assert empty.data_ptr() == 0
    if variant == "global":
        got = wtape._run_plan_global(rows, empty, plan)
    else:
        prog = wtape.kernel_program(plan)
        assert prog.n_fill > 0
        got = wtape._run_plan_smem(rows, empty, plan, prog, int(variant[4:]))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), wtape.run_plan(rows.cpu(), consts, plan))


@pytest.mark.parametrize("lanes", wtape._LANE_CHOICES)
def test_wtape_every_block_size_matches_plain(cuda_device, lanes):
    plan, consts = random_wide_plan(7)
    rows = _random_rows(plan, 5000, 7, cuda_device)
    cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(cuda_device)
    got = wtape._run_plan_smem(rows, cdev, plan, wtape.kernel_program(plan), lanes)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), wtape.run_plan(rows.cpu(), consts, plan))


@pytest.mark.parametrize("framing", ["native", "stwo"])
def test_cuda_proof_equals_cpu_proof(fib40, framing):
    pi, _, _ = fib40
    cfg = config.test_config(n_queries=8, pow_bits=2, framing=framing)
    kernels.reset_launches()
    cuda_proof = prove_cairo_m(pi, cfg, device="cuda")
    # the stwo trees are hashed on the host: only the wide-tape kernel runs
    used = ["wtape_run_plan"] + (
        ["blake2s_leaves", "blake2s_pyramid"] if framing == "native" else [])
    assert all(kernels.launches[k] > 0 for k in used), kernels.launches
    # every plan of the prover fits the shared-memory kernel
    assert kernels.launches["wtape_run_plan_global"] == 0
    assert proof_json(cuda_proof) == proof_json(prove_cairo_m(pi, cfg, device="cpu"))


def test_kernels_match_plain_on_every_card(cards):
    """Each kernel on tensors of card k, launched while the current card is
    cuda:0: it runs on card k (on that card's current stream), leaves the
    current card as it was, and agrees with the plain version bit for
    bit."""
    plan, consts = random_wide_plan(3)
    rng = np.random.default_rng(5)
    cols = rng.integers(0, 1 << 32, size=(16, 1 << 12), dtype=np.int64)
    leaves = rng.integers(0, 1 << 32, size=(8, 1 << 10), dtype=np.int64)
    rows = rng.integers(0, P, size=(len(plan.used_bank), 3000), dtype=np.int64)
    packed = torch.zeros((8, 2 * leaves.shape[1] - 1), dtype=torch.int64)
    packed[:, : leaves.shape[1]] = torch.from_numpy(leaves)
    want = {
        "blake2s_leaves": blake2s.hash_leaves(torch.from_numpy(cols)),
        "blake2s_pyramid": blake2s.merkle_pyramid_plain(packed.clone()),
        "wtape": wtape.run_plan(torch.from_numpy(rows), consts, plan),
    }
    torch.cuda.set_device(0)
    for card in cards:
        before = dict(kernels.launches)
        got = {
            "blake2s_leaves": blake2s.hash_leaves(torch.from_numpy(cols).to(card)),
            "blake2s_pyramid": blake2s.merkle_pyramid(packed.to(card)),
        }
        rows_k = torch.from_numpy(rows).to(card)
        for variant in ("smem", "global"):
            got[variant] = wtape.run_plan(rows_k, consts, plan, variant=variant)
        assert torch.cuda.current_device() == 0
        assert {str(t.device) for t in got.values()} == {str(card)}
        torch.cuda.synchronize(card)
        for name, t in got.items():
            assert torch.equal(t.cpu(), want.get(name, want["wtape"])), (card, name)
        assert {k: kernels.launches[k] - before[k] for k in before} == {
            "blake2s_leaves": 1,
            "blake2s_pyramid": blake2s.pyramid_launches(leaves.shape[1]),
            "wtape_run_plan": 1, "wtape_run_plan_global": 1, "point_eval": 0}


def test_fib40_on_two_nccl_ranks_matches_reference(cards):
    """fib-40 at test scale row-sharded over two NCCL ranks, one card each:
    every rank's proof is the reference's (tests/golden/fib40_proof_sha256.json)."""
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                          "fib40_proof_sha256.json")
    with open(golden) as f:
        want = json.load(f)["sha256"]
    records = []
    proof = prove_sharded(
        FIB_SRC, "main", [40], world_size=2, backend="nccl",
        devices=[str(c) for c in cards[:2]],
        config=config.test_config(n_queries=8, pow_bits=2),
        test_scale={"rc_big_bits": 10, "bitwise_log": 8}, records=records,
        timeout=600)
    digests = [hashlib.sha256(json.dumps(r["proof"], sort_keys=True).encode())
               .hexdigest() for r in records]
    assert digests == [want, want]
    assert proof_json(proof) == json.dumps(records[0]["proof"], sort_keys=True)
    assert [r["device"] for r in records] == ["cuda:0", "cuda:1"]
    # the ranks exchanged over NCCL and launched the kernels on their cards
    for r in records:
        run = r["runs"][0]
        assert run["exchange"]["exchanges"] > 0
        assert all(run["launches"][k] > 0 for k in
                   ("blake2s_leaves", "blake2s_pyramid", "wtape_run_plan"))
