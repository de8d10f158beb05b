"""BLAKE2s leaf hashing and Merkle trees of cairo_m_tpu_torch vs the JAX
reference: the plain torch leaf hash against the Pallas leaf kernel (run in
interpreter mode, as tests/test_pallas.py runs it) and the hashlib golden
path; the plain packed pyramid against the reference's level-by-level
route; roots and decommitments against prover/stark/merkle.py.  Everything
is exact uint32 arithmetic: the tolerance is zero.  The CUDA kernels are
held to the plain versions in tests/test_torch_cuda.py."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cairo_m_tpu.hash import blake2s_pallas
from cairo_m_tpu.hash.blake2s import hash_words_np
from cairo_m_tpu.prover.stark import merkle as rmerkle
from cairo_m_tpu_torch import kernels
from cairo_m_tpu_torch.hash import blake2s
from cairo_m_tpu_torch.prover.stark import merkle
from torch_port_helpers import P, to_np, to_t


@pytest.fixture()
def interpret_mode():
    """Pallas interpreter mode for one test only (the flags are module
    globals of the reference; see tests/test_pallas.py `_interpret_mode`)."""
    saved = blake2s_pallas._INTERPRET
    blake2s_pallas._INTERPRET = True
    blake2s_pallas._leaf_call.cache_clear()
    yield
    blake2s_pallas._INTERPRET = saved
    blake2s_pallas._leaf_call.cache_clear()


@pytest.mark.parametrize("K,n", [(1, 128), (4, 128), (17, 128)])
def test_plain_leaf_hash_matches_pallas_kernel(interpret_mode, K, n):
    rng = np.random.default_rng(42 + K)
    cols = rng.integers(0, 1 << 32, size=(K, n), dtype=np.uint32)
    want = np.asarray(blake2s_pallas.hash_leaves(jnp.asarray(cols)))
    got = blake2s.hash_leaves(to_t(cols))
    np.testing.assert_array_equal(to_np(got), want)
    np.testing.assert_array_equal(to_np(got).T, hash_words_np(list(cols)))


@pytest.mark.parametrize("K", [1, 15, 16, 33, 70])
def test_plain_leaf_hash_matches_hashlib(K):
    rng = np.random.default_rng(K)
    cols = rng.integers(0, 1 << 32, size=(K, 9), dtype=np.uint32)
    got = blake2s.hash_leaves(to_t(cols))
    np.testing.assert_array_equal(to_np(got).T, hash_words_np(list(cols)))
    # zero-padded message length == explicit zero rows
    padded = np.concatenate([cols, np.zeros((3, 9), np.uint32)])
    np.testing.assert_array_equal(
        to_np(blake2s.hash_leaves(to_t(cols), K + 3)),
        to_np(blake2s.hash_leaves(to_t(padded))),
    )


def test_wrapper_rejects_bad_input():
    with pytest.raises(ValueError):
        blake2s.hash_leaves(torch.zeros((4, 8), dtype=torch.int32))
    with pytest.raises(ValueError):
        blake2s.hash_leaves(torch.zeros((8, 4), dtype=torch.int64).T)
    with pytest.raises(ValueError):
        blake2s.hash_leaves(torch.zeros((4, 8), dtype=torch.int64), 2)


def test_leaf_hash_writes_into_a_strided_out_view():
    rng = np.random.default_rng(8)
    cols = to_t(rng.integers(0, 1 << 32, size=(5, 16), dtype=np.uint32))
    packed = torch.full((8, 31), -1, dtype=torch.int64)
    got = blake2s.hash_leaves(cols, 8, out=packed[:, :16])
    assert got.data_ptr() == packed.data_ptr()
    assert torch.equal(packed[:, :16], blake2s.hash_leaves(cols, 8))
    assert bool((packed[:, 16:] == -1).all())


@pytest.mark.parametrize(
    "out",
    [
        torch.zeros((8, 15), dtype=torch.int64),  # wrong shape
        torch.zeros((7, 16), dtype=torch.int64),
        torch.zeros((8, 16), dtype=torch.int32),  # wrong dtype
        torch.zeros((8, 16), dtype=torch.int64, device="meta"),  # wrong device
        torch.zeros((16, 8), dtype=torch.int64).T,  # rows not contiguous
    ],
    ids=["columns", "rows", "dtype", "device", "stride"],
)
def test_leaf_hash_rejects_bad_out(out):
    with pytest.raises(ValueError, match="out must be"):
        blake2s.hash_leaves(torch.zeros((4, 16), dtype=torch.int64), out=out)


@pytest.mark.parametrize("m", [2, 8, 1 << 9, 1 << 10, 1 << 11, 1 << 13])
def test_plain_pyramid_matches_reference_levels(interpret_mode, m):
    """The packed pyramid against the reference's route: one
    `_hash_inner_fast` per level (the Pallas kernel, interpreted, where its
    gate lets a level in; `_hash_inner` below that)."""
    rng = np.random.default_rng(m)
    leaves = rng.integers(0, 1 << 32, size=(8, m), dtype=np.uint32)
    packed = torch.zeros((8, 2 * m - 1), dtype=torch.int64)
    packed[:, :m] = to_t(leaves)
    assert blake2s.merkle_pyramid(packed) is packed  # CPU: the plain version
    level, off = jnp.asarray(leaves), 0
    while level.shape[1] > 1:
        off += level.shape[1]
        level = rmerkle._hash_inner_fast(level)
        np.testing.assert_array_equal(
            to_np(packed[:, off : off + level.shape[1]]), np.asarray(level)
        )
    assert off + 1 == 2 * m - 1
    np.testing.assert_array_equal(to_np(packed[:, :m]), leaves)


@pytest.mark.parametrize(
    "shape,dtype", [((8, 6), torch.int64), ((8, 8), torch.int64),
                    ((7, 7), torch.int64), ((8, 7), torch.int32), ((8,), torch.int64)]
)
def test_pyramid_rejects_bad_input(shape, dtype):
    with pytest.raises(ValueError):
        blake2s.merkle_pyramid(torch.zeros(shape, dtype=dtype))
    with pytest.raises(ValueError):
        blake2s.merkle_pyramid_plain(torch.zeros(shape, dtype=dtype))


def test_pyramid_rejects_a_view_and_takes_a_single_leaf():
    with pytest.raises(ValueError, match="contiguous"):
        blake2s.merkle_pyramid(torch.zeros((8, 14), dtype=torch.int64)[:, :7])
    one = torch.arange(8, dtype=torch.int64)[:, None].clone()
    assert torch.equal(blake2s.merkle_pyramid(one.clone()), one)


def _old_route_flat(tree, positions):
    """`DecommitPlan.flat` as it was built before the pyramid was packed:
    the opened values, then one gather from a concatenation of the levels
    below the host-mirrored ones."""
    pos = torch.tensor(sorted(positions), dtype=torch.int64)
    parts = [tree.columns.index_select(1, pos).reshape(-1)]
    cur, sib_idx, level_off = sorted(positions), [], 0
    for lvl in range(tree.host_base):
        sib_idx += [level_off + (p ^ 1) for p in cur if (p ^ 1) not in set(cur)]
        level_off += int(tree.levels[lvl].shape[1])
        cur = sorted({p >> 1 for p in cur})
    if sib_idx:
        cat = torch.cat(tree.levels[: tree.host_base], dim=1)
        parts.append(cat.index_select(1, torch.tensor(sib_idx)).T.reshape(-1))
    return torch.cat(parts)


@pytest.mark.parametrize("n_cols,log", [(2, 13), (3, 12), (4, 10), (1, 4)])
def test_tree_is_one_packed_tensor(n_cols, log):
    rng = np.random.default_rng(log)
    n = 1 << log
    cols = rng.integers(0, P, size=(n_cols, n), dtype=np.uint32)
    tree = merkle.MerkleTree(to_t(cols))
    assert tuple(tree.packed.shape) == (8, 2 * n - 1)
    assert len(tree.levels) == log + 1
    base = tree.packed.data_ptr()
    for lvl, level in enumerate(tree.levels):  # views, not copies
        assert tuple(level.shape) == (8, n >> lvl)
        assert level.data_ptr() == base + 8 * blake2s.pyramid_offset(n, lvl)
    assert tree.host_base == max(log - merkle._HOST_TOP_LOG, 0)
    # the host mirror is a copy of the device levels, which equal what the
    # host's own hashing of the first mirrored level gives
    assert len(tree.host_chain) == log + 1 - tree.host_base
    for level, mirror in zip(tree.levels[tree.host_base :], tree.host_chain):
        np.testing.assert_array_equal(to_np(level).T, mirror)
    hashed = merkle._host_inner_levels(tree.host_chain[0])
    for got, want in zip(tree.host_chain[1:], hashed, strict=True):
        np.testing.assert_array_equal(got, want)
    assert tree.root() == tree.host_chain[-1][0].astype("<u4").tobytes()
    positions = set(rng.integers(0, n, size=9).tolist())
    plan = merkle.DecommitPlan(tree, positions)
    assert torch.equal(plan.flat, _old_route_flat(tree, positions))
    # a deferred top gives the same tree
    late = merkle.MerkleTree(to_t(cols), defer_top=True)
    assert late.root() is None and late.host_chain is None
    late.finish_host(late.top_dev.numpy())
    assert late.root() == tree.root()


@pytest.mark.parametrize(
    "n_cols,log", [(3, 12), (16, 5), (1, 11), (5, 9), (2, 10), (6, 3)]
)
def test_merkle_roots_and_decommitments_match_reference(n_cols, log):
    rng = np.random.default_rng(n_cols * 100 + log)
    cols = rng.integers(0, P, size=(n_cols, 1 << log), dtype=np.uint32)
    rtree = rmerkle.MerkleTree(jnp.asarray(cols))
    ttree = merkle.MerkleTree(to_t(cols))
    assert ttree.root() == rtree.root()
    for got, want in zip(ttree.levels, rtree.levels):
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
    positions = sorted(set(rng.integers(0, 1 << log, size=11).tolist()))
    pairs = sorted({q for p in positions for q in (p & ~1, p | 1)})
    (tdec,) = merkle.finish_plans([merkle.DecommitPlan(ttree, pairs)])
    rdec = rmerkle.decommit(rtree, pairs)
    assert tdec.to_json_obj() == rdec.to_json_obj()
    assert merkle.verify_decommitment(ttree.root(), log, n_cols, pairs, tdec)
    assert rmerkle.verify_decommitment(rtree.root(), log, n_cols, pairs, tdec)


def test_host_merkle_tree_matches_reference():
    rng = np.random.default_rng(3)
    cols = rng.integers(0, P, size=(4, 256), dtype=np.uint32)
    ttree = merkle.MerkleTree(cols)
    assert ttree.root() == rmerkle.MerkleTree(cols).root()
    pairs = [4, 5, 200, 201]
    (tdec,) = merkle.finish_plans([merkle.DecommitPlan(ttree, pairs)])
    (rdec,) = rmerkle.finish_plans(
        [rmerkle.DecommitPlan(rmerkle.MerkleTree(cols), pairs)]
    )
    assert tdec.to_json_obj() == rdec.to_json_obj()



def test_kernel_library_is_named_by_sources_and_headers(tmp_path, monkeypatch):
    """An edited header must not load a library built from the old one."""
    for name in ("a.cu", "shared.cuh", "notes.txt"):
        (tmp_path / name).write_text("// " + name)
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    assert [p.rsplit("/", 1)[1] for p in kernels._sources()] == ["a.cu"]
    before = kernels.library_path()
    (tmp_path / "notes.txt").write_text("changed")
    assert kernels.library_path() == before
    (tmp_path / "shared.cuh").write_text("// changed")
    assert kernels.library_path() != before
