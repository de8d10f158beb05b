"""Row-sharded proving of cairo_m_tpu_torch across torch.distributed ranks
(parallel/sharded.py, parallel/mesh.py), the segment workers' process
group, and colpack, on the CPU at test scale (set_test_scale(10, 8),
test_config(n_queries=8, pow_bits=2)).  The ranks are gloo subprocesses on
``device="cpu"``.

- fibonacci(40) proved at world sizes 2, 4 and 8: every rank's proof hashes
  to the reference's golden digest (tests/golden/fib40_proof_sha256.json,
  which tests/test_torch_prove_fib.py holds to the live reference proof, so
  the sharded proof is that proof byte for byte); at world size 2 both
  packages' verifiers accept it; at world size 8 the 16- and 32-point
  domains are below D^2 = 64 and every rank holds them whole;
- the stwo framing at world size 2, in rank processes that cannot import
  JAX or the reference, each of which proves single-device first (same
  process, same caches) and then sharded, to the same digest;
- the four column-sharded building blocks of parallel/mesh.py equal the
  reference's on a 4-device CPU mesh, bit for bit, at world size 4;
- `maybe_shard` is a no-op outside a mesh and on axes too small to split;
  a domain axis of the wrong length raises in the transforms, with a mesh
  or without; NCCL with two ranks on one card raises before any group
  exists, and rank r of four NCCL ranks runs on cuda:r; an exchange
  refuses a tensor off the mesh's device under either backend; a rank
  makes its card current before it joins the group;
- segment workers in one gloo group prove the reference's segment digests;
- colpack classifies real witnesses as the reference does and rebuilds
  them exactly.

Every multi-process job starts when the module does, three at a time (the
ranks are single-threaded and most of their time is each process's own
start-up and plan recording), and each test waits for its own.
"""

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from cairo_m_tpu_torch.parallel import sharded
from cairo_m_tpu_torch.parallel.segments import prove_segments_multiprocess
from cairo_m_tpu_torch.parallel.sharded import (
    RowMesh,
    maybe_shard,
    prove_sharded,
    prover_mesh,
    rank_devices,
)
from cairo_m_tpu_torch.prover import config as tcfg_mod
from torch_port_helpers import (
    FIB_SRC,
    SEGMENT_MAX_STEPS,
    both_at_test_scale,
    cross_verify,
    make_static_input,
    proof_sha256,
    reference_fib_input,
)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
TEST_SCALE = {"rc_big_bits": 10, "bitwise_log": 8}
P = (1 << 31) - 1


def _golden(name):
    with open(os.path.join(TESTS, "golden", name)) as f:
        return json.load(f)["sha256"]


def _digest(obj) -> str:
    import hashlib

    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def _cfg(framing="native"):
    return tcfg_mod.test_config(n_queries=8, pow_bits=2, framing=framing)


def _prove(world_size, **kw):
    records = []
    proof = prove_sharded(FIB_SRC, "main", [40], world_size=world_size,
                          backend="gloo", devices=["cpu"], config=_cfg(),
                          test_scale=TEST_SCALE, records=records, **kw)
    return proof, records


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every multi-process job of the module, started at once, three at a
    time: name -> future."""
    saved = os.environ.get("OMP_NUM_THREADS")
    # one intra-op thread per rank keeps the ranks from oversubscribing
    # the cores beside the other test workers
    os.environ["OMP_NUM_THREADS"] = "1"
    pool = ThreadPoolExecutor(max_workers=3)
    futures = {
        "ws2": pool.submit(_prove, 2),
        "segments": pool.submit(_segments),
        "ws4": pool.submit(_prove, 4),
        "ws8": pool.submit(_prove, 8),
        "stwo": pool.submit(_stwo_without_jax, tmp_path_factory.mktemp("stwo")),
        "blocks": pool.submit(_blocks_ranks, tmp_path_factory.mktemp("blocks")),
    }
    yield futures
    pool.shutdown(wait=True)
    if saved is None:
        del os.environ["OMP_NUM_THREADS"]
    else:
        os.environ["OMP_NUM_THREADS"] = saved


def test_world_size_2_matches_reference_and_cross_verifies(jobs):
    proof, records = jobs["ws2"].result()
    assert [_digest(r["proof"]) for r in records] == [
        _golden("fib40_proof_sha256.json")] * 2
    assert proof_sha256(proof) == _golden("fib40_proof_sha256.json")
    # the domains were split: the ranks exchanged data
    assert all(r["runs"][0]["exchange"]["bytes"] > 0 for r in records)
    with both_at_test_scale():
        cross_verify(proof, proof)


def test_world_size_4_matches_reference(jobs):
    proof, records = jobs["ws4"].result()
    assert [_digest(r["proof"]) for r in records] == [
        _golden("fib40_proof_sha256.json")] * 4
    assert [r["rank"] for r in records] == [0, 1, 2, 3]


def test_world_size_8_holds_small_domains_whole(jobs):
    """At world size 8 the 16-row components (32-point evaluation
    domains) are below D^2 = 64: every rank holds and proves them whole
    (redundant table counts, logup prefix sums and decommitments read from
    rank 0's copy) beside the split domains, and the proof is the same."""
    proof, records = jobs["ws8"].result()
    assert [_digest(r["proof"]) for r in records] == [
        _golden("fib40_proof_sha256.json")] * 8
    mesh = RowMesh(None, 3, 8, torch.device("cpu"), "gloo")
    with prover_mesh(mesh):
        assert not sharded.shards(16) and not sharded.shards(32)
        assert sharded.shards(64)


# a rank that first proves single-device in its own process, then runs the
# rank entry; neither JAX nor the reference package can be imported
_NO_JAX_RANK = """
import sys, json
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path.insert(0, {repo!r})
import torch
torch.set_num_threads(1)
from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.parallel import sharded
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.prover.config import set_test_scale
from cairo_m_tpu_torch.prover.prove import prove_cairo_m
argv = {argv!r}
wd = argv[argv.index("--workdir") + 1]
spec = json.load(open(wd + "/job.json"))
set_test_scale(**spec["test_scale"])
pi = native_prover_input(compile_cairo(spec["source"]).program, "main", spec["args"])
single = prove_cairo_m(pi, sharded.config_from_json(spec["config"]), device="cpu")
with open(wd + "/single_" + argv[argv.index("--rank") + 1] + ".json", "w") as f:
    json.dump(single.to_json_obj(), f)
sharded._rank_main(argv)
assert not any(m.split(".")[0] in ("jax", "cairo_m_tpu") for m, v in sys.modules.items() if v)
"""


def _run_ranks(script, world_size, argv_of, timeout=600):
    """Start one interpreter per rank running ``script`` (formatted with
    the rank's argv); raise unless every one exits with 0."""
    procs = [
        subprocess.Popen([sys.executable, "-c", script.format(repo=REPO, argv=argv_of(r))],
                         cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(world_size)
    ]
    outs = [p.communicate(timeout=timeout)[0] for p in procs]
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r}:\n{out}"


def _stwo_without_jax(tmp_path):
    with open(tmp_path / "job.json", "w") as f:
        json.dump({"source": FIB_SRC, "entrypoint": "main", "args": [40],
                   "max_steps": 1 << 32,
                   "config": sharded.config_to_json(_cfg("stwo")),
                   "test_scale": TEST_SCALE, "runs": 1}, f)
    init = "file://" + str(tmp_path / "store")
    _run_ranks(_NO_JAX_RANK, 2, lambda r: [
        "--rank", str(r), "--world-size", "2", "--backend", "gloo",
        "--init-method", init, "--device", "cpu", "--workdir", str(tmp_path)])
    proofs = []
    for r in range(2):
        for name in (f"single_{r}.json", f"rank_{r}.json"):
            with open(tmp_path / name) as f:
                obj = json.load(f)
            proofs.append(obj if name.startswith("single") else obj["proof"])
    return proofs


def test_stwo_world_size_2_without_jax_after_single_device(jobs):
    """The stwo framing (commit-order blocks gathered for the host trees),
    in rank interpreters that cannot import JAX or the reference package.
    Each rank proves single-device first: the preprocessed caches are keyed
    on the mesh, so the sharded proof after it reuses no whole-domain
    value."""
    digests = [_digest(p) for p in jobs["stwo"].result()]
    assert digests == [_golden("fib40_stwo_proof_sha256.json")] * 4


def test_maybe_shard_semantics():
    """Mirror of tests/test_sharded_prover.py::test_maybe_shard_places_on_mesh:
    a cyclic share under the mesh, the array itself outside it and where
    the axis is not a multiple of D^2."""
    mesh = RowMesh(None, 1, 2, torch.device("cpu"), "gloo")
    x = torch.arange(3 << 10).reshape(3, 1 << 10)
    with prover_mesh(mesh):
        y = maybe_shard(x)
        assert torch.equal(y, x[:, 1::2])
        odd = torch.zeros((3, 7))
        assert maybe_shard(odd) is odd
        small = torch.zeros((3, 2))  # 2 is not a multiple of D^2 = 4
        assert maybe_shard(small) is small
        z = np.arange(16)
        np.testing.assert_array_equal(maybe_shard(z), z[1::2])
    assert maybe_shard(x) is x


def _transforms():
    from cairo_m_tpu_torch.prover.stark import domain, fft

    tws = np.zeros((4, 4), np.uint32)
    return {
        "bit_reverse": lambda v: domain.bit_reverse(v, 4),
        "ifft": lambda v: fft.ifft(v, 4),
        "fft": lambda v: fft.fft(v, 4),
        "embed_coeffs": lambda v: fft.embed_coeffs(v, 4, 5),
        "eval_at_qpoint_folds": lambda v: fft.eval_at_qpoint_folds(v, 4, tws),
    }


@pytest.mark.parametrize("name", sorted(_transforms()))
def test_wrong_domain_length_raises(name):
    """A domain axis of 16 points given 8 (or 2) raises outside a mesh, as
    it does under a mesh of 2 ranks where 8 is the share and 2 is not."""
    f = _transforms()[name]
    f(torch.arange(16).reshape(1, 16))  # the whole axis
    with pytest.raises(ValueError, match="neither a domain of 16 points"):
        f(torch.arange(8).reshape(1, 8))
    with prover_mesh(RowMesh(None, 0, 2, torch.device("cpu"), "gloo")):
        assert sharded.is_share(torch.zeros((1, 8)), 4)
        assert not sharded.is_share(torch.zeros((1, 16)), 4)
        with pytest.raises(ValueError, match="neither a domain of 16 points"):
            f(torch.arange(2).reshape(1, 2))


def test_backend_rules_raise_before_any_group():
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one card"):
        rank_devices(2, "nccl", ["cuda:0"])
    with pytest.raises(ValueError, match="CUDA device per rank"):
        rank_devices(2, "nccl", ["cpu"])
    with pytest.raises(ValueError, match="power of two"):
        rank_devices(3, "gloo", ["cpu"])
    with pytest.raises(ValueError, match="use 'gloo' or 'nccl'"):
        rank_devices(2, "mpi", ["cpu"])
    with pytest.raises(ValueError, match="at most 64 ranks"):
        rank_devices(128, "gloo", ["cpu"])
    assert rank_devices(2, "nccl", ["cuda:0", "cuda:1"]) == [
        torch.device("cuda:0"), torch.device("cuda:1")]
    assert rank_devices(4, "gloo", ["cpu"]) == [torch.device("cpu")] * 4



@pytest.mark.parametrize("backend, mesh_device, tensor_device", [
    ("gloo", "cpu", "meta"),
    ("nccl", "cuda:1", "cpu"),
])
def test_staged_refuses_a_tensor_off_the_mesh_device(backend, mesh_device,
                                                     tensor_device):
    """Every exchange goes through `_staged`, which refuses an input that is
    not on the mesh's device under either backend, before any collective
    runs and before the exchange is counted."""
    mesh = RowMesh(None, 0, 2, torch.device(mesh_device), backend)
    x = torch.zeros(8, dtype=torch.int32, device=tensor_device)

    def collective(t):
        raise AssertionError("the collective must not run")

    with pytest.raises(ValueError, match=f"on {tensor_device}; the mesh's "
                       f"device is {mesh_device}"):
        sharded._staged(mesh, collective, x)
    assert mesh.n_exchanges == 0
    with prover_mesh(mesh), pytest.raises(ValueError, match="the mesh's device"):
        sharded.all_gather(x)


def test_rank_devices_one_card_a_rank(monkeypatch):
    """With no devices named, rank r of an NCCL mesh runs on cuda:r of a
    four-card machine; four NCCL ranks on two cards raise before any group
    exists (gloo may share the cards)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert rank_devices(4, "nccl") == [torch.device(f"cuda:{r}") for r in range(4)]
    assert rank_devices(2, "nccl") == [torch.device("cuda:0"), torch.device("cuda:1")]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match=r"4 ranks on cards \[0, 1, 0, 1\]"):
        rank_devices(4, "nccl")
    assert rank_devices(4, "gloo") == [torch.device(f"cuda:{r % 2}") for r in range(4)]


@pytest.mark.parametrize("backend, device, want", [
    ("nccl", None, "cuda:2"),
    ("nccl", "cuda:3", "cuda:3"),
    ("gloo", "cpu", "cpu"),
])
def test_make_row_mesh_makes_the_card_current_before_joining(
        monkeypatch, backend, device, want):
    """A rank's card is the current card before the process group exists,
    and an NCCL group is bound to it as it is made (no rank makes a context
    on card 0); a CPU rank touches no card."""
    calls = []
    joined = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(sharded.dist, "is_initialized", lambda: bool(joined))

    def init(backend, **kw):
        calls.append(("init", backend, str(kw["device_id"])))
        joined.append(True)

    monkeypatch.setattr(sharded.dist, "init_process_group", init)
    mesh = sharded.make_row_mesh(4, backend=backend, init_method="file:///unused",
                                 device=device, rank=2)
    assert (mesh.rank, mesh.world_size, mesh.backend) == (2, 4, backend)
    assert mesh.device == torch.device(want)
    card = [("set_device", want)] if want != "cpu" else []
    bound = want if backend == "nccl" else "None"
    assert calls == card + [("init", backend, bound)]


def test_make_row_mesh_refuses_nccl_off_a_card(monkeypatch):
    monkeypatch.setattr(sharded.dist, "is_initialized", lambda: False)
    with pytest.raises(ValueError, match="'nccl' needs a CUDA device, got cpu"):
        sharded.make_row_mesh(2, backend="nccl", init_method="file:///unused",
                              device="cpu", rank=0)


_BLOCKS_RANK = """
import sys
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path.insert(0, {repo!r})
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
from cairo_m_tpu_torch.parallel import mesh as pm
rank, ws, init, wd = {argv!r}
m = pm.make_mesh(ws, backend="gloo", init_method=init, device="cpu", rank=rank)
d = np.load(wd + "/in.npz")
t = lambda a: torch.from_numpy(a.astype(np.int64))
out = {{}}
out["psum"] = pm.psum_mod(t(d["psum"][rank]), m).numpy()
q = len(d["partials"]) // ws
out["logup"] = pm.sharded_logup_total(m)(t(d["partials"][rank * q:(rank + 1) * q])).numpy()
k = len(d["cols"]) // ws
cols = t(d["cols"][rank * k:(rank + 1) * k])
co, cm = pm.sharded_commit_pipeline(m, 6, 7)(cols)
out["coeffs"], out["commit"] = co.numpy(), cm.numpy()
cm2, check = pm.sharded_prove_step(m, 6, 7)(cols)
out["step_commit"], out["check"] = cm2.numpy(), check.numpy()
np.savez(wd + f"/out_{{rank}}.npz", **out)
dist.barrier()
dist.destroy_process_group()
"""


def _block_inputs():
    rng = np.random.default_rng(11)
    return {
        "psum": rng.integers(0, P, size=(4, 8), dtype=np.uint32),
        "partials": rng.integers(0, P, size=(16, 4), dtype=np.uint32),
        "cols": rng.integers(0, P, size=(8, 1 << 6), dtype=np.uint32),
    }


def _blocks_ranks(tmp_path, ws=4):
    np.savez(tmp_path / "in.npz", **_block_inputs())
    init = "file://" + str(tmp_path / "store")
    _run_ranks(_BLOCKS_RANK, ws, lambda r: (r, ws, init, str(tmp_path)))
    return [dict(np.load(tmp_path / f"out_{r}.npz")) for r in range(ws)]


def test_mesh_building_blocks_match_reference(jobs):
    """psum_mod, sharded_logup_total, sharded_commit_pipeline and
    sharded_prove_step at world size 4 vs the reference's make_mesh(4)
    versions on the CPU devices: the ranks' shares, gathered, bit for
    bit."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P_

    from cairo_m_tpu.parallel import mesh as rm

    ws = 4
    inputs = _block_inputs()
    mesh = rm.make_mesh(ws)
    want_psum = jax.shard_map(
        lambda x: rm.psum_mod(x[0], "cols"), mesh=mesh,
        in_specs=P_("cols", None), out_specs=P_(),
    )(jnp.asarray(inputs["psum"]))
    want_logup = rm.sharded_logup_total(mesh)(jnp.asarray(inputs["partials"]))
    want_co, want_cm = rm.sharded_commit_pipeline(mesh, 6, 7)(jnp.asarray(inputs["cols"]))
    want_step, want_check = rm.sharded_prove_step(mesh, 6, 7)(jnp.asarray(inputs["cols"]))
    outs = jobs["blocks"].result()
    for r in range(ws):
        np.testing.assert_array_equal(outs[r]["psum"], np.asarray(want_psum))
        np.testing.assert_array_equal(outs[r]["logup"], np.asarray(want_logup))
        np.testing.assert_array_equal(outs[r]["check"], np.asarray(want_check))
    cat = {key: np.concatenate([o[key] for o in outs]) for key in
           ("coeffs", "commit", "step_commit")}
    np.testing.assert_array_equal(cat["coeffs"], np.asarray(want_co))
    np.testing.assert_array_equal(cat["commit"], np.asarray(want_cm))
    np.testing.assert_array_equal(cat["step_commit"], np.asarray(want_step))


def _segments():
    return prove_segments_multiprocess(
        FIB_SRC, "main", [40], SEGMENT_MAX_STEPS, devices=["cpu", "cpu"],
        n_processes=2, test_scale=TEST_SCALE,
        test_config={"n_queries": 8, "pow_bits": 2}, use_torch_distributed=True,
    )


def test_segment_workers_in_one_process_group(jobs):
    records = jobs["segments"].result()
    assert [_digest(r["proof"]) for r in records] == _golden("fib40_segments_sha256.json")
    for a, b in zip(records, records[1:]):
        assert a["final_root"] == b["initial_root"]


def _witnesses(which):
    """(reference ComponentSet, port ComponentSet) with host-written traces
    of the same input."""
    from cairo_m_tpu.prover.adapter.adapter import import_from_runner_output as r_import
    from cairo_m_tpu.prover.components.registry import ComponentSet as RSet
    from cairo_m_tpu.prover.relations import Relations as RRel
    from cairo_m_tpu_torch.prover.adapter.adapter import (
        from_reference_prover_input,
        import_from_runner_output,
    )
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet
    from cairo_m_tpu_torch.prover.relations import Relations

    with both_at_test_scale():
        if which == "static":
            rpi = make_static_input(r_import)
            tpi = make_static_input(import_from_runner_output)
        else:
            rpi = reference_fib_input(40)
            tpi = from_reference_prover_input(rpi)
        rcs, tcs = RSet(RRel()), ComponentSet(Relations())
        rcs.write_traces(rpi)
        tcs.write_traces(tpi)
    return rcs, tcs


@pytest.mark.parametrize("which", ["static", "fib40"])
def test_colpack_matches_reference(which):
    from cairo_m_tpu.prover.stark import colpack as rcolpack
    from cairo_m_tpu_torch.prover.stark import colpack

    rcs, tcs = _witnesses(which)
    checked = 0
    for rc, tc in zip(rcs.all, tcs.all):
        assert rc.name == tc.name
        if tc.zero_witness or not tc.trace_rows:
            continue
        m = tc.non_padded_length
        rk, rbufs = rcolpack.classify(rc.trace_rows, m)
        tk, tbufs = colpack.classify(tc.trace_rows, m)
        assert tk == rk, tc.name
        for a, b in zip(tbufs, rbufs):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        got = colpack.upload_stack(tc.trace_rows, m, "cpu")
        want = np.stack([np.asarray(r, np.uint32) for r in tc.trace_rows])
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
        assert colpack.packed_bytes(tc.trace_rows, m) == rcolpack.packed_bytes(
            rc.trace_rows, m)
        checked += 1
    assert checked >= 3


@pytest.mark.slow
def test_sharded_production_scale_104k_bitexact():
    """Counterpart of test_sharded_production_scale_100k_bitexact:
    fibonacci(13000) = 104,010 cycles at the production protocol scale,
    world size 2 on gloo, byte-equal to the port's single-device proof, and
    verified."""
    from cairo_m_tpu_torch.compiler import compile_cairo
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m
    from cairo_m_tpu_torch.prover.verify import verify_cairo_m

    tcfg_mod.set_production_scale()
    cfg = _cfg()
    records = []
    proof = prove_sharded(FIB_SRC, "main", [13000], world_size=2, backend="gloo",
                          devices=["cpu"], config=cfg, records=records,
                          timeout=3600)
    assert records[0]["n_steps"] == 104_010
    pi = native_prover_input(compile_cairo(FIB_SRC).program, "main", [13000])
    single = prove_cairo_m(pi, cfg, device="cpu")
    assert proof_sha256(proof) == proof_sha256(single)
    assert verify_cairo_m(proof, cfg, device="cpu")
