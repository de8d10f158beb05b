"""Smoke test of the PyTorch/CUDA prover (cairo_m_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # phases 1-3, the wide-tape kernel's
                                     # time on every plan at both block sizes
                                     # and the pyramid kernel's on every
                                     # tree at both tile sizes

Phases (each raises on failure, so the script exits non-zero):

1. require a CUDA device; print the card's name and power limit; build the
   CUDA kernels from ``cairo_m_tpu_torch/csrc`` and time the build;
2. BLAKE2s leaf kernel vs its plain torch version on the card, bit for bit,
   at the Merkle shapes of the main path, plus a few lanes vs ``hashlib``;
   timed beside its bound at the shapes of PERF.md's kernel table.  BLAKE2s
   pyramid kernel vs its plain version on the card, bit for bit, for every
   tree of 2^1 .. 2^22 leaves, and vs the level-by-level route it replaced
   (one leaf-kernel launch over a copied message stack per level), which is
   timed beside it; one root vs ``hashlib``; whole Merkle trees built on the
   card vs on the CPU (root and decommitment); the host's seconds for
   hashing one tree top with NumPy, which the prover no longer does;
3. wide-tape kernels vs the plain torch version on the card, bit for bit,
   on every plan of the fibonacci-100k witness (interaction, table count and
   composition of each live component): the shared-memory kernel, which the
   rule must pick for each, and the global-scratch kernel, forced; the
   table's plans are timed beside their bounds; a synthetic plan whose
   register file is beyond shared memory must go to the global-scratch
   kernel by the rule and agree with plain;
4. at test scale, fib-40 proved on the card and on the CPU (plain
   versions): the two proofs' JSON must be byte-equal and match the
   committed reference digest ``tests/golden/fib40_proof_sha256.json``;
5. the main path at full size: compile fibonacci, run the native VM +
   adapter for 100,000 iterations (800,010 cycles), prove twice at
   ``REGULAR_96_BITS`` (production tables) and verify, without naming a
   device (the card is the default); all three kernels must have launched
   during that run, a tree takes one leaf launch and at most three pyramid
   launches, and the launches of the warm prove are printed by shape;
6. the stwo framing: (a) fib-40 at test scale on the card and on the CPU,
   byte-equal and matching ``tests/golden/fib40_stwo_proof_sha256.json``;
   (b) fib-100k at ``STWO_FRAMING_96_BITS`` (production tables) proved once
   and verified on the card; the wide-tape kernel must have launched (the
   stwo trees are hashed on the host, so the BLAKE2s kernel is expected to
   launch 0 times);
7. the command line, in subprocesses: compile fibonacci; prove
   fibonacci(10,000) with ``--max-steps 50000`` (two segments,
   ``REGULAR_96_BITS``, production tables) with ``--verify``; ``verify``
   the file; prove a small run under ``--framing stwo`` and ``verify`` it;
   every exit code 0 and every segment verified;
8. chained segments through ``prove_segments_multiprocess`` with two
   workers on ``cuda:0``: (a) fib-40 cut at 100 steps at test scale, every
   segment's proof digest equal to ``tests/golden/fib40_segments_sha256.json``;
   (b) fibonacci(1,250,000) = 10,000,010 cycles cut at the production cap
   2^20 - 1 into 10 segments at ``REGULAR_96_BITS``: the root chain holds,
   every proof verifies, and all three kernels launch in every segment.

Launch counts are read per path: zeroed just before each path is driven
and read just after (the segment and command-line paths count inside their
worker processes).  The last two lines of standard output are a JSON
summary of the kernels (time, plain version's time, bound and launches on
the main path) and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX and nothing of the JAX package ``cairo_m_tpu``, and says so before its
last lines.
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from cairo_m_tpu_torch.compiler import compile_cairo  # noqa: E402
from cairo_m_tpu_torch import kernels  # noqa: E402
from cairo_m_tpu_torch.hash import blake2s  # noqa: E402
from cairo_m_tpu_torch.prover import config  # noqa: E402
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input  # noqa: E402
from cairo_m_tpu_torch.prover.components.registry import ComponentSet  # noqa: E402
from cairo_m_tpu_torch.prover.prove import prove_cairo_m  # noqa: E402
from cairo_m_tpu_torch.prover.relations import Relations  # noqa: E402
from cairo_m_tpu_torch.prover.stark import framework, merkle, wtape  # noqa: E402
from cairo_m_tpu_torch.prover.stark.air import logup_shift_scalar  # noqa: E402
from cairo_m_tpu_torch.prover.verify import verify_cairo_m  # noqa: E402
from cairo_m_tpu_torch.parallel.segments import prove_segments_multiprocess  # noqa: E402

FIB_SRC = """
fn main(n: felt) -> felt {
    let a = 0;
    let b = 1;
    let i = 0;
    while i != n {
        let t = a + b;
        a = b;
        b = t;
        i = i + 1;
    }
    return a;
}
"""
GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
DEV = torch.device("cuda:0")
TEST_SCALE = {"rc_big_bits": 10, "bitwise_log": 8}
TEST_CONFIG = {"n_queries": 8, "pow_bits": 2}
CHAIN_ITERS = 1_250_000  # fibonacci(1,250,000) = 10,000,010 cycles
SEGMENT_CAP = (1 << 20) - 1
# the kernels every native-framing path must launch; the global-scratch
# variant of the wide-tape kernel takes no plan of the prover today
PATH_KERNELS = ("blake2s_leaves", "blake2s_pyramid", "wtape_run_plan")


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10, warm: bool = True, queued: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` calls between two CUDA events, after
    one warm-up.  The card waits wherever the host enqueues slower than it
    runs, as it does in the prover; ``queued=True`` holds the card busy
    (~20 ms of `torch.cuda._sleep`) while the host enqueues every call, so
    that the reading is the card's time alone."""
    if warm:
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    if queued:
        torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a - b).abs().max()) if a.numel() else 0


# Peak rates of one H100 SXM for the bounds: device memory 3.35 TB/s; INT32
# at half the FP32 lanes (64 of 128 per SM), i.e. a quarter of the 67 TFLOP/s
# FP32 rate, which counts a fused multiply-add as two.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# integer operations of one BLAKE2s compression as the card can do them: 80 G
# functions of 12 (a three-input add for a + b + m twice, two plain adds, four
# xors, four rotations of one funnel shift each) and 20 for set-up and
# feed-forward
BLAKE2S_OPS = 80 * 12 + 20
# of one M31 instruction as csrc/wtape.cu does it: add = add, subtract,
# minimum; sub = subtract, add, minimum; mul = low and high product, mask,
# funnel shift and add for the first fold, mask, shift and add for the second,
# subtract and minimum
M31_OPS = (3, 3, 10)


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def blake2s_bound(k: int, n: int):
    """Each lane reads K int64 words and writes 8, and runs one compression
    per 16 message words."""
    return bound((k + 8) * 8 * n, max(1, -(-k // 16)) * BLAKE2S_OPS * n)


def pyramid_bound(m: int):
    """m digests read and m - 1 written as 8 int64 words each; one
    compression per node written."""
    return bound((2 * m - 1) * 64, (m - 1) * BLAKE2S_OPS)


def wtape_bound(plan, n: int):
    """B bank rows in and n_out rows out as int64, the constants and the
    real instructions read once; the M31 operations of the real (non-NOP)
    instructions on every lane."""
    real = plan.dst != 0
    ops = sum(int(((plan.opc // 9 == k) & real).sum()) * c
              for k, c in enumerate(M31_OPS))
    n_bytes = ((len(plan.used_bank) + len(plan.out_regs)) * 8 * n
               + len(plan.consts) * 8 + int(real.sum()) * 16)
    return bound(n_bytes, ops * n)


# the shapes of the kernel table in PERF.md
BLAKE2S_TABLE = [(1, 1 << 21), (4, 1 << 20), (16, 1 << 20), (16, 1 << 14),
                 (64, 1 << 18), (512, 1 << 10), (1024, 1 << 5), (2048, 1 << 5),
                 (4096, 1 << 6)]
BLAKE2S_MAIN = (4, 1 << 20)
PYRAMID_TABLE = [1 << 21, 1 << 20, 1 << 14, 1 << 11, 1 << 9]  # leaf digests
PYRAMID_MAIN = 1 << 20
WTAPE_TABLE = ["interaction range_check_20", "table count range_check_20",
               "composition range_check_20", "composition store_add_fp_imm",
               "interaction store_add_fp_imm", "composition store_add_fp_fp",
               "interaction poseidon2", "composition poseidon2"]
WTAPE_MAIN = "composition store_add_fp_imm"


def _rand(shape, high, gen):
    return torch.randint(0, high, shape, dtype=torch.int64, device=DEV, generator=gen)


def phase_blake2s(gen):
    """Kernel A vs plain at the main path's (K, n) shapes; -> table rows
    keyed by (K, n) and the summary entry of the main shape."""
    err = 0
    cases = [(1, 1 << 5), (4, 1 << 12), (17, 1 << 10), *BLAKE2S_TABLE]
    table = {}
    for k, n in cases:
        cols = _rand((k, n), 1 << 32, gen)
        got = blake2s.hash_leaves(cols)
        want = torch.stack(blake2s.hash_words(list(cols)))
        e = max_abs_err(got, want)
        err = max(err, e)
        host = cols[:, :3].cpu().numpy().astype(np.uint32)
        for j in range(3):
            ref = hashlib.blake2s(host[:, j].astype("<u4").tobytes()).digest()
            if got[:, j].cpu().numpy().astype("<u4").tobytes() != ref:
                raise AssertionError(f"blake2s kernel != hashlib at K={k} lane {j}")
        line = f"  blake2s K={k:5d} n=2^{n.bit_length() - 1:2d}: max_abs_err={e}"
        if (k, n) in BLAKE2S_TABLE:
            ms = time_ms(lambda: blake2s.hash_leaves(cols))
            dev_ms = time_ms(lambda: blake2s.hash_leaves(cols), queued=True)
            # the plain version of a long message takes seconds: one call
            plain_ms = time_ms(lambda: torch.stack(blake2s.hash_words(list(cols))),
                               reps=1 if k >= 512 else 3, warm=k < 512)
            b_ms, b_by = blake2s_bound(k, n)
            table[(k, n)] = {"ms": ms, "dev_ms": dev_ms, "plain_ms": plain_ms,
                             "bound_ms": b_ms,
                             "bound_by": b_by, "max_abs_err": e}
            line += (f", kernel {ms:.4f} ms ({dev_ms:.4f} ms queued), plain "
                     f"{plain_ms:.4f} ms, bound "
                     f"{b_ms:.4f} ms ({b_by}), kernel/bound {ms / b_ms:.2f}")
        log(line)
    # zero-padded messages (leaf column counts padded to a power of two)
    cols = _rand((12, 1 << 16), 1 << 31, gen)
    padded = torch.cat([cols, torch.zeros((4, 1 << 16), dtype=torch.int64, device=DEV)])
    err = max(err, max_abs_err(blake2s.hash_leaves(cols, 16), blake2s.hash_leaves(padded)))
    if err:
        raise AssertionError(f"blake2s kernel disagrees with plain: {err}")
    return table


def _inner_msg(digests: torch.Tensor) -> torch.Tensor:
    """(8, m) level -> (16, m/2) inner-node messages: left child's words,
    then the right child's."""
    m = digests.reshape(8, -1, 2)
    return torch.cat([m[:, :, 0], m[:, :, 1]], dim=0).contiguous()


def pyramid_by_levels(leaves: torch.Tensor, stop: int = 1) -> list:
    """The route the pyramid kernel replaced: one leaf-kernel launch per
    level over a copied message stack, down to a level of ``stop`` nodes
    (the prover stopped at 2^10 and hashed the rest on the host)."""
    levels = [leaves]
    while levels[-1].shape[1] > stop:
        levels.append(blake2s.hash_leaves(_inner_msg(levels[-1])))
    return levels


def _hashlib_root(leaves: np.ndarray) -> bytes:
    """Merkle root of (m, 8) uint32 leaf digests by hashlib."""
    nodes = [d.astype("<u4").tobytes() for d in leaves]
    while len(nodes) > 1:
        nodes = [hashlib.blake2s(nodes[i] + nodes[i + 1]).digest()
                 for i in range(0, len(nodes), 2)]
    return nodes[0]


def phase_pyramid(gen, max_log: int = 22):
    """The pyramid kernel vs plain for every m = 2^1 .. 2^max_log; -> table
    rows keyed by m."""
    table = {}
    for lg in range(1, max_log + 1):
        m = 1 << lg
        packed = torch.zeros((8, 2 * m - 1), dtype=torch.int64, device=DEV)
        packed[:, :m] = _rand((8, m), 1 << 32, gen)
        want = blake2s.merkle_pyramid_plain(packed.clone())
        before = kernels.launches["blake2s_pyramid"]
        got = blake2s.merkle_pyramid(packed.clone())
        n_launches = kernels.launches["blake2s_pyramid"] - before
        if n_launches != blake2s.pyramid_launches(m):
            raise AssertionError(f"pyramid of 2^{lg}: {n_launches} launches")
        e = max_abs_err(got, want)
        if e:
            raise AssertionError(f"pyramid kernel disagrees with plain at m=2^{lg}: {e}")
        line = f"  pyramid m=2^{lg:2d}: max_abs_err={e}, {n_launches} launches"
        if m == 16:
            root = got[:, -1].cpu().numpy().astype("<u4").tobytes()
            if root != _hashlib_root(packed[:, :m].T.cpu().numpy().astype(np.uint32)):
                raise AssertionError("pyramid root != hashlib")
            line += ", root equal to hashlib's"
        if "--kernels" in sys.argv[1:] and lg >= 9:
            sweep = {}
            for tile in (9, 11):
                if max_abs_err(blake2s.merkle_pyramid(packed.clone(), tile), want):
                    raise AssertionError(f"pyramid kernel, tile 2^{tile}, != plain")
                sweep[tile] = round(time_ms(
                    lambda: blake2s.merkle_pyramid(packed, tile), queued=True), 4)
            line += f", queued ms by levels a launch: {sweep}"
        if m in PYRAMID_TABLE:
            leaves = packed[:, :m].contiguous()
            old = torch.cat(pyramid_by_levels(leaves), dim=1)
            if max_abs_err(got, old):
                raise AssertionError(f"pyramid kernel != level-by-level route at m=2^{lg}")
            ms = time_ms(lambda: blake2s.merkle_pyramid(packed))
            dev_ms = time_ms(lambda: blake2s.merkle_pyramid(packed), queued=True)
            old_ms = time_ms(lambda: pyramid_by_levels(leaves))
            old_q_ms = time_ms(lambda: pyramid_by_levels(leaves), queued=True)
            # as the prover ran it: down to 2^10 nodes, the rest on the host
            old_dev_ms = time_ms(lambda: pyramid_by_levels(leaves, 1 << 10))
            plain_ms = time_ms(lambda: blake2s.merkle_pyramid_plain(packed), reps=2)
            b_ms, b_by = pyramid_bound(m)
            table[m] = {"ms": ms, "dev_ms": dev_ms, "old_ms": old_ms,
                        "old_queued_ms": old_q_ms, "old_dev_ms": old_dev_ms,
                        "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "max_abs_err": e}
            line += (f", kernel {ms:.4f} ms ({dev_ms:.4f} ms with the launches "
                     f"queued), level-by-level route {old_ms:.4f} ms, "
                     f"{old_q_ms:.4f} ms queued ({old_dev_ms:.4f} ms down to 2^10 "
                     f"nodes), plain "
                     f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
                     f"kernel/bound {ms / b_ms:.2f}")
        log(line)
        del packed, want, got
    return table


def phase_trees(gen):
    """Whole Merkle trees on the card vs on the CPU: root, packed pyramid
    and a decommitment of random positions."""
    for n_cols, lg in ((3, 12), (1, 21), (16, 5), (453, 10)):
        cols = _rand((n_cols, 1 << lg), (1 << 31) - 1, gen)
        positions = torch.randint(0, 1 << lg, (40,), generator=gen, device=DEV).tolist()
        before = dict(kernels.launches)
        trees = [merkle.MerkleTree(c) for c in (cols, cols.cpu())]
        got = {k: kernels.launches[k] - before[k] for k in before}
        if (got["blake2s_leaves"] != 1
                or got["blake2s_pyramid"] != blake2s.pyramid_launches(1 << lg)):
            raise AssertionError(f"tree ({n_cols}, 2^{lg}) launched {got}")
        decs = [merkle.finish_plans([merkle.DecommitPlan(t, positions)])[0].to_json_obj()
                for t in trees]
        if (trees[0].root() != trees[1].root() or decs[0] != decs[1]
                or max_abs_err(trees[0].packed.cpu(), trees[1].packed)):
            raise AssertionError(f"tree ({n_cols}, 2^{lg}) differs between card and CPU")
        log(f"  tree of {n_cols} columns, 2^{lg} leaves: root, pyramid and "
            f"decommitment equal on card and CPU; 1 leaf launch, "
            f"{got['blake2s_pyramid']} pyramid launches")


def host_top_seconds() -> float:
    """Seconds the host takes to hash one tree top (1024 nodes
    down to the root) with NumPy, as the prover did for every device tree
    before the pyramid was finished on the card."""
    top = np.random.default_rng(7).integers(0, 1 << 32, size=(1024, 8), dtype=np.uint32)
    merkle._host_inner_levels(top)
    t = time.perf_counter()
    for _ in range(5):
        merkle._host_inner_levels(top)
    return (time.perf_counter() - t) / 5


class _FakeChannel:
    """Deterministic relation parameters for recording plans."""

    i = 0

    def draw_felt(self):
        self.i += 1
        return (self.i * 12345 % 2147483647, self.i, 7, 11)


def _plain(rows, consts, plan):
    instrs, out_regs = wtape._plan_arrays(plan, rows.shape[0], DEV)
    cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(DEV)
    return wtape.run_plan_plain(rows, cdev, instrs, out_regs, plan.n_regs, plan.width)


def _plan_line(name, plan, n):
    prog = wtape.kernel_program(plan)
    lanes = wtape.pick_lanes(prog.n_regs, n)
    return (f"  wtape {name:32s} S={plan.n_steps:3d} R={plan.n_regs:4d}->"
            f"{prog.n_regs:4d} B={len(plan.used_bank):3d} C={len(plan.consts):4d} "
            f"real={len(prog.op):4d}/{plan.n_steps * plan.width:4d} "
            f"n=2^{n.bit_length() - 1} lanes={lanes}")


def witness_plans(pi):
    """Every distinct plan of the witness: (name, plan, n lanes, constants)
    for the interaction, table-count and composition plan of each live
    component, at the domain sizes the prover runs them."""
    relations = Relations()
    comps = ComponentSet(relations)
    comps.write_traces(pi)
    relations.draw(_FakeChannel())
    live = [c for c in comps.all if not c.zero_witness]
    n_apows = max(framework.count_constraints(c) for c in live)
    apows = [(1, 0, 0, 0)] + [(3 + i, 1, 4, 1) for i in range(n_apows)]
    dyn = framework._DynResolver(relations)
    jobs = []
    for c in live:
        plan, _ = framework.interaction_plan(c, relations)
        jobs.append((f"interaction {c.name}", plan, 1 << c.log_size,
                     plan.const_values(dyn)))
        plan = framework.table_count_plan(c, relations)[0]
        if plan is not None:
            jobs.append((f"table count {c.name}", plan, 1 << c.log_size,
                         plan.const_values(dyn)))
        plan = framework.composition_plan(c, relations)
        jobs.append((f"composition {c.name}", plan, 2 << c.log_size,
                     plan.const_values(framework._DynResolver(
                         relations, shift=logup_shift_scalar((1, 2, 3, 4), c.log_size),
                         apows=apows))))
    return jobs


def synthetic_wide_plan(n_bank: int = 2000):
    """A plan that needs more registers than shared memory holds (every bank
    row has a register): products of neighbouring rows, summed in a tree."""
    rec = wtape.WideRecorder()
    ops = wtape.WideOps(rec)
    src = [rec.bank_src("t", i, 0) for i in range(n_bank)]
    terms = [ops.embed(ops.bmul(src[i], src[(i + 1) % n_bank])) for i in range(n_bank)]
    total = ops.etree_sum(terms)
    scaled = ops.bmul(total[0], rec.dyn_const("k"))
    return wtape.schedule_wide(rec, [total[0], scaled, ops.bsub(scaled, src[0])])


def _lanes_sweep(rows, consts, plan):
    """Time the shared-memory kernel at both block sizes (the measurement
    behind the rule `wtape.pick_lanes`)."""
    cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(DEV)
    prog = wtape.kernel_program(plan)
    times = {}
    for lanes in wtape._LANE_CHOICES:
        if wtape.smem_bytes(prog.n_regs, lanes) <= wtape._SMEM_BLOCK_BYTES:
            times[lanes] = round(time_ms(
                lambda: wtape._run_plan_smem(rows, cdev, plan, prog, lanes)), 4)
    log(f"    ms by lanes per block: {times}")


def phase_wtape(pi, gen):
    """Kernel B vs plain on every plan of the fib-100k witness, each timed
    (shared-memory kernel, global-scratch kernel; the table's plans also
    plain).  -> (rows keyed by launch shape, the synthetic plan's entry)."""
    err = 0
    table = {}
    for name, plan, n, consts in witness_plans(pi):
        rows = _rand((len(plan.used_bank), n), (1 << 31) - 1, gen)
        before = dict(kernels.launches)
        got = wtape.run_plan(rows, consts, plan)
        if kernels.launches["wtape_run_plan"] != before["wtape_run_plan"] + 1:
            raise AssertionError(f"{name}: not run by the shared-memory kernel")
        want = _plain(rows, consts, plan)
        e = max(max_abs_err(got, want),
                max_abs_err(wtape.run_plan(rows, consts, plan, variant="global"), want))
        err = max(err, e)
        cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(DEV)
        ms = time_ms(lambda: wtape.run_plan(rows, cdev, plan))
        global_ms = time_ms(lambda: wtape.run_plan(rows, cdev, plan, variant="global"))
        b_ms, b_by = wtape_bound(plan, n)
        row = {"name": name, "ms": ms, "global_ms": global_ms, "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": e}
        table[wtape._launch_shape(plan, n)] = row
        line = (_plan_line(name, plan, n) + f": max_abs_err={e}, kernel {ms:.4f} ms, "
                f"global-scratch kernel {global_ms:.4f} ms, bound {b_ms:.5f} ms "
                f"({b_by}), kernel/bound {ms / b_ms:.2f}")
        if name in WTAPE_TABLE:  # the plain version is slow: the table's plans only
            row["plain_ms"] = time_ms(lambda: _plain(rows, consts, plan), reps=2)
            line += f", plain {row['plain_ms']:.4f} ms"
        log(line)
        if "--kernels" in sys.argv[1:]:
            _lanes_sweep(rows, consts, plan)
        del rows, got, want
    if err:
        raise AssertionError(f"wtape kernel disagrees with plain: {err}")
    missing = set(WTAPE_TABLE) - {r["name"] for r in table.values() if "plain_ms" in r}
    if missing:
        raise AssertionError(f"plans of the kernel table not in the witness: {missing}")

    # the global-scratch kernel by the rule: a register file too large for
    # shared memory
    plan = synthetic_wide_plan()
    n = 1 << 12
    rows = _rand((len(plan.used_bank), n), (1 << 31) - 1, gen)
    consts = plan.const_values({"k": 123456789})
    before = dict(kernels.launches)
    got = wtape.run_plan(rows, consts, plan)
    if (kernels.launches["wtape_run_plan_global"] <= before["wtape_run_plan_global"]
            or kernels.launches["wtape_run_plan"] != before["wtape_run_plan"]):
        raise AssertionError("the synthetic plan did not take the global-scratch kernel")
    e = max_abs_err(got, _plain(rows, consts, plan))
    if e:
        raise AssertionError(f"global-scratch wtape kernel disagrees with plain: {e}")
    ms = time_ms(lambda: wtape.run_plan(rows, consts, plan))
    plain_ms = time_ms(lambda: _plain(rows, consts, plan), reps=2)
    b_ms, b_by = wtape_bound(plan, n)
    log(_plan_line("synthetic (global-scratch kernel)", plan, n)
        + f": max_abs_err={e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.5f} ms ({b_by})")
    synthetic = {"max_abs_err": e, "ms": ms, "plain_ms": plain_ms,
                 "bound_ms": b_ms, "bound_by": b_by}
    return table, synthetic


def _golden(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)["sha256"]


def phase_test_scale(program, framing, golden):
    """fib-40 at test scale: CUDA proof == CPU proof == reference digest."""
    config.set_test_scale(**TEST_SCALE)
    try:
        cfg = config.test_config(**TEST_CONFIG, framing=framing)
        pi = native_prover_input(program, "main", [40])
        js = {}
        for dev in ("cuda", "cpu"):
            t = time.time()
            proof = prove_cairo_m(pi, cfg, device=dev)
            js[dev] = json.dumps(proof.to_json_obj(), sort_keys=True)
            log(f"  fib-40 {framing} test scale on {dev}: {time.time() - t:.2f} s")
        if js["cuda"] != js["cpu"]:
            raise AssertionError(f"fib-40 {framing} proof differs between CUDA and CPU")
        digest = hashlib.sha256(js["cuda"].encode()).hexdigest()
        log(f"  fib-40 {framing} proof sha256 {digest} (reference {_golden(golden)})")
        if digest != _golden(golden):
            raise AssertionError(f"fib-40 {framing} proof does not match the reference digest")
    finally:
        config.set_production_scale()


def prove_full(pi, cfg, label, runs=("cold", "warm")):
    """Prove on the card (the first proof of a process is cold: CUDA
    context, preprocessed commitment, plan recording) and verify.  The
    device is never named: the card is the entry points' default.
    -> (launches, launch shapes of the last prove)."""
    kernels.reset_launches()
    secs = {}
    for run in runs:
        timing = {}
        shapes_before = dict(kernels.launch_shapes)
        torch.cuda.synchronize()
        t = time.time()
        proof = prove_cairo_m(pi, cfg, timing)
        torch.cuda.synchronize()
        secs[run] = time.time() - t
        shapes = {k: n - shapes_before.get(k, 0)
                  for k, n in kernels.launch_shapes.items()
                  if n != shapes_before.get(k, 0)}
        log(f"  {label} {run} prove: {secs[run]:.3f} s, phases "
            + json.dumps({k: round(v, 4) for k, v in timing.items()}))
    t = time.time()
    ok = verify_cairo_m(proof, cfg)
    verify_s = time.time() - t
    launches = dict(kernels.launches)
    if not ok:
        raise AssertionError(f"{label} proof did not verify")
    n = pi.total_steps
    log(f"  {label}: verified in {verify_s:.3f} s; {n} cycles; "
        + ", ".join(f"{run} {n / t:.1f} cycles/s" for run, t in secs.items()))
    log(f"  {label} launches: {launches}")
    return launches, shapes


def _cli(*argv, timeout=900):
    """Run the port's command line; raise unless it exits with 0."""
    t = time.time()
    res = subprocess.run(
        [sys.executable, "-m", "cairo_m_tpu_torch.cli", *argv],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
    )
    log(f"  cli {argv[0]} ({time.time() - t:.2f} s, rc {res.returncode}):")
    for line in (res.stdout + res.stderr).strip().splitlines():
        log(f"    {line}")
    if res.returncode != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited with {res.returncode}")
    return res


def _cli_launches(res):
    """Kernel launches the prove command reports for its segments."""
    total = dict.fromkeys(kernels.launches, 0)
    for m in re.finditer(r"kernel launches (\{.*\})", res.stderr):
        for k, n in json.loads(m.group(1)).items():
            total[k] += n
    return total


def phase_cli(tmp):
    """prove / verify through the command line, in subprocesses."""
    src, prog = os.path.join(tmp, "fib.cm"), os.path.join(tmp, "fib.json")
    with open(src, "w") as f:
        f.write(FIB_SRC)
    _cli("compile", src, "-o", prog)
    launches = {}
    # the stwo proof is checked by `verify` alone: its host-side
    # verification costs tens of seconds on the card's machine
    for framing, arg, n_segments, check in (
        ("native", "10000", 2, ["--verify"]), ("stwo", "100", 1, []),
    ):
        out = os.path.join(tmp, f"{framing}.json")
        # no --device: the command line's default is the card
        res = _cli("prove", prog, "--arguments", arg, "--max-steps", "50000",
                   "--framing", framing, *check, "-o", out)
        launches[framing] = _cli_launches(res)
        verified = [f"segment {i}: verified=True" for i in range(n_segments)]
        if check and [l for l in res.stdout.splitlines() if "verified=" in l] != verified:
            raise AssertionError(f"cli prove {framing}: not every segment verified")
        res = _cli("verify", out)
        ok = [f"segment {i}: OK" for i in range(n_segments)] + ["proof verified"]
        if res.stdout.strip().splitlines() != ok:
            raise AssertionError(f"cli verify {framing}: {res.stdout!r}")
    log(f"  cli prove launches: {launches}")
    if (min(launches["native"][k] for k in PATH_KERNELS) <= 0
            or launches["stwo"]["wtape_run_plan"] <= 0):
        raise AssertionError("a kernel never launched in the cli's proofs")
    return {k: launches["native"][k] + launches["stwo"][k] for k in launches["native"]}


def _digest(obj):
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def phase_segments_test_scale():
    """fib-40 cut at 100 steps, two workers on the card: reference digests."""
    t = time.time()
    # no devices: the default is the first card
    records = prove_segments_multiprocess(
        FIB_SRC, "main", [40], 100, n_processes=2,
        test_scale=TEST_SCALE, test_config=TEST_CONFIG, timeout=600,
    )
    got = [_digest(r["proof"]) for r in records]
    log(f"  fib-40 in {len(records)} segments, {time.time() - t:.2f} s: "
        f"digests {'equal to' if got == _golden('fib40_segments_sha256.json') else 'DIFFERENT from'} the reference's")
    if got != _golden("fib40_segments_sha256.json"):
        raise AssertionError("segment proofs do not match the reference digests")
    return records


def phase_segments_full():
    """fibonacci(1,250,000) in 10 segments at REGULAR_96_BITS, two workers
    on the card; rates as scripts/bench_segments.py defines them."""
    t = time.time()
    records = prove_segments_multiprocess(
        FIB_SRC, "main", [CHAIN_ITERS], SEGMENT_CAP, devices=[str(DEV)],
        n_processes=2, timeout=900,
    )
    wall = time.time() - t
    for r in records:
        log(f"  segment {r['segment']} (worker {r['worker']}): {r['n_steps']} "
            f"cycles, prove {r['prove_s']:.3f} s, verify {r['verify_s']:.3f} s, "
            f"launches {r['launches']}")
        for name in PATH_KERNELS:
            if r["launches"][name] <= 0:
                raise AssertionError(f"kernel {name} never launched in segment {r['segment']}")
    total = sum(r["n_steps"] for r in records)
    prove_s = sum(r["prove_s"] for r in records)
    # warm: every segment but each worker's first (that one pays the
    # worker's cold start), as bench_segments.py drops the first segment
    firsts = {min(r["segment"] for r in records if r["worker"] == w)
              for w in {r["worker"] for r in records}}
    warm = [r for r in records if r["segment"] not in firsts]
    warm_cps = sum(r["n_steps"] for r in warm) / sum(r["prove_s"] for r in warm)
    log(f"  chain: {len(records)} segments, {total} cycles, root chain ok, all "
        f"verified; {total / prove_s:.1f} cycles/s over prove seconds "
        f"({prove_s:.3f} s), warm {warm_cps:.1f} cycles/s over "
        f"{len(warm)} segments; wall {wall:.2f} s ({total / wall:.1f} cycles/s "
        f"end to end, VM, proving and verifying in 2 workers)")
    launches = dict.fromkeys(kernels.launches, 0)
    for r in records:
        for k, n in r["launches"].items():
            launches[k] += n
    return launches


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none is available")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    t = time.time()
    kernels.build(verbose=True)
    kernels.lib()
    log(f"phase 1: kernels built in {time.time() - t:.2f} s")

    gen = torch.Generator(device=DEV)
    gen.manual_seed(2024)
    log("phase 2: blake2s leaf kernel vs plain")
    table_a = phase_blake2s(gen)
    log("phase 2: blake2s pyramid kernel vs plain, every tree of 2^1 .. 2^22 leaves")
    table_p = phase_pyramid(gen)
    phase_trees(gen)
    top_s = host_top_seconds()
    log(f"  host: hashing one tree top (1024 nodes to the root) with NumPy takes "
        f"{top_s * 1e3:.2f} ms on this host")

    program = compile_cairo(FIB_SRC).program
    t = time.time()
    pi = native_prover_input(program, "main", [100_000])
    log(f"fib-100k native VM + adapter: {time.time() - t:.3f} s, "
        f"{pi.total_steps} cycles")
    log("phase 3: wide-tape kernels vs plain, every plan of the fib-100k witness")
    table_b, synthetic = phase_wtape(pi, gen)
    if "--kernels" in sys.argv[1:]:
        log("--kernels: stopping after the kernel phases")
        return

    log("phase 4: test-scale proof, CUDA vs CPU vs reference digest")
    phase_test_scale(program, "native", "fib40_proof_sha256.json")

    log("phase 5: fib-100k at REGULAR_96_BITS, production scale")
    torch.cuda.reset_peak_memory_stats()
    paths = {}
    paths["main"], warm_shapes = prove_full(pi, config.REGULAR_96_BITS, "fib-100k")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name in PATH_KERNELS:
        if paths["main"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")
    if paths["main"]["wtape_run_plan_global"]:
        raise AssertionError("a main-path plan took the global-scratch kernel")
    log("  launches of one warm prove by shape (blake2s_leaves: K, message words, "
        "n; blake2s_pyramid: digests of the level read, levels climbed; "
        "wtape: S, R, B, n_out, n):")
    for key, count in sorted(warm_shapes.items()):
        log(f"    {key[0]} {key[1:]}: {count}")
    log("  kernel table (this run): kernel ms, bound ms, launches per warm prove")
    # a tree is one leaf launch and at most three pyramid launches
    trees = {}
    for key, count in warm_shapes.items():
        if key[0] == "blake2s_leaves":
            trees[key[3]] = trees.get(key[3], 0) + count
    want_pyramid = sum(c * blake2s.pyramid_launches(n) for n, c in trees.items())
    got_pyramid = sum(c for key, c in warm_shapes.items() if key[0] == "blake2s_pyramid")
    log(f"  device trees of one warm prove by leaves: "
        + ", ".join(f"2^{n.bit_length() - 1}: {c}" for n, c in sorted(trees.items()))
        + f"; {sum(trees.values())} leaf launches, {got_pyramid} pyramid launches")
    if got_pyramid != want_pyramid or max(map(blake2s.pyramid_launches, trees)) > 3:
        raise AssertionError(f"{got_pyramid} pyramid launches, expected {want_pyramid}")
    log(f"  the host hashed no top of these {sum(trees.values())} trees; at "
        f"{top_s * 1e3:.2f} ms a top (phase 2) that was "
        f"{sum(trees.values()) * top_s:.3f} s of host time a warm prove")
    for m, row in table_p.items():
        row["launches"] = trees.get(m, 0)
        log(f"    blake2s pyramid m=2^{m.bit_length() - 1}: {row['ms']:.4f} ms "
            f"({row['dev_ms']:.4f} ms queued), level-by-level route "
            f"{row['old_ms']:.4f} ms ({row['old_queued_ms']:.4f} ms queued), bound "
            f"{row['bound_ms']:.5f} ms "
            f"({row['bound_by']}), plain {row['plain_ms']:.4f} ms, trees of this "
            f"size {row['launches']}")
    for (k, n), row in table_a.items():
        row["launches"] = sum(c for key, c in warm_shapes.items()
                              if key[0] == "blake2s_leaves" and key[2:] == (k, n))
        log(f"    blake2s K={k} n=2^{n.bit_length() - 1}: {row['ms']:.4f} ms "
            f"({row['dev_ms']:.4f} ms queued), bound "
            f"{row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, launches {row['launches']}")
    for shape, row in table_b.items():
        row["launches"] = warm_shapes.get(("wtape_run_plan", *shape), 0)
        if "plain_ms" not in row:
            continue
        log(f"    wtape {row['name']} n=2^{shape[-1].bit_length() - 1}: "
            f"{row['ms']:.4f} ms (global-scratch kernel {row['global_ms']:.4f} ms), "
            f"bound {row['bound_ms']:.5f} ms ({row['bound_by']}), plain "
            f"{row['plain_ms']:.4f} ms, launches {row['launches']}")

    unknown = [k for k in warm_shapes if k[0] == "wtape_run_plan" and k[1:] not in table_b]
    if unknown:
        raise AssertionError(f"the warm prove ran plans that phase 3 did not check: {unknown}")
    log(f"  wide-tape kernel, sum over the {sum(r['launches'] for r in table_b.values())} "
        f"launches of one warm prove of the times measured in phase 3: "
        f"{sum(r['launches'] * r['ms'] for r in table_b.values()):.4f} ms "
        f"(global-scratch kernel on the same plans: "
        f"{sum(r['launches'] * r['global_ms'] for r in table_b.values()):.4f} ms)")

    log("phase 6: stwo framing")
    phase_test_scale(program, "stwo", "fib40_stwo_proof_sha256.json")
    paths["stwo"], _ = prove_full(pi, config.STWO_FRAMING_96_BITS, "fib-100k stwo",
                                  runs=("first",))
    if paths["stwo"]["wtape_run_plan"] <= 0:
        raise AssertionError("kernel wtape_run_plan never launched on the stwo path")

    log("phase 7: command line")
    with tempfile.TemporaryDirectory() as tmp:
        paths["cli"] = phase_cli(tmp)

    log("phase 8: chained segments, two workers on the card")
    phase_segments_test_scale()
    paths["segments"] = phase_segments_full()

    def entry(name, source, replaces, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": paths["main"][name],
                "launches_by_path": {p: c[name] for p, c in paths.items()},
                "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                # no single PyTorch call computes BLAKE2s over column lanes,
                # a Merkle pyramid, or interprets an M31 tape
                "library_ms": None}

    main_b = next(r for r in table_b.values() if r["name"] == WTAPE_MAIN)
    wtape_cu = "cairo_m_tpu_torch/csrc/wtape.cu"
    wtape_tpu = "cairo_m_tpu/prover/stark/wtape_pallas.py:69"
    summary = {"kernels": [
        entry("blake2s_leaves", "cairo_m_tpu_torch/csrc/blake2s_leaves.cu",
              "cairo_m_tpu/hash/blake2s_pallas.py:83", table_a[BLAKE2S_MAIN]),
        # the whole pyramid above 2^20 leaf digests, all its launches
        entry("blake2s_pyramid", "cairo_m_tpu_torch/csrc/blake2s_pyramid.cu",
              "cairo_m_tpu/hash/blake2s_pallas.py:83", table_p[PYRAMID_MAIN]),
        entry("wtape_run_plan", wtape_cu, wtape_tpu, main_b),
        # the variant for register files beyond shared memory: no plan of
        # the prover needs it today, so it is held to plain on a synthetic
        # plan (phase 3) and launches 0 times on the main path
        entry("wtape_run_plan_global", wtape_cu, wtape_tpu, synthetic),
    ]}
    log(f"timed shapes: blake2s K={BLAKE2S_MAIN[0]} n={BLAKE2S_MAIN[1]}; blake2s "
        f"pyramid over {PYRAMID_MAIN} leaf digests (all its launches); wtape "
        f"{WTAPE_MAIN} n=2^20; wtape global: synthetic plan, 2000 bank rows, n=2^12")
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "cairo_m_tpu"))
    if loaded:
        raise AssertionError(f"modules of JAX or of the JAX package were loaded: {loaded}")
    log("no module of jax or cairo_m_tpu was loaded")
    log(f"card: {card_line()}")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
