"""Smoke test of the PyTorch/CUDA prover (cairo_m_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each raises on failure, so the script exits non-zero):

1. require a CUDA device; print the card's name and power limit; build the
   CUDA kernels from ``cairo_m_tpu_torch/csrc`` and time the build;
2. BLAKE2s leaf kernel vs its plain torch version on the card, bit for bit,
   at the Merkle shapes of the main path, plus a few lanes vs ``hashlib``;
3. wide-tape kernel vs its plain torch version on the card, bit for bit, on
   real plans recorded from the fibonacci-100k witness;
4. at test scale, fib-40 proved on the card and on the CPU (plain
   versions): the two proofs' JSON must be byte-equal and match the
   committed reference digest ``tests/golden/fib40_proof_sha256.json``;
5. the main path at full size: compile fibonacci, run the native VM +
   adapter for 100,000 iterations (800,010 cycles), prove twice at
   ``REGULAR_96_BITS`` (production tables) and verify; both kernels must
   have launched during that run;
6. the stwo framing: (a) fib-40 at test scale on the card and on the CPU,
   byte-equal and matching ``tests/golden/fib40_stwo_proof_sha256.json``;
   (b) fib-100k at ``STWO_FRAMING_96_BITS`` (production tables) proved cold
   and warm and verified on the card; the wide-tape kernel must have
   launched (the stwo trees are hashed on the host, so the BLAKE2s kernel
   is expected to launch 0 times);
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
   every proof verifies, and both kernels launch in every segment.

Launch counts are read per path: zeroed just before each path is driven
and read just after (the segment and command-line paths count inside their
worker processes).  The last two lines of standard output are a JSON
summary of the kernels and ``{"ok": true, "device": {...}}``.  Imports
nothing of JAX.
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

from cairo_m_tpu.compiler import compile_cairo  # noqa: E402
from cairo_m_tpu_torch import kernels  # noqa: E402
from cairo_m_tpu_torch.hash import blake2s  # noqa: E402
from cairo_m_tpu_torch.prover import config  # noqa: E402
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input  # noqa: E402
from cairo_m_tpu_torch.prover.components.registry import ComponentSet  # noqa: E402
from cairo_m_tpu_torch.prover.prove import prove_cairo_m  # noqa: E402
from cairo_m_tpu_torch.prover.relations import Relations  # noqa: E402
from cairo_m_tpu_torch.prover.stark import framework, wtape  # noqa: E402
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


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 10) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def phase_blake2s(rng):
    """Kernel A vs plain at the main path's (K, n) shapes."""
    err = 0
    cases = [(1, 1 << 5), (1, 1 << 21), (4, 1 << 12), (16, 1 << 20),
             (17, 1 << 10), (64, 1 << 18), (512, 1 << 10), (4096, 1 << 6)]
    for k, n in cases:
        cols = torch.from_numpy(
            rng.integers(0, 1 << 32, size=(k, n), dtype=np.int64)
        ).to(DEV)
        got = blake2s.hash_leaves(cols)
        want = torch.stack(blake2s.hash_words(list(cols)))
        e = max_abs_err(got, want)
        log(f"  blake2s K={k:5d} n=2^{n.bit_length() - 1:2d}: max_abs_err={e}")
        err = max(err, e)
        host = cols[:, :3].cpu().numpy().astype(np.uint32)
        for j in range(3):
            ref = hashlib.blake2s(host[:, j].astype("<u4").tobytes()).digest()
            if got[:, j].cpu().numpy().astype("<u4").tobytes() != ref:
                raise AssertionError(f"blake2s kernel != hashlib at K={k} lane {j}")
    # zero-padded messages (leaf column counts padded to a power of two)
    cols = torch.from_numpy(rng.integers(0, 1 << 31, size=(12, 1 << 16))).to(DEV)
    padded = torch.cat([cols, torch.zeros((4, 1 << 16), dtype=torch.int64, device=DEV)])
    err = max(err, max_abs_err(blake2s.hash_leaves(cols, 16), blake2s.hash_leaves(padded)))
    if err:
        raise AssertionError(f"blake2s kernel disagrees with plain: {err}")
    k, n = 16, 1 << 20
    cols = torch.from_numpy(rng.integers(0, 1 << 32, size=(k, n), dtype=np.int64)).to(DEV)
    ms = time_ms(lambda: blake2s.hash_leaves(cols))
    plain_ms = time_ms(lambda: torch.stack(blake2s.hash_words(list(cols))), reps=3)
    log(f"  blake2s K=16 n=2^20: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": "K=16 n=2^20"}


class _FakeChannel:
    """Deterministic relation parameters for recording plans."""

    i = 0

    def draw_felt(self):
        self.i += 1
        return (self.i * 12345 % 2147483647, self.i, 7, 11)


def _check_plan(name, plan, elog, consts, rng):
    n = 1 << elog
    rows = torch.from_numpy(
        rng.integers(0, (1 << 31) - 1, size=(len(plan.used_bank), n))
    ).to(DEV)
    got = wtape.run_plan(rows, consts, plan)
    instrs, out_regs = wtape._plan_arrays(plan, rows.shape[0], DEV)
    cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(DEV)
    want = wtape.run_plan_plain(rows, cdev, instrs, out_regs, plan.n_regs, plan.width)
    e = max_abs_err(got, want)
    log(f"  wtape {name:34s} S={plan.n_steps:3d} R={plan.n_regs:4d} "
        f"B={len(plan.used_bank):3d} C={len(plan.consts):4d} n=2^{elog}: max_abs_err={e}")
    return e, rows, cdev, instrs, out_regs


def phase_wtape(pi, rng):
    """Kernel B vs plain on real plans of the fib-100k witness."""
    relations = Relations()
    comps = ComponentSet(relations)
    comps.write_traces(pi)
    relations.draw(_FakeChannel())
    live = [c for c in comps.all if not c.zero_witness]
    n_apows = max(framework.count_constraints(c) for c in live)
    apows = [(1, 0, 0, 0)] + [(3 + i, 1, 4, 1) for i in range(n_apows)]

    def comp_consts(c, plan):
        return plan.const_values(framework._DynResolver(
            relations, shift=logup_shift_scalar((1, 2, 3, 4), c.log_size),
            apows=apows))

    jobs = []
    big = max(live, key=lambda c: c.log_size)
    plan, _ = framework.interaction_plan(big, relations)
    jobs.append((f"interaction {big.name}", plan, big.log_size,
                 plan.const_values(framework._DynResolver(relations))))
    tcs = [(c, framework.table_count_plan(c, relations)[0]) for c in live]
    tcs = [(c, p) for c, p in tcs if p is not None]
    c, plan = max(tcs, key=lambda cp: cp[1].n_steps * cp[1].width << cp[0].log_size)
    jobs.append((f"table count {c.name}", plan, c.log_size,
                 plan.const_values(framework._DynResolver(relations))))
    ops = [c for c in live if c in comps.opcodes]
    c = max(ops, key=lambda c: framework.composition_plan(c, relations).n_steps << c.log_size)
    plan = framework.composition_plan(c, relations)
    jobs.append((f"composition {c.name}", plan, c.log_size + 1, comp_consts(c, plan)))
    timed = (plan, c.log_size + 1)
    c = comps.poseidon2
    plan = framework.composition_plan(c, relations)
    jobs.append((f"composition {c.name}", plan, c.log_size + 1, comp_consts(c, plan)))
    err = 0
    for name, plan, elog, consts in jobs:
        e, rows, cdev, instrs, out_regs = _check_plan(name, plan, elog, consts, rng)
        err = max(err, e)
        if plan is timed[0]:
            ms = time_ms(lambda: wtape.run_plan(rows, consts, plan))
            plain_ms = time_ms(lambda: wtape.run_plan_plain(
                rows, cdev, instrs, out_regs, plan.n_regs, plan.width), reps=3)
            shape = f"{name} S={plan.n_steps} n=2^{elog}"
            log(f"  wtape {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if err:
        raise AssertionError(f"wtape kernel disagrees with plain: {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "shape": shape}


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


def prove_full(pi, cfg, label):
    """Prove cold and warm on the card and verify; -> (launches, stats)."""
    kernels.reset_launches()
    runs = []
    for run in ("cold", "warm"):
        timing = {}
        torch.cuda.synchronize()
        t = time.time()
        proof = prove_cairo_m(pi, cfg, timing, device=DEV)
        torch.cuda.synchronize()
        runs.append(time.time() - t)
        log(f"  {label} {run} prove: {runs[-1]:.3f} s, phases "
            + json.dumps({k: round(v, 4) for k, v in timing.items()}))
    t = time.time()
    ok = verify_cairo_m(proof, cfg, device=DEV)
    verify_s = time.time() - t
    launches = dict(kernels.launches)
    if not ok:
        raise AssertionError(f"{label} proof did not verify")
    n = pi.total_steps
    log(f"  {label}: verified in {verify_s:.3f} s; {n} cycles; warm "
        f"{n / runs[1]:.1f} cycles/s, cold {n / runs[0]:.1f} cycles/s")
    log(f"  {label} launches: {launches}")
    return launches, {"cold_s": runs[0], "warm_s": runs[1], "verify_s": verify_s}


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
        res = _cli("prove", prog, "--arguments", arg, "--max-steps", "50000",
                   "--framing", framing, "--device", "cuda", *check, "-o", out)
        launches[framing] = _cli_launches(res)
        verified = [f"segment {i}: verified=True" for i in range(n_segments)]
        if check and [l for l in res.stdout.splitlines() if "verified=" in l] != verified:
            raise AssertionError(f"cli prove {framing}: not every segment verified")
        res = _cli("verify", out, "--device", "cuda")
        ok = [f"segment {i}: OK" for i in range(n_segments)] + ["proof verified"]
        if res.stdout.strip().splitlines() != ok:
            raise AssertionError(f"cli verify {framing}: {res.stdout!r}")
    log(f"  cli prove launches: {launches}")
    if min(launches["native"].values()) <= 0 or launches["stwo"]["wtape_run_plan"] <= 0:
        raise AssertionError("a kernel never launched in the cli's proofs")
    return {k: launches["native"][k] + launches["stwo"][k] for k in launches["native"]}


def _digest(obj):
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def phase_segments_test_scale():
    """fib-40 cut at 100 steps, two workers on the card: reference digests."""
    t = time.time()
    records = prove_segments_multiprocess(
        FIB_SRC, "main", [40], 100, devices=[str(DEV)], n_processes=2,
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
        for name, count in r["launches"].items():
            if count <= 0:
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

    rng = np.random.default_rng(2024)
    log("phase 2: blake2s leaf kernel vs plain")
    res_a = phase_blake2s(rng)

    program = compile_cairo(FIB_SRC).program
    t = time.time()
    pi_big = native_prover_input(program, "main", [100_000])
    log(f"fib-100k native VM + adapter: {time.time() - t:.3f} s, "
        f"{pi_big.total_steps} cycles")
    log("phase 3: wide-tape kernel vs plain")
    res_b = phase_wtape(pi_big, rng)

    log("phase 4: test-scale proof, CUDA vs CPU vs reference digest")
    phase_test_scale(program, "native", "fib40_proof_sha256.json")

    log("phase 5: fib-100k at REGULAR_96_BITS, production scale")
    t = time.time()
    pi = native_prover_input(program, "main", [100_000])
    log(f"  native VM + adapter {time.time() - t:.3f} s")
    paths = {}
    paths["main"], _ = prove_full(pi, config.REGULAR_96_BITS, "fib-100k")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for name, count in paths["main"].items():
        if count <= 0:
            raise AssertionError(f"kernel {name} never launched on the main path")

    log("phase 6: stwo framing")
    phase_test_scale(program, "stwo", "fib40_stwo_proof_sha256.json")
    paths["stwo"], _ = prove_full(pi, config.STWO_FRAMING_96_BITS, "fib-100k stwo")
    if paths["stwo"]["wtape_run_plan"] <= 0:
        raise AssertionError("kernel wtape_run_plan never launched on the stwo path")

    log("phase 7: command line")
    with tempfile.TemporaryDirectory() as tmp:
        paths["cli"] = phase_cli(tmp)

    log("phase 8: chained segments, two workers on the card")
    phase_segments_test_scale()
    paths["segments"] = phase_segments_full()

    summary = {"kernels": [
        {"name": "blake2s_leaves", "route": "cuda",
         "source": "cairo_m_tpu_torch/csrc/blake2s_leaves.cu",
         "replaces": "cairo_m_tpu/hash/blake2s_pallas.py:83",
         "launches": paths["main"]["blake2s_leaves"],
         "launches_by_path": {p: c["blake2s_leaves"] for p, c in paths.items()},
         "max_abs_err": res_a["max_abs_err"], "ms": res_a["ms"],
         "plain_ms": res_a["plain_ms"]},
        {"name": "wtape_run_plan", "route": "cuda",
         "source": "cairo_m_tpu_torch/csrc/wtape.cu",
         "replaces": "cairo_m_tpu/prover/stark/wtape_pallas.py:69",
         "launches": paths["main"]["wtape_run_plan"],
         "launches_by_path": {p: c["wtape_run_plan"] for p, c in paths.items()},
         "max_abs_err": res_b["max_abs_err"], "ms": res_b["ms"],
         "plain_ms": res_b["plain_ms"]},
    ]}
    log(f"timed shapes: blake2s {res_a['shape']}; wtape {res_b['shape']}")
    log(f"card: {card_line()}")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
