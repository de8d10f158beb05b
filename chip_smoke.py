"""Smoke test of the PyTorch/CUDA prover (cairo_m_tpu_torch) on one GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --kernels  # phases 1-3, the wide-tape kernel's
                                     # time on every plan at both block sizes
                                     # and the pyramid kernel's on every
                                     # tree at both tile sizes, and kernel
                                     # A's SASS counted by pipe
    python3 chip_smoke.py --witnesses  # phases 1 and 5b: the way to
                                       # iterate on the AIR components
    python3 chip_smoke.py --sharded  # phases 1, 5 and 9: the way to iterate
                                     # on the row-sharded prover, and the
                                     # witness upload routes
    python3 chip_smoke.py --nccl     # phases 1, 5 and 13 only, on a
                                     # machine with four cards
    python3 chip_smoke.py --fib1m    # phases 1 and 10: the largest proof
    python3 chip_smoke.py --sha256   # phases 1 and 11: the SHA-256 example
    python3 chip_smoke.py --bench    # phases 1 and 12: the bench 5 times,
                                     # the chain at full depth
    python3 chip_smoke.py --wasm     # phases 1 and 14: WASM-compiled
                                     # programs against the JAX package
    python3 chip_smoke.py --point-eval  # phases 1 and 15 at fib-100k,
                                        # bench1k and fib(1M)
    python3 chip_smoke.py --poseidon2  # phases 1, 16 and 17: the poseidon2
                                       # witness kernel, bigmem's proof

Phases (each raises on failure, so the script exits non-zero):

1. require a CUDA device; print the card's name and power limit; build the
   CUDA kernels from ``cairo_m_tpu_torch/csrc`` and time the build; read
   the INT32 rate of the operation bounds off the card (SM count, maximum
   SM clock);
2. BLAKE2s leaf kernel vs its plain torch version on the card, bit for bit,
   at the Merkle shapes of the main path, plus a few lanes vs ``hashlib``;
   timed beside its bound at the shapes of PERF.md's kernel table.  BLAKE2s
   pyramid kernel vs its plain version on the card, bit for bit, for every
   tree of 2^1 .. 2^24 leaves, and vs the level-by-level route it replaced
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
   launches, and the launches of the warm prove are printed by shape; the
   proof's digest must equal ``tests/golden/fib100k_production_sha256.json``
   (the JAX package's proof of ``bench.py``'s input) and is kept for phase
   9, with the peak device memory;
5b. every AIR component, through the witnesses of
   ``tests/golden/witnesses.json`` (together they keep all 45 components
   busy): (a) each test-scale witness compiled, run by the native VM and
   proved on the card under every framing it has a reference digest for,
   the digest equal to the reference's and the proof verified; (b) the
   wide-tape kernels on every plan of every live component of all the
   witnesses but the SHA-256 example's (phase 11(c) checks those at their
   sizes): the kernel the rule picks (recorded per plan) and the
   global-scratch kernel, each bit for bit against the plain version and
   timed beside its bound; the opcode plans of PERF.md's table also at
   2^20 lanes; (c) the production witnesses at ``REGULAR_96_BITS``:
   ``allops`` proved cold (the prover's plan and preprocessed caches set
   aside) and warm, its seconds, launches, peak device memory and program
   id printed, the others once (the SHA-256 example's in phase 11), each
   digest equal to
   ``tests/golden/<name>_production_sha256.json`` and each proof verified,
   but for ``allops``'s, which the verifier must reject at the OODS check as
   the reference's verifier rejects the same bytes (store_le_fp_imm's
   constraints exceed the composition's degree in both packages: the
   ``fault`` that witnesses.json records);
   all three kernels must have launched on the allops path, and every plan
   its warm prove ran must have a launch shape (b) checked;
6. the stwo framing: (a) fib-40 at test scale on the card and on the CPU,
   byte-equal and matching ``tests/golden/fib40_stwo_proof_sha256.json``;
   (b) fib(10,000) at ``STWO_FRAMING_96_BITS`` (production tables) proved once
   on the card, its cycles and digest equal to the JAX package's
   (``tests/golden/fib10k_stwo_production_sha256.json``) and its verdict
   the reference's; the wide-tape kernel must have launched (the
   stwo trees are hashed on the host, so the BLAKE2s kernel is expected to
   launch 0 times);
7. the command line, in subprocesses: compile fibonacci; prove
   fibonacci(2,000) with ``--max-steps 10000`` (two segments,
   ``REGULAR_96_BITS``, production tables) with ``--verify`` and ``verify``
   the file, and beside that chain prove a small run under ``--framing
   stwo`` and ``verify`` it, and run phase 11(d) and phase 12; every exit
   code 0 and every segment verified; and beside them phase 14(c);
8. chained segments through ``prove_segments_multiprocess`` with two
   workers on ``cuda:0``: (a) fib-40 cut at 100 steps at test scale, every
   segment's proof digest equal to ``tests/golden/fib40_segments_sha256.json``;
   (b) fibonacci(600,000) = 4,800,010 cycles cut at the production cap
   2^20 - 1 into 5 segments at ``REGULAR_96_BITS`` (the 10,000,010-cycle
   chain runs under ``--bench``, phase 12): the root chain holds,
   every proof verifies, and all three kernels launch in every segment;
   every segment's cycles and memory roots equal the JAX package's, and
   segments 1, 2 and 5 (the first resumed one and the last) its proofs
   (``tests/golden/fib600k_segments_production_sha256.json``);
9. the row-sharded prover (``prove_sharded``, one process per rank): (a)
   fib-40 at test scale, two ranks on ``cuda:0`` under gloo, every rank's
   proof equal to ``tests/golden/fib40_proof_sha256.json``; (b) fib-100k at
   ``REGULAR_96_BITS``, two ranks on ``cuda:0`` under gloo, a cold and a
   warm prove per rank: the proof byte-equal to phase 5's on every rank and
   verified, all three kernels launched in every rank's warm prove, each
   rank's peak device memory below phase 5's; each rank's seconds, phases
   and exchange bytes and seconds are printed (NCCL, one card a rank:
   phase 13).  Every run prints its backend.  The ranks load the kernel
   library phase 1 built.
   Under ``--sharded`` only, the two witness upload routes are timed on the
   fib-100k witness (``prove.upload_rows``: bytes and copy seconds;
   ``colpack.upload_stack``: host classify seconds, packed bytes, copy and
   unpack seconds) and must rebuild the same stacks;
10. the reference's largest single proof, fibonacci(1,000,000) = 8,000,010
   cycles in one segment at ``REGULAR_96_BITS``: (a) ``python -m
   cairo_m_tpu_torch.profile prove --iters 1000000 --runs cold,warm
   --verify`` in a fresh process that cannot import JAX (a clean peak
   memory, a true cold start): the proof's digest equal to
   ``tests/golden/fib1m_card_proof_sha256.json`` (made on the card, accepted
   by the reference's verifier), verified by the port; its cold and warm
   seconds, cycles/s, phases, launches, peak device memory and log sizes,
   and the warm proof's ``CM_DEBUG_PHASES`` lines are printed; (b) the
   kernels at its sizes: the wide-tape kernels on every plan of the
   fib(1M) witness at its own size (as phase 3), the leaf kernel on every
   leaf shape of the warm proof beyond 2^20 lanes and the pyramid kernel on
   every tree size, each bit for bit against plain, the leaves timed; every
   launch shape of the warm proof checked;
11. the SHA-256 example ``examples/sha256/sha256.cm``, the JAX package's
   README proof (``main``: SHA-256 of "abc") and the Rust reference's second
   prover benchmark (``bench1k``: a 1 KiB message, 292,715 cycles, 30 live
   components, 12 of them u32 opcodes): (a) both entry points run by the
   native VM + adapter, their return values equal to ``hashlib``'s digest
   and their live components those of ``tests/golden/witnesses.json``; (b)
   each proved at ``REGULAR_96_BITS`` with ``profile.timed_prove``, cold
   (``profile.cold_prover_caches``) and warm (``bench1k`` twice warm), every
   digest equal to ``tests/golden/sha256_<entry>_production_sha256.json``
   and ``bench1k``'s proof verified (``main``'s bytes are (d)'s); seconds,
   cycles/s, phases, launches, peak device
   memory and log sizes printed; then ``bench1k`` once under
   ``profile.trace_prove`` and once per component
   (``profile.component_report``); (c) the wide-tape kernels on every plan
   of ``bench1k``'s live components at their sizes (those phase 3 did not
   check at the same size), the rule's kernel and the global-scratch
   kernel, each bit for bit against plain, the u32 and bitwise plans timed
   beside plain; every leaf shape and every tree size of the warm proof
   against plain; (d) the README's chain through the command line in
   subprocesses: ``compile``, ``run --entrypoint main`` (the digest words),
   ``prove --entrypoint main --output --verify --device cuda`` (the file's
   segment equal to the ``main`` digest) and ``verify --device cuda``; the
   full run runs (d) in phase 7, beside the other command-line chains;
12. the repository's prover benches on the port, each in a fresh process
   that cannot import JAX: ``python -m cairo_m_tpu_torch.bench`` (the
   counterpart of ``bench.py``: fib-100k, a warm-up and a timed prove,
   verify) once, its line showing stage ``done``, the proof verified,
   800,010 cycles, the card of phase 1, and every kernel of the path
   launched in the timed prove (its standard error); ``python -m
   cairo_m_tpu_torch.bench_segments`` (the counterpart of
   ``scripts/bench_segments.py``) at ``SEG_FIB_ITERS=300000``: 2,400,010
   cycles in 3 segments at the production cap, the root chain holding,
   every proof verified and every kernel launched in every segment.  Each
   line is echoed.  The full run runs this phase in phase 7, beside the
   command line's chains.  ``--bench`` runs the bench 5 times, each in a fresh
   process, and the chain at its full depth (10,000,010 cycles, 10
   segments), and prints the spread of the bench's lines;
13. under ``--nccl`` only, after phase 5, on a machine with four cards
   (it raises with fewer): (a) fib-40 at test scale on 2 and on 4 NCCL
   ranks, one card a rank, every rank's proof equal to
   ``tests/golden/fib40_proof_sha256.json``; (b) fib-100k at
   ``REGULAR_96_BITS`` on 2 ranks (cards 0-1) and on 4 (cards 0-3), each
   rank cold then warm, every rank's proof equal to phase 5's and to
   ``tests/golden/fib100k_production_sha256.json`` and verified; (c)
   fibonacci(1,000,000) on 4 ranks, cold then warm, equal to
   ``tests/golden/fib1m_card_proof_sha256.json`` and verified; (b) and (c)
   print a line a rank: its card, cold and warm seconds, peak device
   memory on its card, peak host memory, the warm prove's exchanges
   (count, bytes, seconds) and kernel launches; (d) on every card, the leaf
   kernel, the pyramid kernel and kernel B (both variants) bit for bit
   against their plain versions on that card, launched from this process
   while its current card stays ``cuda:0``, each timed there; (e) phase
   8(b)'s chain on two workers on ``cuda:0`` and on four workers, one a
   card: every segment's digest equal between the two, the root chain
   intact, each segment's card, seconds and peak printed, both walls.
   (d) and (e) run first, then (a), and (b) and (c) only once (a) passed;
   every part that can runs, and any failure makes the script exit
   non-zero.  Its last line names the four cards' count;
14. programs of the WASM frontend (``cairo_m_tpu_torch/wasm``), the JAX
   package's test modules committed as hex in their goldens: (a) both
   modules (``memrw``, a linear-memory store and load; ``sumsq``, a
   sum-of-squares loop over one full 64 KiB page) compiled; ``memrw`` at
   test scale proved on the card, equal to
   ``tests/golden/wasm_memrw_proof_sha256.json`` (the port's CPU proof is
   held to it in ``tests/test_torch_wasm.py``); (b) both at
   ``REGULAR_96_BITS``, cold and warm, every digest equal to
   ``tests/golden/wasm_<name>_production_sha256.json`` and every verdict
   the reference's; seconds, phases, peak device memory and launches
   printed, all three kernels launched in each warm proof; kernel B on
   every plan of their live components at their sizes (those earlier
   phases did not check at the same size), bit for bit against plain and
   timed beside it and its bound, every wide-tape launch shape of the warm
   proofs checked, and the trees' kernels on every leaf shape and tree
   size; (c) ``wasm``, ``prove --verify --device cuda`` and ``verify`` of
   ``memrw`` through the command line, in subprocesses that cannot import
   JAX, the file's segment equal to the production golden (the full run
   runs (c) in phase 7);
15. the point-evaluation kernel (``csrc/point_eval.cu``) at the sample step
   of a real proof: the proof (after phase 5's, fib-100k) with its sample
   step's jobs kept, one ``point_eval`` launch in it and its digest the
   golden's; the kernel against the plain folds on the card on those jobs,
   bit for bit; the kernel timed alone on a prebuilt table (and queued),
   one wrapper call with its table, and the plain folds, beside the bytes
   bound.  ``--point-eval`` runs it after a warm-up proof at fib-100k, the
   SHA-256 example's ``bench1k`` and fibonacci(1,000,000).
16. the ``poseidon2`` component's witness kernel (``csrc/poseidon2.cu``)
   against its plain torch rounds on the card, bit for bit, at 2^20 and
   2^21 rows from random states, one launch a call, timed (and queued)
   beside its bytes bound: 16 int32 words read and 443 int64 columns
   written a row.  Every path of the prover launches it once a proof;
17. bigmem's ``main`` (``benchmark/programs/bigmem.cm``, 128,000 u32
   filled and read back) proved at REGULAR_96_BITS and verified: its
   memory trees' 2,048,986 hashes give the ``poseidon2`` component 2^21
   rows, made by one launch of the witness kernel; the output is the
   wrapping sum and the committed element; the peak device memory.

Launch counts are read per path: zeroed just before each path is driven
and read just after (the segment, command-line and sharded paths count
inside their worker and rank processes).  The last two lines of standard
output are a JSON summary of the kernels (time, plain version's time, bound
and launches on the main path, and on every other path) and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX and nothing of the JAX package ``cairo_m_tpu``, and says so before its
last lines.
"""

import contextlib
import hashlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from cairo_m_tpu_torch.compiler import compile_cairo  # noqa: E402
from cairo_m_tpu_torch import kernels, profile  # noqa: E402
from cairo_m_tpu_torch.bench import FIB_SRC  # noqa: E402  bench.py's source
from cairo_m_tpu_torch.hash import blake2s  # noqa: E402
from cairo_m_tpu_torch.prover import config  # noqa: E402
from cairo_m_tpu_torch.isa.program import Program  # noqa: E402
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input  # noqa: E402
from cairo_m_tpu_torch.prover.components.registry import ComponentSet  # noqa: E402
from cairo_m_tpu_torch.prover.prove import prove_cairo_m  # noqa: E402
from cairo_m_tpu_torch.prover.relations import Relations  # noqa: E402
from cairo_m_tpu_torch.prover.stark import fft, framework, merkle, wtape  # noqa: E402
from cairo_m_tpu_torch.prover.stark.air import logup_shift_scalar  # noqa: E402
from cairo_m_tpu_torch.prover.verify import VerificationError, verify_cairo_m  # noqa: E402
from cairo_m_tpu_torch.parallel.segments import prove_segments_multiprocess  # noqa: E402
from cairo_m_tpu_torch.parallel.sharded import prove_sharded  # noqa: E402
from cairo_m_tpu_torch.prover.prove import upload_rows  # noqa: E402
from cairo_m_tpu_torch.prover.stark import colpack  # noqa: E402
from cairo_m_tpu_torch.wasm import compile_wasm  # noqa: E402

GOLDEN_DIR = os.path.join(REPO, "tests", "golden")
DEV = torch.device("cuda:0")
TEST_SCALE = {"rc_big_bits": 10, "bitwise_log": 8}
TEST_CONFIG = {"n_queries": 8, "pow_bits": 2}
CHAIN_ITERS = 1_250_000  # fibonacci(1,250,000) = 10,000,010 cycles
WORKERS_ITERS = 600_000  # phase 8(b): 4,800,010 cycles, 5 segments
STWO_ITERS = 10_000  # phase 6(b): 80,010 cycles under the stwo framing
# the JAX package's proof of bench.py's input: fib-100k, REGULAR_96_BITS
FIB100K_GOLDEN = "fib100k_production_sha256.json"
# the JAX package's proof of phase 6(b)'s input and its chain of phase 8(b)'s
STWO_GOLDEN = "fib10k_stwo_production_sha256.json"
CHAIN_GOLDEN = "fib600k_segments_production_sha256.json"
# phase 12: fibonacci(300,000) = 2,400,010 cycles, 3 segments at the cap
SEG_SMOKE_ITERS = 300_000
BENCH_RUNS = 5  # bench lines of --bench
SEGMENT_CAP = (1 << 20) - 1
# the kernels every native-framing path must launch; the global-scratch
# variant of the wide-tape kernel takes no plan of the prover today
PATH_KERNELS = ("blake2s_leaves", "blake2s_pyramid", "wtape_run_plan",
                "poseidon2_witness")
# phase 17: bigmem's main, 128,000 elements (the benchmark's program)
BIGMEM_PROGRAM = "benchmark/programs/bigmem.cm"
BIGMEM_N = 128_000


_START = time.time()


def log(msg):
    print(msg, flush=True)


def phase(msg):
    """Log the start of a phase with the seconds since the script began."""
    log(f"{msg} [{time.time() - _START:.1f} s]")


def card_line(every: bool = False) -> str:
    """The first card's name and power limit, or ``every`` card's, "; "
    between them."""
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return "; ".join(lines) if every else lines[0]


def time_ms(fn, reps: int = 10, warm: bool = True, queued: bool = False,
            device=DEV) -> float:
    """Mean time of ``fn`` over ``reps`` calls between two CUDA events on
    ``device``'s current stream, after one warm-up; the calling thread's
    current card stays what it was.  The card waits wherever the host
    enqueues slower than it runs, as it does in the prover; ``queued=True``
    holds the card busy (~20 ms of `torch.cuda._sleep`) while the host
    enqueues every call, so that the reading is the card's time alone."""
    if warm:
        fn()
    stream = torch.cuda.current_stream(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    if queued:
        with torch.cuda.device(device):
            torch.cuda._sleep(40_000_000)
    start.record(stream)
    for _ in range(reps):
        fn()
    end.record(stream)
    torch.cuda.synchronize(device)
    return start.elapsed_time(end) / reps


def timed_call(fn, device=DEV):
    """(``fn()``, the ms of that one call between two CUDA events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(device)
    start.record(torch.cuda.current_stream(device))
    out = fn()
    end.record(torch.cuda.current_stream(device))
    torch.cuda.synchronize(device)
    return out, start.elapsed_time(end)


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a - b).abs().max()) if a.numel() else 0


# Peak rates of the card for the bounds: device memory 3.35 TB/s (one H100
# SXM); INT32 operations at the rate `card_rates` reads off the card in phase
# 1: 64 thread instructions a clock an SM (its INT32 pipe) at the SM clock's
# maximum, 132 x 64 x 1,980 MHz = 16.73e12/s on an H100 SXM.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = None
# integer operations of one BLAKE2s compression (csrc/blake2s_compress.cuh)
# that only the INT32 pipe can do: the 80 G functions' 4 xors and 4
# rotations (one funnel shift each) and the feed-forward's 8 three-input
# xors; the set-up's operands are the same in every lane.  The G functions'
# adds can all leave that pipe as IMADs on the FMA pipe, of the same rate:
# 80 x 6 = 480 of them.  An SM issues twice that rate: (648 + 480) / 2.  So
# the INT32 pipe's 648 bound a compression.
BLAKE2S_INT32_ONLY = 80 * 8 + 8
BLAKE2S_OPS = max(BLAKE2S_INT32_ONLY, 80 * 6, (BLAKE2S_INT32_ONLY + 80 * 6) / 2)
# of one M31 instruction as csrc/wtape.cu does it: add = add, subtract,
# minimum; sub = subtract, add, minimum; mul = low and high product, mask,
# funnel shift and add for the first fold, mask, shift and add for the second,
# subtract and minimum
M31_OPS = (3, 3, 10)


def card_rates():
    """Phase 1: set the INT32 rate from the card's SM count and maximum SM
    clock (``nvidia-smi --query-gpu=clocks.max.sm``); log it."""
    global INT32_OPS_PER_S
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    INT32_OPS_PER_S = 64 * sms * mhz * 1e6
    log(f"  INT32 rate {INT32_OPS_PER_S:.4e} op/s ({sms} SMs x 64 a clock x {mhz:.0f} "
        f"MHz); BLAKE2s compression {BLAKE2S_OPS:g} INT32-pipe operations")


# opcodes of the SASS by the pipe that issues them (compute capability 9.0)
SASS_INT32 = frozenset({"IADD3", "LOP3", "SHF", "PRMT", "ISETP", "LEA", "SEL", "IMNMX",
                        "IABS", "FLO", "POPC", "BREV", "PLOP3", "BMSK", "SGXT"})
SASS_FMA = frozenset({"IMAD", "IMUL", "FFMA", "FMUL", "FADD"})


def sass_counts():
    """--kernels: the one-block leaf kernel's instructions (one compression,
    no loop) by pipe in the built library's SASS (``cuobjdump -sass``),
    beside the function's count that the bounds use: how many operations
    the compiled code adds."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                             "cuobjdump")
    listing = subprocess.run([cuobjdump, "-sass", kernels.library_path()],
                             capture_output=True, text=True, check=True).stdout
    body = listing.split("blake2s_leaves_kernelILb0", 1)[1].split("Function :", 1)[0]
    instrs = re.findall(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[0-9T]\s+)?([A-Z][A-Z0-9_]*)"
                        r"[^;]*?(?:0x([0-9a-f]+))?\s*;", body)
    # up to the branch-to-self that pads the kernel's end
    end = next(i for i, (addr, op, to) in enumerate(instrs)
               if op == "BRA" and to and int(to, 16) == int(addr, 16))
    ops = [op for _, op, _ in instrs[:end]]
    int32, fma = sum(op in SASS_INT32 for op in ops), sum(op in SASS_FMA for op in ops)
    log(f"  kernel A's SASS, the one-block leaf kernel's lane: {int32} INT32-pipe, {fma} "
        f"FMA-pipe, {len(ops)} instructions in all; the function needs "
        f"{BLAKE2S_INT32_ONLY} INT32-pipe operations ({int32 / BLAKE2S_INT32_ONLY:.2f}x)")


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the least time the card could take."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def blake2s_bound(k: int, n: int, n_words: int = None):
    """Each lane reads K int64 words and writes 8, and runs one compression
    per 16 words of its message, the K words zero-padded to ``n_words``."""
    return bound((k + 8) * 8 * n, max(1, -(-(n_words or k) // 16)) * BLAKE2S_OPS * n)


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
# leaf digests; 2^24 and 2^23: the largest trees of fib(1M) (phase 10)
PYRAMID_TABLE = [1 << 24, 1 << 23, 1 << 21, 1 << 20, 1 << 14, 1 << 11, 1 << 9]
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
    instrs, out_regs = wtape._plan_arrays(plan, rows.shape[0], rows.device)
    cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(rows.device)
    return wtape.run_plan_plain(rows, cdev, instrs, out_regs, plan.n_regs, plan.width)


def _plan_line(name, plan, n):
    prog = wtape.kernel_program(plan)
    lanes = wtape.pick_lanes(prog.n_regs, n)
    return (f"  wtape {name:32s} S={plan.n_steps:3d} R={plan.n_regs:4d}->"
            f"{prog.n_regs:4d} B={len(plan.used_bank):3d} C={len(plan.consts):4d} "
            f"real={len(prog.op):4d}/{plan.n_steps * plan.width:4d} "
            f"n=2^{n.bit_length() - 1} lanes={lanes}")


def host_traces(pi, relations):
    """The witness traces, the tables' multiplicities counted on the host
    (the debug route: it raises on a lookup outside its table)."""
    comps = ComponentSet(relations)
    comps.write_traces(pi)
    return comps


def prover_traces(pi, relations):
    """The witness traces as the prover writes them: the tables'
    multiplicities counted on the card by `framework.TableCounter`, which
    drops a lookup outside its table as the reference's prover does."""
    comps = ComponentSet(relations)
    counter = framework.TableCounter(relations, *config.SCALE.key(), DEV)

    def count(comp):
        if comp.trace_rows is not None and not comp.zero_witness:
            counter.add(comp, upload_rows(comp.trace_rows, DEV))

    comps.write_traces(pi, on_component=count, table_counter=counter)
    return comps


def witness_plans(pi):
    """Every distinct plan of the witness: (name, plan, n lanes, constants)
    for the interaction, table-count and composition plan of each live
    component, at the domain sizes the prover runs them."""
    relations = Relations()
    return component_plans(relations, host_traces(pi, relations))


def component_plans(relations, comps):
    """`witness_plans` of components whose traces are written."""
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


def _variant(plan, n) -> str:
    """The kernel `wtape.run_plan` launches for this plan by its rule:
    the shared-memory kernel at 32 or 64 lanes a block, or the
    global-scratch kernel where the register file does not fit."""
    lanes = wtape.pick_lanes(wtape.kernel_program(plan).n_regs, n)
    return "global" if lanes is None else f"smem{lanes}"


def check_plans(jobs, gen, timed=(), require_smem=False):
    """Kernel B vs plain on every job (name, plan, n lanes, constants): the
    kernel the rule picks and the global-scratch kernel, forced, each bit
    for bit against the plain version on random bank rows, and both timed;
    the plain version is timed too for the plans named in ``timed``.
    ``require_smem``: the rule must pick the shared-memory kernel.
    -> rows keyed by launch shape (of plans that share a shape, the last
    one's)."""
    err = 0
    table = {}
    variants = {}
    plain_timed = set()
    for name, plan, n, consts in jobs:
        rows = _rand((len(plan.used_bank), n), (1 << 31) - 1, gen)
        variant = _variant(plan, n)
        variants[variant] = variants.get(variant, 0) + 1
        before = dict(kernels.launches)
        got = wtape.run_plan(rows, consts, plan)
        launched = "wtape_run_plan" if variant != "global" else "wtape_run_plan_global"
        if kernels.launches[launched] != before[launched] + 1:
            raise AssertionError(f"{name}: the rule's kernel ({variant}) did not launch")
        if require_smem and variant == "global":
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
               "bound_by": b_by, "max_abs_err": e, "variant": variant}
        table[wtape._launch_shape(plan, n)] = row
        line = (_plan_line(name, plan, n) + f" {variant}: max_abs_err={e}, kernel "
                f"{ms:.4f} ms, global-scratch kernel {global_ms:.4f} ms, bound "
                f"{b_ms:.5f} ms ({b_by}), kernel/bound {ms / b_ms:.2f}")
        if name in timed:  # the plain version is slow: the table's plans only
            row["plain_ms"] = time_ms(lambda: _plain(rows, consts, plan), reps=2)
            plain_timed.add(name)
            line += f", plain {row['plain_ms']:.4f} ms"
        log(line)
        if "--kernels" in sys.argv[1:]:
            _lanes_sweep(rows, consts, plan)
        del rows, got, want
    if err:
        raise AssertionError(f"wtape kernel disagrees with plain: {err}")
    log(f"  {len(jobs)} plans held to plain, each by the kernel the rule picks "
        f"and by the global-scratch kernel; the rule picked {variants}")
    missing = set(timed) - plain_timed
    if missing:
        raise AssertionError(f"plans of the kernel table not in the witness: {missing}")
    return table


def count_plan_launches(table, shapes, label, known=()):
    """Kernel B's rows (``check_plans``) against the launch shapes of a warm
    ``label`` proof: every wide-tape launch shape must be a row or in
    ``known``; each row gets its launches (either variant), and the rows
    timed beside plain are printed."""
    unknown = [k for k in shapes if k[0].startswith("wtape")
               and k[1:] not in table and k[1:] not in known]
    if unknown:
        raise AssertionError(f"the warm {label} proof ran plans not checked: {unknown}")
    for shape, row in table.items():
        row["launches"] = (shapes.get(("wtape_run_plan", *shape), 0)
                           + shapes.get(("wtape_run_plan_global", *shape), 0))
        if "plain_ms" in row:
            log(f"    wtape {row['name']} n=2^{shape[-1].bit_length() - 1}: "
                f"{row['ms']:.4f} ms ({row['variant']}; global-scratch kernel "
                f"{row['global_ms']:.4f} ms), bound {row['bound_ms']:.5f} ms "
                f"({row['bound_by']}), kernel/bound {row['ms'] / row['bound_ms']:.1f}, "
                f"plain {row['plain_ms']:.4f} ms, launches per warm {label} proof "
                f"{row['launches']}")


def phase_wtape(pi, gen):
    """Kernel B vs plain on every plan of the fib-100k witness, each timed
    (shared-memory kernel, global-scratch kernel; the table's plans also
    plain).  -> (rows keyed by launch shape, the synthetic plan's entry)."""
    table = check_plans(witness_plans(pi), gen, WTAPE_TABLE, require_smem=True)

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


def _golden_record(name):
    with open(os.path.join(GOLDEN_DIR, name)) as f:
        return json.load(f)


def _golden(name):
    return _golden_record(name)["sha256"]


def check_golden(label, cycles, digest, name):
    """A proof's cycles and digest against the JAX package's golden ``name``."""
    g = _golden_record(name)
    same = (cycles, digest) == (g["cycles"], g["sha256"])
    log(f"  {label}: {cycles} cycles, proof sha256 {digest} "
        f"({'equal to' if same else 'DIFFERENT from'} the reference's, {name})")
    if not same:
        raise AssertionError(f"{label}: the proof differs from the reference's")


def check_fib100k_digest(digest):
    """Phase 5's proof against the JAX package's proof of the same input."""
    want = _golden(FIB100K_GOLDEN)
    log(f"  fib-100k proof sha256 {digest} "
        f"({'equal to' if digest == want else 'DIFFERENT from'} the reference's {want})")
    if digest != want:
        raise AssertionError("the fib-100k proof differs from the reference's")


def phase_test_scale(label, make_input, framing, golden, devices=("cuda", "cpu")):
    """At test scale, the input ``make_input()`` proved on each of
    ``devices`` (the card first): the proofs byte-equal and equal to the
    reference digest ``golden``.  -> (the input, the card's proof, its
    config)."""
    config.set_test_scale(**TEST_SCALE)
    try:
        cfg = config.test_config(**TEST_CONFIG, framing=framing)
        pi = make_input()
        proofs, js = {}, {}
        for dev in devices:
            t = time.time()
            proofs[dev] = prove_cairo_m(pi, cfg, device=dev)
            js[dev] = json.dumps(proofs[dev].to_json_obj(), sort_keys=True)
            log(f"  {label} {framing} test scale on {dev}: {time.time() - t:.2f} s")
        if len(set(js.values())) > 1:
            raise AssertionError(f"{label} {framing} proof differs between CUDA and CPU")
        digest = hashlib.sha256(js["cuda"].encode()).hexdigest()
        log(f"  {label} {framing} proof sha256 {digest} (reference {_golden(golden)})")
        if digest != _golden(golden):
            raise AssertionError(f"{label} {framing} proof does not match the reference digest")
        return pi, proofs["cuda"], cfg
    finally:
        config.set_production_scale()


# the witnesses that keep every AIR component busy, and their reference
# digests (tests/golden/): sources, arguments and scales as plain data
WITNESSES_FILE = os.path.join(GOLDEN_DIR, "witnesses.json")
# kernel B's rows of PERF.md's table for the components fib-100k leaves idle
# (the table count of u32_store_div_rem_fp_fp counts its range_check_8 and
# range_check_16 lookups)
WTAPE_WITNESS_TABLE = ["allops: composition bitwise", "allops: interaction bitwise",
                       "allops: composition u32_store_div_rem_fp_fp",
                       "allops: table count u32_store_div_rem_fp_fp",
                       "allops: interaction range_check_16"]


def load_witnesses() -> dict:
    with open(WITNESSES_FILE) as f:
        return json.load(f)


def witness_input(w):
    """The port's own prover input of a witness (its compiler, or its ISA
    for an assembled program; the native VM core and adapter) at the
    current protocol scale."""
    if "program" in w:
        program = Program.from_json(json.dumps(w["program"]))
    elif "source_file" in w:
        with open(os.path.join(REPO, w["source_file"])) as f:
            program = compile_cairo(f.read(), w["source_file"]).program
    else:
        program = compile_cairo("\n".join(w["source"]) + "\n").program
    entrypoint = w.get("entrypoint", "main")
    slots = []  # call-slot encoding: a u32 is two 16-bit limbs, low first
    for p, a in zip(program.get_entrypoint(entrypoint).params, w["args"], strict=True):
        slots += [a & 0xFFFF, a >> 16] if p.ty.kind == "u32" else [a]
    return native_prover_input(program, entrypoint, slots)


def witness_golden(name, w, framing="native"):
    """The witness's reference digest, or None where none is committed."""
    kind = "production" if w["scale"] == "production" else "proof"
    stwo = "_stwo" if framing == "stwo" else ""
    path = os.path.join(GOLDEN_DIR, f"{name}{stwo}_{kind}_sha256.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["sha256"]


def _live(pi):
    return [c.name for c in host_traces(pi, Relations()).all if not c.zero_witness]


def phase_witnesses_test_scale(witnesses):
    """(a) Every test-scale witness proved on the card (the default device)
    under each framing it has a reference digest for: digest equal to the
    reference's, proof verified.  -> the plans of every witness (recorded
    at test scale) for kernel B's check."""
    config.set_test_scale(**TEST_SCALE)
    jobs = []
    try:
        for name, w in witnesses.items():
            if w["scale"] != "test":
                continue
            pi = witness_input(w)
            if _live(pi) != w["live"]:
                raise AssertionError(f"{name}: live components {_live(pi)} != {w['live']}")
            for framing in ("native", "stwo"):
                want = witness_golden(name, w, framing)
                if want is None:
                    continue
                cfg = config.test_config(**TEST_CONFIG, framing=framing)
                t = time.time()
                proof = prove_cairo_m(pi, cfg)
                prove_s = time.time() - t
                digest = _digest(proof.to_json_obj())
                ok = verify_cairo_m(proof, cfg)
                log(f"  {name} {framing} test scale ({pi.total_steps} cycles, "
                    f"{len(w['live'])} live components): {prove_s:.2f} s, verified "
                    f"{ok}, sha256 {digest} ({'equal to' if digest == want else 'DIFFERENT from'} "
                    f"the reference's)")
                if digest != want or not ok:
                    raise AssertionError(f"{name} {framing}: proof differs from the "
                                         "reference digest or did not verify")
            jobs += [(f"{name}: {job}", plan, n, consts)
                     for job, plan, n, consts in witness_plans(pi)]
    finally:
        config.set_production_scale()
    return jobs


def phase_witnesses_production(inputs):
    """The production witnesses at REGULAR_96_BITS on the card: ``allops``
    cold and warm, then each other one once; every digest equal to the
    reference's, every proof verified.  -> (launches of allops' proves and
    verify, its warm prove's launch shapes)."""
    launches = shapes = None
    for name, (w, pi) in inputs.items():
        if name == "allops":
            torch.cuda.reset_peak_memory_stats()
            with profile.cold_prover_caches():
                launches, shapes, proof = prove_full(
                    pi, config.REGULAR_96_BITS, name,
                    rejected=not w.get("verifies", True))
            peak = torch.cuda.max_memory_allocated()
            log(f"  {name}: peak device memory {peak / 2**30:.2f} GiB ({peak} bytes); "
                f"program id {proof.program_id()}")
        else:
            _, _, proof = prove_full(pi, config.REGULAR_96_BITS, name, runs=("first",),
                                     rejected=not w.get("verifies", True))
        digest = _digest(proof.to_json_obj())
        want = witness_golden(name, w)
        log(f"  {name}: proof sha256 {digest} "
            f"({'equal to' if digest == want else 'DIFFERENT from'} the reference's)")
        if digest != want:
            raise AssertionError(f"{name}: proof differs from the reference digest")
    return launches, shapes


def phase_witnesses(gen, witnesses):
    """Phase 5b: every AIR component on the card.  -> (launches of the
    allops path, kernel B's table rows)."""
    phase("  (a) test scale")
    jobs = phase_witnesses_test_scale(witnesses)
    inputs = {}
    prod_jobs = []
    for name, w in witnesses.items():
        if "source_file" in w:
            log(f"  {name}: the SHA-256 example, proved and its plans checked in "
                "phase 11 (--sha256)")
        elif w["scale"] == "production":
            pi = witness_input(w)
            if _live(pi) != w["live"]:
                raise AssertionError(f"{name}: live components {_live(pi)} != {w['live']}")
            inputs[name] = (w, pi)
            prod_jobs += [(f"{name}: {job}", plan, n, consts)
                          for job, plan, n, consts in witness_plans(pi)]
    phase("  (b) kernel B on every plan of every live component of the witnesses")
    seen, unique = set(), []
    # a plan that several witnesses share at one size is checked once, under
    # the first production witness that has it
    for job in prod_jobs + jobs:
        key = (job[0].split(": ", 1)[1], job[2], len(job[1].used_bank), job[1].n_regs)
        if key not in seen:
            seen.add(key)
            unique.append(job)
    table = check_plans(unique, gen, WTAPE_WITNESS_TABLE)
    # the opcode plans of the table run on a few rows in these witnesses:
    # their time at 2^20 lanes too, as a proof of that many rows would run
    # them
    for name, plan, n, consts in unique:
        if name in WTAPE_WITNESS_TABLE and n < 1 << 16:
            big = 1 << 20
            rows = _rand((len(plan.used_bank), big), (1 << 31) - 1, gen)
            e = max_abs_err(wtape.run_plan(rows, consts, plan), _plain(rows, consts, plan))
            if e:
                raise AssertionError(f"{name} at n=2^20: kernel disagrees with plain: {e}")
            cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(DEV)
            ms = time_ms(lambda: wtape.run_plan(rows, cdev, plan))
            plain_ms = time_ms(lambda: _plain(rows, consts, plan), reps=2)
            b_ms, b_by = wtape_bound(plan, big)
            log(_plan_line(name, plan, big) + f" {_variant(plan, big)}: max_abs_err={e}, "
                f"kernel {ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel/bound "
                f"{ms / b_ms:.2f}, plain {plain_ms:.4f} ms")
            del rows
    phase("  (c) production scale")
    launches, shapes = phase_witnesses_production(inputs)
    for name in PATH_KERNELS:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} never launched on the allops path")
    count_plan_launches(table, shapes, "allops")
    return launches, table


def prove_full(pi, cfg, label, runs=("cold", "warm"), rejected=False):
    """Prove on the card (the first proof of a process is cold: CUDA
    context, preprocessed commitment, plan recording) and verify.  The
    device is never named: the card is the entry points' default.
    ``rejected``: the verifier must reject the proof at the OODS check, as
    the reference's rejects the same bytes (a fault of both packages,
    tests/golden/witnesses.json).
    -> (launches, launch shapes of the last prove, the last proof)."""
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
    if rejected:
        try:
            verify_cairo_m(proof, cfg)
        except VerificationError as e:
            if "composition polynomial mismatch at OODS" not in str(e):
                raise
            ok = True
        else:
            raise AssertionError(f"{label}: the verifier accepted the proof that the "
                                 "reference's rejects")
    else:
        ok = verify_cairo_m(proof, cfg)
    verify_s = time.time() - t
    launches = dict(kernels.launches)
    if not ok:
        raise AssertionError(f"{label} proof did not verify")
    n = pi.total_steps
    outcome = ("rejected at the OODS check, as the reference's verifier rejects it"
               if rejected else "verified")
    log(f"  {label}: {outcome} in {verify_s:.3f} s; {n} cycles; "
        + ", ".join(f"{run} {n / t:.1f} cycles/s" for run, t in secs.items()))
    log(f"  {label} launches: {launches}")
    return launches, shapes, proof


def _cli(*argv, timeout=900, out=None):
    """Run the port's command line in a process that cannot import JAX nor
    the JAX package; raise unless it exits with 0.  Its lines go to ``out``
    (a list) where given, else to the log."""
    t = time.time()
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_MODULE.format(
            repo=REPO, module="cairo_m_tpu_torch.cli", argv=list(argv))],
        capture_output=True, text=True, cwd=REPO, timeout=timeout,
    )
    lines = [f"  cli {argv[0]} ({time.time() - t:.2f} s, rc {res.returncode}):"]
    lines += [f"    {line}" for line in (res.stdout + res.stderr).strip().splitlines()]
    if out is None:
        for line in lines:
            log(line)
    else:
        out += lines
    if res.returncode != 0:
        raise AssertionError(f"cli {' '.join(argv)} exited with {res.returncode}\n"
                             + "\n".join(lines))
    return res


def _launch_records(stderr: str) -> list:
    """The ``kernel launches {...}`` records a child process printed, in
    order (one a proof)."""
    return [json.loads(m.group(1))
            for m in re.finditer(r"kernel launches (\{.*\})", stderr)]


def _sum_launches(records) -> dict:
    total = dict.fromkeys(kernels.launches, 0)
    for rec in records:
        for k, n in rec.items():
            total[k] += n
    return total


def _cli_launches(res):
    """Kernel launches the prove command reports for its segments."""
    return _sum_launches(_launch_records(res.stderr))


def _cli_chain(tmp, prog, framing, arg, max_steps, n_segments, check, lines):
    """``prove`` then ``verify`` of one framing through the command line;
    -> the prove's kernel launches."""
    out = os.path.join(tmp, f"{framing}.json")
    # no --device: the command line's default is the card
    res = _cli("prove", prog, "--arguments", arg, "--max-steps", max_steps,
               "--framing", framing, *check, "-o", out, out=lines)
    launches = _cli_launches(res)
    verified = [f"segment {i}: verified=True" for i in range(n_segments)]
    if check and [l for l in res.stdout.splitlines() if "verified=" in l] != verified:
        raise AssertionError(f"cli prove {framing}: not every segment verified")
    res = _cli("verify", out, out=lines)
    ok = [f"segment {i}: OK" for i in range(n_segments)] + ["proof verified"]
    if res.stdout.strip().splitlines() != ok:
        raise AssertionError(f"cli verify {framing}: {res.stdout!r}")
    return launches


def phase_cli(tmp, witnesses):
    """prove / verify through the command line, in subprocesses: the native
    and the stwo prove -> verify chains, phase 11(d)'s chain of the SHA-256
    example and phase 14(c)'s of a WASM module run side by side (each is
    mostly one process's cold start, host-side stwo trees or host
    verification), each chain's lines printed when it ends."""
    src, prog = os.path.join(tmp, "fib.cm"), os.path.join(tmp, "fib.json")
    with open(src, "w") as f:
        f.write(FIB_SRC)
    _cli("compile", src, "-o", prog)
    # the stwo proof is checked by `verify` alone: its host-side
    # verification costs tens of seconds on the card's machine
    chains = {"native": ("2000", "10000", 2, ["--verify"]),
              "stwo": ("100", "50000", 1, [])}
    lines = {name: [] for name in (*chains, "sha256", "wasm")}
    sha_tmp, wasm_tmp = os.path.join(tmp, "sha256"), os.path.join(tmp, "wasm")
    os.makedirs(sha_tmp)
    os.makedirs(wasm_tmp)
    with ThreadPoolExecutor(len(lines)) as pool:
        futures = {framing: pool.submit(_cli_chain, tmp, prog, framing, *args,
                                        lines[framing])
                   for framing, args in chains.items()}
        futures["sha256"] = pool.submit(phase_sha256_cli, sha_tmp, witnesses,
                                        lines["sha256"])
        futures["wasm"] = pool.submit(phase_wasm_cli, wasm_tmp, lines["wasm"])
        launches = {}
        for name, fut in futures.items():
            try:
                launches[name] = fut.result()
            finally:
                if name == "sha256":
                    log("  phase 11(d), the README's commands of the SHA-256 example:")
                if name == "wasm":
                    log("  phase 14(c), a WASM module through the command line:")
                for line in lines[name]:
                    log(line)
    log(f"  cli prove launches: {launches}")
    if (min(launches["native"][k] for k in PATH_KERNELS) <= 0
            or launches["stwo"]["wtape_run_plan"] <= 0):
        raise AssertionError("a kernel never launched in the cli's proofs")
    return {k: sum(c[k] for c in launches.values()) for k in launches["native"]}


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


def run_chain(devices, n_processes):
    """fibonacci(600,000) in 5 segments at REGULAR_96_BITS, worker i on
    ``devices[i % len(devices)]``; every segment verified and every kernel
    of the path launched in it; rates as scripts/bench_segments.py defines
    them.  -> (records, wall seconds)."""
    t = time.time()
    records = prove_segments_multiprocess(
        FIB_SRC, "main", [WORKERS_ITERS], SEGMENT_CAP, devices=devices,
        n_processes=n_processes, timeout=900,
    )
    wall = time.time() - t
    for r in records:
        log(f"  segment {r['segment']} (worker {r['worker']} on {r['device']}): "
            f"{r['n_steps']} cycles, prove {r['prove_s']:.3f} s, verify "
            f"{r['verify_s']:.3f} s, peak device memory "
            f"{r['peak_bytes'] / 2**30:.2f} GiB, launches {r['launches']}")
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
    warm_cps = (f"{sum(r['n_steps'] for r in warm) / sum(r['prove_s'] for r in warm):.1f}"
                if warm else "no")
    log(f"  chain on {n_processes} workers ({sorted(set(map(str, devices)))}): "
        f"{len(records)} segments, {total} cycles, root chain ok, all verified; "
        f"{total / prove_s:.1f} cycles/s over prove seconds ({prove_s:.3f} s), "
        f"warm {warm_cps} cycles/s over {len(warm)} segments; wall {wall:.2f} s "
        f"({total / wall:.1f} cycles/s end to end, VM, proving and verifying)")
    return records, wall


def check_chain_golden(records):
    """The chain's segments against the JAX package's: every segment's
    cycles and memory roots, and the digests of the segments it proved."""
    segments = _golden_record(CHAIN_GOLDEN)["segments"]
    if len(records) != len(segments):
        raise AssertionError(f"{len(records)} chain segments, the reference's "
                             f"{len(segments)}")
    for want in segments:
        r = records[want["segment"]]
        got = (r["n_steps"], r["initial_root"], r["final_root"])
        same = got == (want["n_steps"], want["initial_root"], want["final_root"])
        line = (f"  segment {r['segment']}: {r['n_steps']} cycles, roots "
                f"{r['initial_root']} -> {r['final_root']} "
                f"({'equal to' if same else 'DIFFERENT from'} the reference's)")
        if "sha256" in want:
            digest = _digest(r["proof"])
            same = same and digest == want["sha256"]
            line += (f"; proof sha256 {digest} "
                     f"({'equal to' if digest == want['sha256'] else 'DIFFERENT from'} "
                     "the reference's)")
        log(line)
        if not same:
            raise AssertionError(f"chain segment {r['segment']} differs from the reference's")


def phase_segments_full():
    """8(b): the chain on two workers on the card, held to the reference;
    -> its launches."""
    records, _ = run_chain([str(DEV)], 2)
    check_chain_golden(records)
    launches = dict.fromkeys(kernels.launches, 0)
    for r in records:
        for k, n in r["launches"].items():
            launches[k] += n
    return launches


def phase_upload_routes(pi, reps: int = 3):
    """The witness's two upload routes on the card, best of ``reps``:
    ``upload_rows`` (int32 copy, widened on the card) and colpack (host
    classify, packed copy, unpack on the card).  Both must rebuild the same
    stacks."""
    comps = ComponentSet(Relations())
    comps.write_traces(pi)
    live = [c for c in comps.all if not c.zero_witness and c.trace_rows]
    best = {}

    def keep(key, v):
        best[key] = min(best.get(key, v), v)

    for _ in range(reps):
        raw = packed = 0
        for comp in live:
            rows, m = comp.trace_rows, comp.non_padded_length
            torch.cuda.synchronize()
            t = time.perf_counter()
            plain = upload_rows(rows, DEV)
            torch.cuda.synchronize()
            t_rows = time.perf_counter() - t
            raw += 4 * len(rows) * int(rows[0].shape[0])  # int32 on the link
            t = time.perf_counter()
            kinds, planes = colpack.classify(rows, m)
            t_classify = time.perf_counter() - t
            packed += sum(int(b.nbytes) for b in planes)
            torch.cuda.synchronize()
            t = time.perf_counter()
            dev_planes = colpack._planes_to_device(planes, DEV)
            torch.cuda.synchronize()
            t_copy = time.perf_counter() - t
            t = time.perf_counter()
            rebuilt = colpack._unpack(kinds, dev_planes, int(rows[0].shape[0]), DEV)
            torch.cuda.synchronize()
            t_unpack = time.perf_counter() - t
            if not torch.equal(rebuilt, plain):
                raise AssertionError(f"colpack rebuilt {comp.name} wrong")
            for key, v in (("rows", t_rows), ("classify", t_classify),
                           ("copy", t_copy), ("unpack", t_unpack)):
                best[key + "_sum"] = best.get(key + "_sum", 0.0) + v
        for key in ("rows", "classify", "copy", "unpack"):
            keep(key, best.pop(key + "_sum"))
    colpack_s = best["classify"] + best["copy"] + best["unpack"]
    log(f"  upload routes, fib-100k witness ({len(live)} components, best of "
        f"{reps}): upload_rows {raw} bytes in {best['rows']:.4f} s; colpack "
        f"classify {best['classify']:.4f} s (host), {packed} packed bytes, copy "
        f"{best['copy']:.4f} s, unpack {best['unpack']:.4f} s: {colpack_s:.4f} s; "
        f"faster: {'upload_rows' if best['rows'] <= colpack_s else 'colpack'}")


def _rank_lines(label, records):
    for r in records:
        for i, run in enumerate(r["runs"]):
            ex = run["exchange"]
            log(f"  {label} rank {r['rank']} ({r['device']}, {r['backend']}) "
                f"run {i}: {run['seconds']:.3f} s, phases "
                + json.dumps({k: round(v, 4) for k, v in run["phases"].items()})
                + f"; exchanges {ex['exchanges']}, {ex['bytes']} bytes sent, "
                f"{ex['seconds']:.3f} s; launches {run['launches']}")


def phase_sharded_test_scale(world_size=2, backend="gloo", devices=(str(DEV),)):
    """(a) fib-40 at test scale on ``world_size`` ranks: every rank's proof
    equal to the reference digest."""
    t = time.time()
    records = []
    proof = prove_sharded(
        FIB_SRC, "main", [40], world_size=world_size, backend=backend,
        devices=list(devices), config=config.test_config(**TEST_CONFIG),
        test_scale=TEST_SCALE, records=records, timeout=300)
    _rank_lines("fib-40", records)
    got = [_digest(r["proof"]) for r in records]
    want = _golden("fib40_proof_sha256.json")
    log(f"  fib-40 sharded, {world_size} ranks on {sorted(set(devices))} under "
        f"{backend}, {time.time() - t:.2f} s: digests {got} (reference {want})")
    if got != [want] * world_size or _digest(proof.to_json_obj()) != want:
        raise AssertionError("sharded fib-40 proofs do not match the reference digest")


def _sharded_full(world_size, backend, devices, want_digest, single_peak,
                  iters=100_000, golden=FIB100K_GOLDEN, timeout=900):
    """fibonacci(``iters``) at REGULAR_96_BITS on ``world_size`` ranks: a
    cold and a warm prove per rank, every rank's proof equal to
    ``want_digest`` (the single card's) and to ``golden``, verified, each
    rank's peak device memory below ``single_peak``; one line a rank.
    -> launches summed over ranks and runs."""
    label = f"fib({iters})"
    t = time.time()
    records = []
    proof = prove_sharded(
        FIB_SRC, "main", [iters], world_size=world_size, backend=backend,
        devices=devices, config=config.REGULAR_96_BITS, runs=2,
        records=records, timeout=timeout)
    wall = time.time() - t
    _rank_lines(label, records)
    digests = [_digest(r["proof"]) for r in records]
    digest = _digest(proof.to_json_obj())
    golden_digest = _golden(golden)
    log(f"  {label} sharded, {world_size} ranks on {devices} under {backend}, wall "
        f"{wall:.2f} s: every rank's proof sha256 {digest} "
        f"({'equal to' if digest == want_digest else 'DIFFERENT from'} the single "
        f"card's, {'equal to' if digest == golden_digest else 'DIFFERENT from'} "
        f"{golden})")
    if digests != [digest] * world_size or digest != want_digest:
        raise AssertionError("the sharded proof differs from the single-device proof")
    if digest != golden_digest:
        raise AssertionError(f"the sharded proof differs from {golden}")
    t = time.time()
    if not verify_cairo_m(proof, config.REGULAR_96_BITS):
        raise AssertionError("the sharded proof did not verify")
    log(f"  verified in {time.time() - t:.3f} s")
    for r in records:
        cold, warm = r["runs"][0], r["runs"][-1]
        peak, ex = r["max_memory_allocated"], warm["exchange"]
        log(f"  rank {r['rank']} on {r['device']} ({backend}, {world_size} ranks): "
            f"cold {cold['seconds']:.3f} s, warm {warm['seconds']:.3f} s "
            f"({r['n_steps'] / warm['seconds']:.1f} cycles/s); peak device memory "
            f"{peak / 2**30:.2f} GiB ({peak} bytes) against {single_peak / 2**30:.2f} "
            f"GiB on a single card; host peak {r['host_peak_bytes'] / 2**30:.2f} GiB; "
            f"warm exchanges {ex['exchanges']}, {ex['bytes']} bytes, "
            f"{ex['seconds']:.3f} s; warm launches {warm['launches']}")
        for name in PATH_KERNELS:
            if warm["launches"][name] <= 0:
                raise AssertionError(f"kernel {name} never launched in rank {r['rank']}")
        if peak >= single_peak:
            raise AssertionError(f"rank {r['rank']} peak {peak} is not below the "
                                 f"single-device peak {single_peak}")
    launches = dict.fromkeys(kernels.launches, 0)
    for r in records:
        for run in r["runs"]:
            for k, n in run["launches"].items():
                launches[k] += n
    return launches


def phase_sharded_full(single_digest, single_peak):
    """(b) two gloo ranks on the card (NCCL, one card a rank: phase 13)."""
    return _sharded_full(2, "gloo", [str(DEV)], single_digest, single_peak)


FIB1M_ITERS = 1_000_000  # fibonacci(1,000,000) = 8,000,010 cycles, one segment
FIB1M_GOLDEN = "fib1m_card_proof_sha256.json"
# kernel B's plans that fib(1M) runs at sizes no other phase gives them:
# their plain version is timed too
WTAPE_FIB1M_TABLE = ["composition store_add_fp_imm", "interaction store_add_fp_imm"]
# a module run as `python -m` in a fresh interpreter that cannot import JAX
# or the JAX package
_NO_JAX_MODULE = """
import runpy, sys
sys.modules["jax"] = None
sys.modules["cairo_m_tpu"] = None
sys.path.insert(0, {repo!r})
sys.argv = [{module!r}, *{argv!r}]
try:
    runpy.run_module({module!r}, run_name="__main__")
finally:
    loaded = [m for m, v in sys.modules.items()
              if v is not None and m.split(".")[0] in ("jax", "cairo_m_tpu")]
    if loaded:
        raise SystemExit(f"modules of JAX or of the JAX package were loaded: {{loaded}}")
"""


def _parse_shapes(shapes: dict) -> dict:
    """The profile's "name,*shape" keys -> (name, *shape) tuples."""
    out = {}
    for key, n in shapes.items():
        name, *dims = key.split(",")
        out[(name, *map(int, dims))] = n
    return out


def phase_fib1m_prove(tmp):
    """(a) ``python -m cairo_m_tpu_torch.profile prove --iters 1000000 --runs
    cold,warm --verify`` in a fresh process: its proof equal to the committed
    card digest and verified; -> (its summary entry, the warm proof's
    launch shapes)."""
    torch.cuda.empty_cache()  # the child gets the card's memory
    argv = ["prove", "--iters", str(FIB1M_ITERS), "--runs", "cold,warm",
            "--verify", "--save-proof", tmp]
    t = time.time()
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_MODULE.format(
            repo=REPO, module="cairo_m_tpu_torch.profile", argv=argv)],
        capture_output=True, text=True, cwd=REPO, timeout=900,
    )
    lines = res.stdout.strip().splitlines()
    # everything but the JSON summary, which the lines below condense
    for line in lines[:-1]:
        log(f"    {line}")
    if res.returncode != 0:
        log(res.stderr[-4000:])
        raise AssertionError(f"the profile command exited with {res.returncode}")
    (entry,) = json.loads(lines[-1])["fib"]
    want = _golden(FIB1M_GOLDEN)
    with open(entry["saved"]) as f:
        saved = hashlib.sha256(f.read().encode()).hexdigest()
    log(f"  fib({FIB1M_ITERS}) in a fresh process, {time.time() - t:.1f} s: "
        f"{entry['cycles']} cycles, native VM + adapter {entry['adapter_s']:.3f} s "
        f"(host max RSS {entry['host_max_rss_gib']:.2f} GiB)")
    for run, rec in entry["runs"].items():
        log(f"  fib({FIB1M_ITERS}) {run}: {rec['seconds']:.3f} s, "
            f"{rec['cycles_per_s']:.1f} cycles/s, peak device memory "
            f"{rec['peak_device_bytes'] / 2**30:.2f} GiB ({rec['peak_device_bytes']} "
            f"bytes), launches {rec['launches']}")
    log(f"  fib({FIB1M_ITERS}) log sizes {json.dumps(entry['log_sizes'])}")
    log(f"  fib({FIB1M_ITERS}) proof sha256 {entry['sha256']} "
        f"({'equal to' if entry['sha256'] == want == saved else 'DIFFERENT from'} "
        f"the committed card digest {want}); verified {entry['verified']} in "
        f"{entry['verify_s']:.3f} s")
    if entry["sha256"] != want or saved != want:
        raise AssertionError("the fib(1M) proof differs from the committed digest")
    if not entry["verified"]:
        raise AssertionError("the fib(1M) proof did not verify")
    if entry["cycles"] != 8_000_010 or max(entry["log_sizes"].values()) != 22:
        raise AssertionError("fib(1M) is not the 8,000,010-cycle, 2^22-row run")
    warm = entry["runs"]["warm"]
    for name in PATH_KERNELS:
        if warm["launches"][name] <= 0:
            raise AssertionError(f"kernel {name} never launched in the warm fib(1M) proof")
    return entry, _parse_shapes(warm["launch_shapes"])


# the leaf shapes and tree sizes `check_tree_shapes` has checked in this run
TREES_CHECKED = set()


def check_tree_shapes(gen, shapes, label, min_lanes=0):
    """The leaf kernel on every leaf launch shape in ``shapes`` of more than
    ``min_lanes`` lanes (timed beside plain and its bound) and the pyramid
    kernel on every tree size, each against plain, once a run (a shape an
    earlier path checked is skipped); the pyramid's launches per tree.
    -> leaves -> trees of that size in ``shapes``."""
    checked = TREES_CHECKED
    trees = {}
    for key, count in sorted(shapes.items()):
        if key[0] != "blake2s_leaves":
            continue
        k, n_words, n = key[1:]
        trees[n] = trees.get(n, 0) + count
        if n <= min_lanes or key in checked:
            continue
        checked.add(key)
        cols = _rand((k, n), (1 << 31) - 1, gen)
        # the plain version takes up to seconds: its one call is the timed one
        want, plain_ms = timed_call(lambda: torch.stack(blake2s.hash_words(list(cols),
                                                                           n_words)))
        e = max_abs_err(blake2s.hash_leaves(cols, n_words), want)
        if e:
            raise AssertionError(f"blake2s kernel disagrees with plain at {key}: {e}")
        ms = time_ms(lambda: blake2s.hash_leaves(cols, n_words))
        dev_ms = time_ms(lambda: blake2s.hash_leaves(cols, n_words), queued=True)
        b_ms, b_by = blake2s_bound(k, n, n_words)
        log(f"    blake2s K={k} (words {n_words}) n=2^{n.bit_length() - 1}: "
            f"max_abs_err={e}, kernel {ms:.4f} ms ({dev_ms:.4f} ms queued), plain "
            f"{plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), kernel/bound "
            f"{ms / b_ms:.2f}, launches per warm {label} proof {count}")
        del cols, want
    for m in sorted(trees):
        if ("blake2s_pyramid", m) in checked:
            continue
        checked.add(("blake2s_pyramid", m))
        packed = torch.zeros((8, 2 * m - 1), dtype=torch.int64, device=DEV)
        packed[:, :m] = _rand((8, m), 1 << 32, gen)
        e = max_abs_err(blake2s.merkle_pyramid(packed.clone()),
                        blake2s.merkle_pyramid_plain(packed.clone()))
        if e:
            raise AssertionError(f"pyramid kernel disagrees with plain at m={m}: {e}")
        log(f"    blake2s pyramid m=2^{m.bit_length() - 1}: max_abs_err={e}, "
            f"{blake2s.pyramid_launches(m)} launches a tree, {trees[m]} trees per "
            f"warm {label} proof")
        del packed
    want = sum(c * blake2s.pyramid_launches(n) for n, c in trees.items())
    got = sum(c for key, c in shapes.items() if key[0] == "blake2s_pyramid")
    log(f"  device trees of the warm {label} proof by leaves: "
        + ", ".join(f"2^{n.bit_length() - 1}: {c}" for n, c in sorted(trees.items()))
        + f"; {sum(trees.values())} leaf launches, {got} pyramid launches")
    if got != want:
        raise AssertionError(f"{got} pyramid launches in the {label} proof, expected {want}")
    return trees


def phase_fib1m_kernels(gen, program, shapes, table_p, known=None):
    """(b) the kernels at the sizes fib(1M) gives them: kernel B on every
    plan of the fib(1M) witness (both variants, vs plain) but those of a
    launch shape in ``known`` (phase 3's rows: the same plan at the same
    size), the leaf kernel on every leaf shape of the warm proof beyond
    2^20 lanes and the pyramid kernel on every tree size (`check_tree_shapes`);
    every launch shape of the warm proof must have been checked.  -> kernel
    B's rows keyed by launch shape."""
    known = known or {}
    t = time.time()
    pi = native_prover_input(program, "main", [FIB1M_ITERS])
    log(f"  fib({FIB1M_ITERS}) native VM + adapter in this process: "
        f"{time.time() - t:.3f} s")
    jobs = [j for j in witness_plans(pi)
            if wtape._launch_shape(j[1], j[2]) not in known]
    del pi
    log(f"  {len(jobs)} plans of the fib(1M) witness at sizes phase 3 did not check")
    table = check_plans(jobs, gen, WTAPE_FIB1M_TABLE, require_smem=True)
    count_plan_launches(table, shapes, f"fib({FIB1M_ITERS})", known)
    # leaf shapes of up to 2^20 lanes are the fib-100k proof's: phase 2
    trees = check_tree_shapes(gen, shapes, f"fib({FIB1M_ITERS})", min_lanes=1 << 20)
    for m, row in table_p.items():
        row["launches_fib1m"] = trees.get(m, 0)
        log(f"    blake2s pyramid m=2^{m.bit_length() - 1}: {row['ms']:.4f} ms, "
            f"bound {row['bound_ms']:.5f} ms, trees of this size per warm fib(1M) "
            f"proof {row['launches_fib1m']}")
    return table


def phase_fib1m(gen, program, table_p, known=None):
    """Phase 10; -> the launches of the warm fib(1M) proof."""
    with tempfile.TemporaryDirectory() as tmp:
        entry, shapes = phase_fib1m_prove(tmp)
    phase("  (b) the kernels at the sizes of fib(1M)")
    phase_fib1m_kernels(gen, program, shapes, table_p, known)
    return entry["runs"]["warm"]["launches"]


SHA256_FILE = os.path.join("examples", "sha256", "sha256.cm")
SHA256_MESSAGES = {
    "main": b"abc",
    # word j of block i is i*16 + j, big-endian: 16 blocks, 1 KiB
    "bench1k": b"".join(i.to_bytes(4, "big") for i in range(256)),
}
# the proofs of phase 11(b), in order: bench1k's cold proof is the first
# proof of the process under --sha256
SHA256_RUNS = {"bench1k": ("cold", "warm", "warm"), "main": ("cold", "warm")}


def _sha256_words(data: bytes) -> list:
    d = hashlib.sha256(data).digest()
    return [int.from_bytes(d[i:i + 4], "big") for i in range(0, 32, 4)]


def _return_words(pi) -> list:
    """The u32 return values of a native prover input, read from its
    output cells (two 16-bit limbs each, low first)."""
    slots = [pi.final_memory[a][0][0] for a in pi.public_address_ranges.output]
    return [lo | hi << 16 for lo, hi in zip(slots[::2], slots[1::2])]


def phase_sha256_runs(program, witnesses):
    """(a) Both entry points by the native VM + adapter: the return values
    equal to hashlib's digest, the live components those of the witnesses.
    -> entry point -> prover input."""
    inputs = {}
    for ep, msg in SHA256_MESSAGES.items():
        t = time.time()
        pi = native_prover_input(program, ep, [])
        secs = time.time() - t
        got, want = _return_words(pi), _sha256_words(msg)
        log(f"  sha256 {ep}: {pi.total_steps} cycles, native VM + adapter "
            f"{secs:.3f} s; returns {[f'{w:08x}' for w in got]} "
            f"({'equal to' if got == want else 'DIFFERENT from'} hashlib's)")
        if got != want:
            raise AssertionError(f"sha256 {ep}: the VM's digest differs from hashlib's")
        if _live(pi) != witnesses[f"sha256_{ep}"]["live"]:
            raise AssertionError(f"sha256 {ep}: live components {_live(pi)}")
        inputs[ep] = pi
    return inputs


def phase_sha256_proofs(inputs, witnesses):
    """(b) Each entry point proved cold and warm at REGULAR_96_BITS
    (`profile.timed_prove`), every digest equal to the golden; bench1k's
    last proof verified (its others are the same bytes; main's are those
    that (d) verifies); then bench1k traced and per component.  -> (launches summed
    over the proofs of (b)'s runs, the warm bench1k proof's launch
    shapes)."""
    cfg = config.REGULAR_96_BITS
    launches = dict.fromkeys(kernels.launches, 0)
    shapes = None
    for ep, runs in SHA256_RUNS.items():
        pi = inputs[ep]
        name = f"sha256_{ep}"
        want = witness_golden(name, witnesses[name])
        for run in runs:
            with contextlib.ExitStack() as stack:
                if run == "cold":
                    stack.enter_context(profile.cold_prover_caches())
                proof, rec = profile.timed_prove(pi, cfg, DEV)
            digest = _digest(proof.to_json_obj())
            log(f"  sha256 {ep} {run} prove: {rec['seconds']:.3f} s, "
                f"{rec['cycles_per_s']:.1f} cycles/s; phases "
                + json.dumps({k: round(v, 4) for k, v in rec["phases"].items()})
                + f"; peak device memory {rec['peak_device_bytes'] / 2**30:.2f} GiB "
                f"({rec['peak_device_bytes']} bytes); launches {rec['launches']}; "
                f"sha256 {digest} "
                f"({'equal to' if digest == want else 'DIFFERENT from'} the reference's)")
            if digest != want:
                raise AssertionError(f"sha256 {ep}: the proof differs from the golden")
            for k, n in rec["launches"].items():
                launches[k] += n
            if run == "warm":
                for k in PATH_KERNELS:
                    if rec["launches"][k] <= 0:
                        raise AssertionError(f"kernel {k} never launched in the warm "
                                             f"sha256 {ep} proof")
                if rec["launches"]["wtape_run_plan_global"]:
                    raise AssertionError("a sha256 plan took the global-scratch kernel")
                if ep == "bench1k":
                    shapes = _parse_shapes(rec["launch_shapes"])
        log(f"  sha256 {ep} log sizes {json.dumps(profile.log_sizes(proof))}")
        if ep == "main":
            # the same bytes (equal digests) as (d)'s, which the command
            # line verifies twice
            continue
        t = time.time()
        if not verify_cairo_m(proof, cfg):
            raise AssertionError(f"sha256 {ep}: the proof did not verify")
        log(f"  sha256 {ep}: verified in {time.time() - t:.3f} s")
    pi = inputs["bench1k"]
    profile.log_trace("sha256 bench1k", profile.trace_prove(pi, cfg, DEV))
    log("  sha256 bench1k per component (a warm-up proof, then one synced around "
        "every component):")
    profile.component_report(pi, cfg, DEV)
    return launches, shapes


def phase_sha256_kernels(gen, pi, shapes, known=None):
    """(c) Kernel B on every plan of bench1k's live components at their
    sizes, but those of a launch shape in ``known`` (phase 3's rows); the
    u32 and bitwise plans timed beside plain; every wide-tape launch shape
    of the warm proof checked; the trees' kernels on every leaf shape and
    tree size of the warm proof.  -> kernel B's rows keyed by launch
    shape."""
    known = known or {}
    jobs = [j for j in witness_plans(pi) if wtape._launch_shape(j[1], j[2]) not in known]
    timed = [j[0] for j in jobs if j[0].split()[-1].startswith(("u32_", "bitwise"))]
    log(f"  {len(jobs)} plans of the bench1k witness at sizes phase 3 did not check")
    table = check_plans(jobs, gen, timed, require_smem=True)
    count_plan_launches(table, shapes, "bench1k", known)
    check_tree_shapes(gen, shapes, "bench1k")
    return table


def phase_sha256_cli(tmp, witnesses, lines=None):
    """(d) The README's chain through the command line, in subprocesses:
    compile, run, prove --verify on the card, verify; its lines go to
    ``lines`` (a list) where given, else to the log.  -> the prove's
    launches."""
    prog, out = os.path.join(tmp, "sha256.json"), os.path.join(tmp, "proof.json")
    _cli("compile", SHA256_FILE, "-o", prog, out=lines)
    res = _cli("run", prog, "--entrypoint", "main", out=lines)
    if res.stdout.strip() != str(_sha256_words(SHA256_MESSAGES["main"])):
        raise AssertionError(f"cli run: {res.stdout!r} is not SHA-256(abc)")
    res = _cli("prove", prog, "--entrypoint", "main", "--output", out, "--verify",
               "--device", "cuda", out=lines)
    launches = _cli_launches(res)
    if "segment 0: verified=True" not in res.stdout.splitlines():
        raise AssertionError("cli prove: the proof did not verify")
    with open(out) as f:
        (segment,) = json.load(f)["segments"]
    digest = _digest(segment)
    want = witness_golden("sha256_main", witnesses["sha256_main"])
    line = (f"  cli proof file: segment sha256 {digest} "
            f"({'equal to' if digest == want else 'DIFFERENT from'} the reference's); "
            f"prove launches {launches}")
    if lines is None:
        log(line)
    else:
        lines.append(line)
    if digest != want:
        raise AssertionError("the cli's proof of sha256 main differs from the golden")
    res = _cli("verify", out, "--device", "cuda", out=lines)
    if res.stdout.strip().splitlines() != ["segment 0: OK", "proof verified"]:
        raise AssertionError(f"cli verify: {res.stdout!r}")
    for k in PATH_KERNELS:
        if launches[k] <= 0:
            raise AssertionError(f"kernel {k} never launched in the cli's proof")
    return launches


def phase_sha256(gen, known=None, cli=True):
    """Phase 11; ``cli``: run (d) here (the full run runs it in phase 7,
    beside the other command-line chains).  -> (the launches of (b)'s
    proofs, kernel B's rows of (c))."""
    witnesses = load_witnesses()
    with open(os.path.join(REPO, SHA256_FILE)) as f:
        program = compile_cairo(f.read(), SHA256_FILE).program
    phase("  (a) both entry points against hashlib")
    inputs = phase_sha256_runs(program, witnesses)
    phase("  (b) proofs on the card")
    launches, shapes = phase_sha256_proofs(inputs, witnesses)
    phase("  (c) the kernels at bench1k's shapes")
    table = phase_sha256_kernels(gen, inputs["bench1k"], shapes, known)
    del inputs
    if not cli:
        log("  (d) the README's commands ran in phase 7")
        return launches, table
    phase("  (d) the README's commands")
    with tempfile.TemporaryDirectory() as tmp:
        phase_sha256_cli(tmp, witnesses)
    return launches, table


# phase 14: the WASM frontend's programs, each held to the JAX package's
# proof (the module's bytes, entry point and arguments are in its golden)
WASM_TEST_GOLDEN = "wasm_memrw_proof_sha256.json"
WASM_GOLDENS = ("wasm_memrw_production_sha256.json", "wasm_sumsq_production_sha256.json")


def wasm_input(g):
    """The port's prover input of a WASM golden: its WASM frontend, native
    VM core and adapter, at the current protocol scale."""
    program = compile_wasm(bytes.fromhex(g["module_hex"])).program
    return native_prover_input(program, g["entrypoint"], g["args"])


def check_verdict(proof, cfg, g, label, device=DEV):
    """Verify; the outcome must be the golden ``g``'s: ``verifies``, or a
    rejection with the message the reference's verifier gave
    (``rejected_with``).  -> seconds."""
    t = time.time()
    try:
        ok, reason = verify_cairo_m(proof, cfg, device=device), None
    except VerificationError as e:
        ok, reason = False, str(e)
    secs = time.time() - t
    log(f"  {label}: verified {ok} in {secs:.3f} s"
        + (f", rejected: {reason}" if reason else "")
        + f" (the reference's verifier: {g['verifies']}"
        + (f", rejected: {g['rejected_with']})" if not g["verifies"] else ")"))
    if ok != g["verifies"] or reason != g.get("rejected_with"):
        raise AssertionError(f"{label}: the port's verdict is not the reference's")
    return secs


def phase_wasm_test_scale():
    """(a) Both modules compiled by the port's WASM frontend; memrw at test
    scale proved on the card: equal to the golden (which the port's CPU
    proof equals in tests/test_torch_wasm.py), the verdict the
    reference's."""
    for name in (WASM_TEST_GOLDEN, *WASM_GOLDENS):
        g = _golden_record(name)
        program = compile_wasm(bytes.fromhex(g["module_hex"])).program
        log(f"  {name}: {len(bytes.fromhex(g['module_hex']))} module bytes -> "
            f"{len(program.qm31_words())} program words, entry points "
            f"{list(program.entrypoints)}")
    g = _golden_record(WASM_TEST_GOLDEN)
    pi, proof, cfg = phase_test_scale("memrw", lambda: wasm_input(g), "native",
                                      WASM_TEST_GOLDEN, devices=("cuda",))
    if pi.total_steps != g["cycles"]:
        raise AssertionError(f"memrw ran {pi.total_steps} cycles, the reference {g['cycles']}")
    config.set_test_scale(**TEST_SCALE)
    try:
        check_verdict(proof, cfg, g, "memrw test scale")
    finally:
        config.set_production_scale()


def phase_wasm_proofs(gen, known=None):
    """(b) memrw and sumsq at REGULAR_96_BITS, cold (the prover's caches set
    aside) and warm, each digest equal to its golden and the verdict the
    reference's; then kernel B on every plan of their live components at
    their sizes but those of a launch shape in ``known``, bit for bit
    against plain (timed beside it and its bound), every wide-tape launch
    shape of the warm proofs checked, and the trees' kernels on every leaf
    shape and tree size.  -> the launches of the proofs."""
    known = dict(known or {})
    cfg = config.REGULAR_96_BITS
    launches = dict.fromkeys(kernels.launches, 0)
    torch.cuda.empty_cache()  # sumsq's proof peaks at ~30 GiB
    for name in WASM_GOLDENS:
        g = _golden_record(name)
        label = g["entrypoint"]
        t = time.time()
        pi = wasm_input(g)
        log(f"  {label}: WASM frontend, native VM + adapter {time.time() - t:.3f} s, "
            f"{pi.total_steps} cycles")
        # sumsq's lookups outside their tables (the fault of both packages
        # that its golden records) stop the host's debug count
        relations = Relations()
        comps = prover_traces(pi, relations)
        log(f"  {label} live components "
            f"{[c.name for c in comps.all if not c.zero_witness]}")
        jobs = [j for j in component_plans(relations, comps)
                if wtape._launch_shape(j[1], j[2]) not in known]
        del comps
        for run in ("cold", "warm"):
            with contextlib.ExitStack() as stack:
                if run == "cold":
                    stack.enter_context(profile.cold_prover_caches())
                proof, rec = profile.timed_prove(pi, cfg, DEV)
            log(f"  {label} {run} prove: {rec['seconds']:.3f} s, "
                f"{rec['cycles_per_s']:.1f} cycles/s; phases "
                + json.dumps({k: round(v, 4) for k, v in rec["phases"].items()})
                + f"; peak device memory {rec['peak_device_bytes'] / 2**30:.2f} GiB "
                f"({rec['peak_device_bytes']} bytes); launches {rec['launches']}")
            check_golden(f"{label} {run}", pi.total_steps, _digest(proof.to_json_obj()), name)
            for k, n in rec["launches"].items():
                launches[k] += n
        _require_launched(rec["launches"], f"the warm {label} proof")
        if rec["launches"]["wtape_run_plan_global"]:
            raise AssertionError(f"a {label} plan took the global-scratch kernel")
        log(f"  {label} log sizes {json.dumps(profile.log_sizes(proof))}")
        check_verdict(proof, cfg, g, label)
        shapes = _parse_shapes(rec["launch_shapes"])
        log(f"  {len(jobs)} plans of {label} at sizes not checked before")
        table = check_plans(jobs, gen, [j[0] for j in jobs], require_smem=True)
        count_plan_launches(table, shapes, label, known)
        known.update(table)
        check_tree_shapes(gen, shapes, label)
        del pi, proof
    return launches


def phase_wasm_cli(tmp, lines=None):
    """(c) memrw through the command line, in subprocesses that cannot
    import JAX: ``wasm``, ``prove --verify --device cuda`` (the file's
    segment equal to the production golden) and ``verify``; its lines go
    to ``lines`` (a list) where given, else to the log.  -> the prove's
    launches."""
    g = _golden_record(WASM_GOLDENS[0])
    src, prog = os.path.join(tmp, "memrw.wasm"), os.path.join(tmp, "memrw.json")
    out = os.path.join(tmp, "proof.json")
    with open(src, "wb") as f:
        f.write(bytes.fromhex(g["module_hex"]))
    _cli("wasm", src, "-o", prog, out=lines)
    # the arguments as the command line takes them: one value a u32
    args = [str(lo | hi << 16) for lo, hi in zip(g["args"][::2], g["args"][1::2])]
    res = _cli("prove", prog, "--entrypoint", g["entrypoint"], "--arguments", *args,
               "--verify", "--device", "cuda", "-o", out, out=lines)
    launches = _cli_launches(res)
    if "segment 0: verified=True" not in res.stdout.splitlines():
        raise AssertionError("cli prove memrw: the proof did not verify")
    with open(out) as f:
        (segment,) = json.load(f)["segments"]
    digest = _digest(segment)
    _say(f"  cli proof file: segment sha256 {digest} "
         f"({'equal to' if digest == g['sha256'] else 'DIFFERENT from'} the reference's); "
         f"prove launches {launches}", lines)
    if digest != g["sha256"]:
        raise AssertionError("the cli's proof of memrw differs from the golden")
    res = _cli("verify", out, "--device", "cuda", out=lines)
    if res.stdout.strip().splitlines() != ["segment 0: OK", "proof verified"]:
        raise AssertionError(f"cli verify: {res.stdout!r}")
    _require_launched(launches, "the cli's memrw proof")
    return launches


def phase_wasm(gen, known=None, cli=True):
    """Phase 14; ``cli``: run (c) here (the full run runs it in phase 7,
    beside the other command-line chains).  -> the launches of (b)'s
    proofs."""
    phase("  (a) both modules compiled; memrw at test scale")
    phase_wasm_test_scale()
    phase("  (b) memrw and sumsq at REGULAR_96_BITS")
    launches = phase_wasm_proofs(gen, known)
    if not cli:
        log("  (c) the command line's chain ran in phase 7")
        return launches
    phase("  (c) the command line's chain")
    with tempfile.TemporaryDirectory() as tmp:
        phase_wasm_cli(tmp)
    return launches


def _say(msg, out=None):
    """A line to ``out`` (a list) where given, else to the log."""
    if out is None:
        log(msg)
    else:
        out.append(msg)


def run_entry(module, env, out=None):
    """``python -m module`` with ``env`` added to the environment, in a
    fresh process that cannot import JAX, its standard error and its line
    echoed (to ``out`` where given); raise unless it exits with 0 and
    prints exactly one line.  -> (the line, the process's standard error)."""
    torch.cuda.empty_cache()  # the child gets the card's memory
    t = time.time()
    res = subprocess.run(
        [sys.executable, "-c", _NO_JAX_MODULE.format(repo=REPO, module=module, argv=[])],
        capture_output=True, text=True, cwd=REPO, timeout=900,
        env=dict(os.environ, **env),
    )
    for line in res.stderr.rstrip().splitlines():
        _say(f"    {line}", out)
    lines = res.stdout.strip().splitlines()
    _say(f"  {module} {' '.join(f'{k}={v}' for k, v in env.items())}: rc "
         f"{res.returncode}, {time.time() - t:.1f} s; its line:", out)
    for line in lines:
        _say(f"    {line}", out)
    if res.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"{module} exited with {res.returncode} and "
                             f"{len(lines)} lines on standard output")
    return json.loads(lines[0]), res.stderr


def _require_launched(rec, label):
    for name in PATH_KERNELS:
        if rec[name] <= 0:
            raise AssertionError(f"kernel {name} never launched in {label}")


def phase_bench(runs: int, out=None):
    """(a) ``python -m cairo_m_tpu_torch.bench`` ``runs`` times, each in a
    fresh process; -> the timed proves' launches, summed."""
    lines, recs = [], []
    for i in range(runs):
        line, err = run_entry("cairo_m_tpu_torch.bench", {"BENCH_FIB_ITERS": "100000"}, out)
        d = line["detail"]
        if d.get("stage") != "done" or d.get("verified") is not True:
            raise AssertionError(f"bench run {i + 1}: stage {d.get('stage')}, "
                                 f"verified {d.get('verified')}, error {d.get('error')}")
        if d["n_cycles"] != 800_010 or d["device"] != torch.cuda.get_device_name(0):
            raise AssertionError(f"bench run {i + 1}: {d['n_cycles']} cycles on {d['device']}")
        (rec,) = _launch_records(err)
        _require_launched(rec, f"bench run {i + 1}'s timed prove")
        lines.append(line)
        recs.append(rec)
    if runs > 1:
        for key, get in (("value", lambda l: l["value"]),
                         ("prove_s", lambda l: l["detail"]["prove_s"]),
                         ("warmup_s", lambda l: l["detail"]["warmup_s"])):
            vals = [get(l) for l in lines]
            _say(f"  bench {key} over {runs} runs: {min(vals)} .. {max(vals)} "
                 f"({', '.join(map(str, vals))})", out)
    return _sum_launches(recs)


def phase_bench_segments(iters: int, out=None):
    """(b) ``python -m cairo_m_tpu_torch.bench_segments`` for fibonacci(iters)
    at the production cap; -> the segments' launches, summed."""
    n_cycles = 8 * iters + 10
    n_segments = -(-n_cycles // SEGMENT_CAP)
    line, err = run_entry("cairo_m_tpu_torch.bench_segments",
                          {"SEG_FIB_ITERS": str(iters), "SEG_MAX_STEPS": str(SEGMENT_CAP)},
                          out)
    recs = _launch_records(err)
    if not (line["root_chain_ok"] is True and line["all_verified"] is True
            and line["segments"] == len(recs) == n_segments
            and line["total_cycles"] == n_cycles
            and line["device"] == torch.cuda.get_device_name(0)):
        raise AssertionError(f"bench_segments: expected {n_segments} verified segments "
                             f"of {n_cycles} cycles in all on the card")
    for k, rec in enumerate(recs):
        _require_launched(rec, f"segment {k + 1}")
    return _sum_launches(recs)


def phase_benches(bench_runs: int, seg_iters: int, out=None) -> dict:
    """Phase 12, its lines to ``out`` where given; -> launches by path."""
    _say(f"  (a) python -m cairo_m_tpu_torch.bench [{time.time() - _START:.1f} s]", out)
    paths = {"bench": phase_bench(bench_runs, out)}
    _say(f"  (b) python -m cairo_m_tpu_torch.bench_segments "
         f"[{time.time() - _START:.1f} s]", out)
    paths["bench_segments"] = phase_bench_segments(seg_iters, out)
    return paths


# phase 13, --nccl: the machine's four cards
NCCL_CARDS = 4
# the single card's fib(1M) peak device memory (PERF.md §6)
FIB1M_SINGLE_PEAK_GIB = (37.26, 37.95)
# PERF.md's kernel table, card 0: the shapes 13(d) times on every card
PERF_CARD0_MS = {"blake2s_leaves": 0.0647, "blake2s_pyramid": 0.1035,
                 "wtape_run_plan": 1.1943}


def kernels_on_card(card, gen, job):
    """13(d) on ``card``, every launch made from this thread while its
    current card stays cuda:0: the leaf kernel at (4, 2^20), the pyramid
    kernel over 2^20 leaf digests, and kernel B, both variants, on the
    plan ``job`` (name, plan, lanes, constants); each bit for bit against
    its plain version on the same card, and timed there.
    -> {kernel: (max_abs_err, ms)}."""
    dev = torch.device(card)
    out = {}

    def check(name, fn, want, timed=None):
        before = kernels.launches[name]
        got = fn()
        if kernels.launches[name] <= before:
            raise AssertionError(f"{name} did not launch on {card}")
        if torch.cuda.current_device() != 0:
            raise AssertionError(f"{name} on {card} left the current card changed")
        if got.device != dev:
            raise AssertionError(f"{name} on {card} wrote to {got.device}")
        out[name] = [max_abs_err(got, want), time_ms(timed or fn, device=dev)]

    k, n = BLAKE2S_MAIN
    cols = _rand((k, n), 1 << 32, gen).to(dev)
    check("blake2s_leaves", lambda: blake2s.hash_leaves(cols),
          torch.stack(blake2s.hash_words(list(cols))))
    m = PYRAMID_MAIN
    packed = torch.zeros((8, 2 * m - 1), dtype=torch.int64, device=dev)
    packed[:, :m] = _rand((8, m), 1 << 32, gen).to(dev)
    # timed in place: the levels above the leaves are written again
    check("blake2s_pyramid", lambda: blake2s.merkle_pyramid(packed.clone()),
          blake2s.merkle_pyramid_plain(packed.clone()),
          lambda: blake2s.merkle_pyramid(packed))
    _, plan, n, consts = job
    rows = _rand((len(plan.used_bank), n), (1 << 31) - 1, gen).to(dev)
    cdev = torch.from_numpy(np.asarray(consts, np.int64)).to(dev)
    want = _plain(rows, consts, plan)
    check("wtape_run_plan", lambda: wtape.run_plan(rows, cdev, plan, variant="smem"),
          want)
    check("wtape_run_plan_global",
          lambda: wtape.run_plan(rows, cdev, plan, variant="global"), want)
    return out


def phase_kernels_every_card(pi, cards):
    """13(d): `kernels_on_card` on every card; one line a card and kernel."""
    if torch.cuda.current_device() != 0:
        raise AssertionError("the smoke test's current card is not cuda:0")
    job = next(j for j in witness_plans(pi) if j[0] == WTAPE_MAIN)
    gen = torch.Generator(device=DEV)
    gen.manual_seed(13)
    per_card = {card: kernels_on_card(card, gen, job) for card in cards}
    for name in per_card[cards[0]]:
        cells = ", ".join(f"{card} {ms:.4f} ms (max_abs_err {e})"
                          for card, r in per_card.items() for e, ms in [r[name]])
        table = PERF_CARD0_MS.get(name)
        log(f"  {name}: {cells}; PERF.md's table, card 0: "
            + (f"{table} ms" if table else "not at this shape"))
    err = max(e for r in per_card.values() for e, _ in r.values())
    if err:
        raise AssertionError(f"a kernel disagrees with its plain version: {err}")
    log(f"  every kernel bit-equal to its plain version on {cards}, launched "
        "from a thread whose current card is cuda:0")


def phase_chain_four_cards(cards):
    """13(e): phase 8(b)'s chain on two workers on cuda:0, then on four
    workers, one a card: every segment's digest equal, root chain intact."""
    one, wall_one = run_chain([str(DEV)], 2)
    four, wall_four = run_chain(cards, len(cards))
    used = sorted({r["device"] for r in four})
    if used != sorted(cards):
        raise AssertionError(f"the four workers proved on {used}, not {cards}")
    a = [_digest(r["proof"]) for r in one]
    b = [_digest(r["proof"]) for r in four]
    log(f"  segment digests: one card {a}; four cards "
        f"{'equal' if a == b else 'DIFFERENT: ' + str(b)}")
    if a != b:
        raise AssertionError("the four-card chain's segments differ from the one-card chain's")
    log(f"  wall: two workers on {DEV} {wall_one:.2f} s, four workers on "
        f"{len(cards)} cards {wall_four:.2f} s ({wall_four / wall_one:.3f} of it)")


def phase_four_cards(single_digest, single_peak, pi):
    """Phase 13, in the order that tells most if a part fails: (d) and
    (e), which need no NCCL, then (a), and (b) and (c) only once (a)
    passed.  Every part runs that can; any failure makes this raise at
    the end."""
    cards = [f"cuda:{i}" for i in range(NCCL_CARDS)]
    failed = []

    def part(label, fn):
        phase(f"phase 13{label}")
        try:
            fn()
            return True
        except Exception as e:  # noqa: BLE001 -- raised again below
            traceback.print_exc()
            sys.stdout.flush()
            failed.append(f"13{label.split(':')[0]}: {type(e).__name__}: {e}")
            return False

    part("(d): kernels A and B against their plain versions on every card",
         lambda: phase_kernels_every_card(pi, cards))
    part("(e): the 5-segment chain on one card and on four",
         lambda: phase_chain_four_cards(cards))
    if part("(a): fib-40 at test scale on 2 and 4 NCCL ranks",
            lambda: [phase_sharded_test_scale(ws, "nccl", cards[:ws])
                     for ws in (2, 4)]):
        part("(b): fib-100k on 2 and 4 NCCL ranks, cold and warm",
             lambda: [_sharded_full(ws, "nccl", cards[:ws], single_digest,
                                    single_peak) for ws in (2, 4)])
        lo, hi = FIB1M_SINGLE_PEAK_GIB
        log(f"  (c)'s single card: peak {lo}-{hi} GiB (PERF.md §6)")
        part(f"(c): fibonacci({FIB1M_ITERS:,}) on {NCCL_CARDS} NCCL ranks",
             lambda: _sharded_full(NCCL_CARDS, "nccl", cards, _golden(FIB1M_GOLDEN),
                                   int(lo * 2**30), iters=FIB1M_ITERS,
                                   golden=FIB1M_GOLDEN, timeout=600))
    else:
        failed.append("13(b), 13(c): not run, NCCL failed in (a)")
    if failed:
        raise AssertionError("phase 13 failed: " + "; ".join(failed))


# ---------------------------------------------------------------------------
# Phase 15: the point-evaluation kernel at the sample steps of real proofs
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def captured_point_jobs():
    """Keep the jobs of the last `fft.eval_at_points` call made inside: the
    sample step of the last proof, its stacks held alive."""
    last = []
    real = fft.eval_at_points

    def spy(jobs):
        last[:] = [list(jobs)]
        return real(jobs)

    fft.eval_at_points = spy
    try:
        yield last
    finally:
        fft.eval_at_points = real


def point_eval_launcher(jobs):
    """A function that launches the kernel on ``jobs``' table, built and
    uploaded once: the kernel's time without the wrapper's host work."""
    table, tws, n_blocks, n_part, n_warps, n_out, _ = fft._point_eval_table(jobs)
    dev = torch.from_numpy(np.concatenate([table.reshape(-1), tws.reshape(-1)])).to(DEV)
    part = torch.empty(4 * n_part, dtype=torch.int32, device=DEV)
    out = torch.empty(n_out, dtype=torch.int64, device=DEV)

    def launch():
        err = kernels.lib().cm_point_eval(
            dev.data_ptr(), int(table.shape[0]), dev.data_ptr() + 8 * table.size,
            part.data_ptr(), out.data_ptr(), n_blocks, n_warps, fft._PE_SEG_LOG,
            torch.cuda.current_stream().cuda_stream)
        kernels.check(err, "point_eval")
        return out

    return launch


def point_eval_bound(jobs):
    """Each coefficient read once (8 bytes) for all of its job's points,
    each value written once (4 int64 limbs); a 32x32->64 multiply-add a
    limb and point (two INT32-pipe operations), the reductions deferred."""
    coeffs = sum(int(c.numel()) for c, _, _ in jobs)
    values = sum(int(c.shape[0]) * len(zs) for c, _, zs in jobs)
    ops = 8 * sum(int(c.numel()) * len(zs) for c, _, zs in jobs)
    return coeffs, values, bound(8 * coeffs + 32 * values, ops)


def phase_point_eval(label, pi, want_digest, warm_up=False):
    """Phase 15: a proof of ``pi`` at REGULAR_96_BITS (after a warm-up
    proof if ``warm_up``) with its sample step's jobs kept: one
    ``point_eval`` launch in the proof, its digest ``want_digest``; then the
    kernel against the plain folds on the card on those jobs, bit for bit,
    and both timed.  -> the kernel's row."""
    cfg = config.REGULAR_96_BITS
    if warm_up:
        prove_cairo_m(pi, cfg)
    with captured_point_jobs() as last:
        kernels.reset_launches()
        proof = prove_cairo_m(pi, cfg)
        torch.cuda.synchronize()
    n = kernels.launches["point_eval"]
    digest = _digest(proof.to_json_obj())
    del proof
    log(f"  {label}: {n} point_eval launch(es) in the proof; proof sha256 {digest} "
        f"({'equal to' if digest == want_digest else 'DIFFERENT from'} the golden)")
    if n != 1 or digest != want_digest:
        raise AssertionError(f"{label}: {n} point_eval launches, digest {digest}")
    jobs = last[0]
    got, call_ms = timed_call(lambda: fft.eval_at_points(jobs))
    want, plain_ms = timed_call(lambda: fft._eval_at_points_plain(jobs))
    err = max_abs_err(got, want)
    if err:
        raise AssertionError(f"{label}: point_eval differs from the plain folds")
    launch = point_eval_launcher(jobs)
    if not torch.equal(launch(), want):
        raise AssertionError(f"{label}: point_eval (prebuilt table) differs from plain")
    coeffs, values, (bound_ms, bound_by) = point_eval_bound(jobs)
    row = {"max_abs_err": err, "ms": time_ms(launch), "dev_ms": time_ms(launch, queued=True),
           "call_ms": call_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "launches": n}
    logs = sorted({(lg, int(c.shape[-1]).bit_length() - 1) for c, lg, _ in jobs})
    log(f"  {label} sample step: {len(jobs)} jobs (log sizes "
        f"{sorted({lg for lg, _ in logs})}, k {min(int(c.shape[0]) for c, _, _ in jobs)}-"
        f"{max(int(c.shape[0]) for c, _, _ in jobs)}, "
        f"{sum(len(zs) for _, _, zs in jobs)} (job, point) pairs), {values} values, "
        f"{coeffs} coefficients read; max_abs_err 0; kernel {row['ms']:.4f} ms "
        f"({row['dev_ms']:.4f} ms queued), one wrapper call with its table "
        f"{call_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), plain folds "
        f"{plain_ms:.4f} ms")
    return row


def phase_point_eval_cells():
    """--point-eval: phase 15 at the sample steps of warm fib-100k,
    SHA-256 bench1k and fibonacci(1,000,000) proofs."""
    program = compile_cairo(FIB_SRC).program
    rows = {}
    pi = native_prover_input(program, "main", [100_000])
    rows["fib-100k"] = phase_point_eval("fib-100k", pi, _golden(FIB100K_GOLDEN),
                                        warm_up=True)
    with open(os.path.join(REPO, SHA256_FILE)) as f:
        sha = compile_cairo(f.read(), SHA256_FILE).program
    pi = native_prover_input(sha, "bench1k", [])
    want = witness_golden("sha256_bench1k", load_witnesses()["sha256_bench1k"])
    rows["bench1k"] = phase_point_eval("sha256 bench1k", pi, want, warm_up=True)
    pi = native_prover_input(program, "main", [FIB1M_ITERS])
    rows["fib(1M)"] = phase_point_eval("fib(1M)", pi, _golden(FIB1M_GOLDEN),
                                       warm_up=True)
    return rows


POSEIDON2_ROW_BYTES = 16 * 4 + 443 * 8  # states read, int64 columns written


def phase_poseidon2_witness():
    """Phase 16: the poseidon2 witness kernel against the plain rounds on
    the card and timed, at 2^20 and 2^21 rows.  -> {rows: row}."""
    from cairo_m_tpu_torch.hash.poseidon2_params import active_params
    from cairo_m_tpu_torch.prover.components import generic

    params = active_params()
    out = {}
    for log_rows in (20, 21):
        rows = 1 << log_rows
        n = rows - 12_345  # the last rows are padding
        gen = torch.Generator(device=DEV)
        gen.manual_seed(log_rows)
        states = torch.randint(0, (1 << 31) - 1, (n, 16), generator=gen, device=DEV,
                               dtype=torch.int64).to(torch.int32)
        kernels.reset_launches()
        got = generic.poseidon2_witness(states, rows, params)
        torch.cuda.synchronize()
        want = generic.poseidon2_witness_plain(states, rows, params)
        err = max_abs_err(got, want)
        if err or kernels.launches["poseidon2_witness"] != 1:
            raise AssertionError(f"poseidon2 witness at 2^{log_rows} rows: max_abs_err "
                                 f"{err}, {kernels.launches['poseidon2_witness']} launches")
        del got, want
        fn = lambda: generic.poseidon2_witness(states, rows, params)  # noqa: E731
        bound_ms = rows * POSEIDON2_ROW_BYTES / HBM_BYTES_PER_S * 1e3
        row = {"max_abs_err": err, "ms": time_ms(fn), "dev_ms": time_ms(fn, queued=True),
               "plain_ms": time_ms(lambda: generic.poseidon2_witness_plain(
                   states, rows, params), reps=3),
               "bound_ms": bound_ms, "bound_by": "bytes", "launches": 1}
        log(f"  poseidon2 witness, 2^{log_rows} rows ({n} states): max_abs_err 0; "
            f"kernel {row['ms']:.4f} ms ({row['dev_ms']:.4f} ms queued), bound "
            f"{bound_ms:.5f} ms (bytes, {POSEIDON2_ROW_BYTES} a row), "
            f"{row['ms'] / bound_ms:.2f}x the bound; plain rounds {row['plain_ms']:.4f} ms")
        out[rows] = row
        del states
        torch.cuda.empty_cache()
    return out


def phase_bigmem():
    """Phase 17: bigmem's ``main`` proved cold at REGULAR_96_BITS and
    verified; one launch of the poseidon2 witness kernel at 2^21 rows; the
    output (N v mod 2^32, v) as limbs.  -> the proof's launches."""
    with open(os.path.join(REPO, BIGMEM_PROGRAM)) as f:
        program = compile_cairo(f.read()).program
    v = 0xFFFFFFF7
    t = time.time()
    pi = native_prover_input(program, "main", [v & 0xFFFF, v >> 16], 1 << 30)
    log(f"  bigmem native VM + adapter: {time.time() - t:.3f} s, {pi.total_steps} "
        f"cycles, {len(pi.poseidon2_inputs)} Merkle hashes")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    launches, _, proof = prove_full(pi, config.REGULAR_96_BITS, "bigmem", runs=("cold",))
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory {peak / 2**30:.2f} GiB ({peak} bytes)")
    rows = 1 << proof.log_sizes[3]  # the poseidon2 component's
    want = [(x, 0, 0, 0) for w in (BIGMEM_N * v % (1 << 32), v)
            for x in (w & 0xFFFF, w >> 16)]
    got = [tuple(e[1]) for e in proof.public_data.output if e is not None]
    if rows != 1 << 21 or launches["poseidon2_witness"] != 1 or got != want:
        raise AssertionError(f"bigmem: poseidon2 at {rows} rows, "
                             f"{launches['poseidon2_witness']} witness launches, "
                             f"output {got}")
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
    card_rates()
    nccl_only = "--nccl" in sys.argv[1:]
    if nccl_only and torch.cuda.device_count() < NCCL_CARDS:
        raise RuntimeError(f"--nccl needs {NCCL_CARDS} cards, one a rank; "
                           f"{torch.cuda.device_count()} visible")
    if "--fib1m" in sys.argv[1:]:
        gen = torch.Generator(device=DEV)
        gen.manual_seed(2024)
        phase("phase 10: fibonacci(1,000,000), 8,000,010 cycles in one proof")
        phase_fib1m(gen, compile_cairo(FIB_SRC).program, {})
        log(f"card: {card_line()}")
        log("stopping after phase 10")
        return
    if "--point-eval" in sys.argv[1:]:
        phase("phase 15: the point-evaluation kernel at real sample steps")
        phase_point_eval_cells()
        log(f"card: {card_line()}")
        log("stopping after phase 15")
        return
    if "--poseidon2" in sys.argv[1:]:
        phase("phase 16: the poseidon2 witness kernel")
        phase_poseidon2_witness()
        phase("phase 17: bigmem, 128,000 elements")
        phase_bigmem()
        log(f"card: {card_line()}")
        log("stopping after phase 17")
        return
    if "--sha256" in sys.argv[1:]:
        gen = torch.Generator(device=DEV)
        gen.manual_seed(2024)
        phase("phase 11: the SHA-256 example")
        phase_sha256(gen)
        log(f"card: {card_line()}")
        log("stopping after phase 11")
        return
    if "--wasm" in sys.argv[1:]:
        gen = torch.Generator(device=DEV)
        gen.manual_seed(2024)
        phase("phase 14: WASM-compiled programs")
        phase_wasm(gen)
        log(f"card: {card_line()}")
        log("stopping after phase 14")
        return
    if "--bench" in sys.argv[1:]:
        phase("phase 12: the repository's prover benches on the port")
        phase_benches(BENCH_RUNS, CHAIN_ITERS)
        log(f"card: {card_line()}")
        log("stopping after phase 12")
        return
    if "--witnesses" in sys.argv[1:]:
        phase("phase 5b: every AIR component, the witnesses of tests/golden/witnesses.json")
        gen = torch.Generator(device=DEV)
        gen.manual_seed(2024)
        phase_witnesses(gen, load_witnesses())
        log(f"card: {card_line()}")
        log("stopping after phase 5b")
        return
    if "--sharded" in sys.argv[1:] or nccl_only:
        program = compile_cairo(FIB_SRC).program
        pi = native_prover_input(program, "main", [100_000])
        phase("phase 5: fib-100k at REGULAR_96_BITS, production scale")
        torch.cuda.reset_peak_memory_stats()
        _, _, proof = prove_full(pi, config.REGULAR_96_BITS, "fib-100k")
        single_peak = torch.cuda.max_memory_allocated()
        log(f"  peak device memory {single_peak / 2**30:.2f} GiB ({single_peak} bytes)")
        check_fib100k_digest(_digest(proof.to_json_obj()))
        if nccl_only:
            phase(f"phase 13: {NCCL_CARDS} cards")
            phase_four_cards(_digest(proof.to_json_obj()), single_peak, pi)
            loaded = sorted(m for m, v in sys.modules.items()
                            if v is not None and m.split(".")[0] in ("jax", "cairo_m_tpu"))
            if loaded:
                raise AssertionError(f"modules of JAX or of the JAX package were loaded: {loaded}")
            phase("phase 13 passed")
            log(f"cards: {card_line(every=True)}")
            log(json.dumps({"ok": True, "device": {
                "platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": torch.cuda.device_count()}}))
            return
        phase("phase 9: the row-sharded prover")
        phase_upload_routes(pi)
        phase_sharded_test_scale()
        phase_sharded_full(_digest(proof.to_json_obj()), single_peak)
        log(f"card: {card_line()}")
        log("stopping after phase 9")
        return

    gen = torch.Generator(device=DEV)
    gen.manual_seed(2024)
    phase("phase 2: blake2s leaf kernel vs plain")
    table_a = phase_blake2s(gen)
    phase("phase 2: blake2s pyramid kernel vs plain, every tree of 2^1 .. 2^24 leaves")
    table_p = phase_pyramid(gen, 24)
    phase_trees(gen)
    top_s = host_top_seconds()
    log(f"  host: hashing one tree top (1024 nodes to the root) with NumPy takes "
        f"{top_s * 1e3:.2f} ms on this host")

    program = compile_cairo(FIB_SRC).program
    t = time.time()
    pi = native_prover_input(program, "main", [100_000])
    log(f"fib-100k native VM + adapter: {time.time() - t:.3f} s, "
        f"{pi.total_steps} cycles")
    phase("phase 3: wide-tape kernels vs plain, every plan of the fib-100k witness")
    table_b, synthetic = phase_wtape(pi, gen)
    if "--kernels" in sys.argv[1:]:
        sass_counts()
        log("--kernels: stopping after the kernel phases")
        return

    phase("phase 4: test-scale proof, CUDA vs CPU vs reference digest")
    phase_test_scale("fib-40", lambda: native_prover_input(program, "main", [40]),
                     "native", "fib40_proof_sha256.json")

    phase("phase 5: fib-100k at REGULAR_96_BITS, production scale")
    torch.cuda.reset_peak_memory_stats()
    paths = {}
    paths["main"], warm_shapes, proof = prove_full(pi, config.REGULAR_96_BITS, "fib-100k")
    single_peak = torch.cuda.max_memory_allocated()
    single_digest = _digest(proof.to_json_obj())
    log(f"  peak device memory {single_peak / 2**30:.2f} GiB "
        f"({single_peak} bytes)")
    check_fib100k_digest(single_digest)
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

    phase("phase 15: the point-evaluation kernel at fib-100k's sample step")
    table_e = phase_point_eval("fib-100k", pi, single_digest)

    phase("phase 16: the poseidon2 witness kernel")
    table_h = phase_poseidon2_witness()

    phase("phase 5b: every AIR component, the witnesses of tests/golden/witnesses.json")
    paths["allops"], table_w = phase_witnesses(gen, load_witnesses())

    phase("phase 6: stwo framing")
    phase_test_scale("fib-40", lambda: native_prover_input(program, "main", [40]),
                     "stwo", "fib40_stwo_proof_sha256.json")
    # 80,010 cycles: a tenth of fib-100k's depth (its host trees and
    # host verification are most of the phase)
    pi_stwo = native_prover_input(program, "main", [STWO_ITERS])
    stwo = _golden_record(STWO_GOLDEN)
    paths["stwo"], _, proof = prove_full(pi_stwo, config.STWO_FRAMING_96_BITS,
                                         f"fib({STWO_ITERS}) stwo", runs=("first",),
                                         rejected=not stwo["verifies"])
    check_golden(f"fib({STWO_ITERS}) stwo", pi_stwo.total_steps, _digest(proof.to_json_obj()),
                 STWO_GOLDEN)
    del pi_stwo, proof
    if paths["stwo"]["wtape_run_plan"] <= 0:
        raise AssertionError("kernel wtape_run_plan never launched on the stwo path")

    # phase 12's processes run beside phase 7's chains, which are mostly
    # host work in processes of their own
    phase("phase 7: command line, and beside it phase 12")
    bench_lines = []
    with tempfile.TemporaryDirectory() as tmp, ThreadPoolExecutor(1) as pool:
        benches = pool.submit(phase_benches, 1, SEG_SMOKE_ITERS, bench_lines)
        try:
            paths["cli"] = phase_cli(tmp, load_witnesses())
        finally:
            wait([benches])
            phase("phase 12: the repository's prover benches on the port, beside phase 7")
            for line in bench_lines:
                log(line)
        paths.update(benches.result())

    phase("phase 8: chained segments, two workers on the card")
    phase_segments_test_scale()
    paths["segments"] = phase_segments_full()

    phase("phase 9: the row-sharded prover")
    phase_sharded_test_scale()
    paths["sharded"] = phase_sharded_full(single_digest, single_peak)

    phase("phase 10: fibonacci(1,000,000), 8,000,010 cycles in one proof")
    paths["fib1m"] = phase_fib1m(gen, program, table_p, table_b)

    phase("phase 11: the SHA-256 example")
    paths["sha256"], table_s = phase_sha256(gen, table_b, cli=False)

    phase("phase 14: WASM-compiled programs")
    # a plan an earlier phase held to plain at the same launch shape is not
    # checked again
    paths["wasm"] = phase_wasm(gen, {**table_w, **table_s, **table_b}, cli=False)

    phase("phase 17: bigmem, 128,000 elements")
    paths["bigmem"] = phase_bigmem()

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
        # replaces no Pallas kernel: XLA fused the jitted folds of
        # cairo_m_tpu/prover/stark/fft.py:270; timed on fib-100k's sample step
        entry("point_eval", "cairo_m_tpu_torch/csrc/point_eval.cu", None, table_e),
        # replaces no Pallas kernel: the JAX package writes these columns in
        # NumPy on the host; timed at bigmem's 2^21 rows
        entry("poseidon2_witness", "cairo_m_tpu_torch/csrc/poseidon2.cu", None,
              table_h[1 << 21]),
    ]}
    log(f"timed shapes: blake2s K={BLAKE2S_MAIN[0]} n={BLAKE2S_MAIN[1]}; blake2s "
        f"pyramid over {PYRAMID_MAIN} leaf digests (all its launches); wtape "
        f"{WTAPE_MAIN} n=2^20; wtape global: synthetic plan, 2000 bank rows, n=2^12; "
        f"poseidon2 witness 2^21 rows")
    loaded = sorted(m for m, v in sys.modules.items()
                    if v is not None and m.split(".")[0] in ("jax", "cairo_m_tpu"))
    if loaded:
        raise AssertionError(f"modules of JAX or of the JAX package were loaded: {loaded}")
    log("no module of jax or cairo_m_tpu was loaded")
    phase("all phases passed")
    log(f"card: {card_line()}")
    log(json.dumps(summary))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
