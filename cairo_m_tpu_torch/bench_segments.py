"""Chained-segment benchmark: fibonacci at 10M+ cycles, proved segment by
segment in one process on the card.

    [SEG_FIB_ITERS=N] [SEG_MAX_STEPS=M] python -m cairo_m_tpu_torch.bench_segments
        [--device cuda] [--test-scale]

The counterpart of the repository's ``scripts/bench_segments.py``, with its
protocol, knobs and line.  Runs the fibonacci loop for ``SEG_FIB_ITERS``
iterations (default 1,250,000 -> 10,000,010 cycles), segments the execution
at ``SEG_MAX_STEPS`` (default the production cap 2^20 - 1) through the
native core's resume path (``native_segment_prover_inputs``), checks the
Poseidon2 root chain ``final_root(k) == initial_root(k+1)``, proves every
segment at ``REGULAR_96_BITS`` (the device synced before and after each
prove, `profile.timed_prove`), verifies every proof, and prints ONE JSON
line on standard output:

  {"metric": "fib10m_cycles_proved_per_sec", "value": ..., "unit":
   "cycles/s", "segments": N, "total_cycles": ..., "prove_s": ...,
   "adapter_s": ..., "warm_value": ..., "warm_segments": ...,
   "per_segment": [[cycles, prove seconds], ...], "root_chain_ok": true,
   "all_verified": ..., "wall_s": ..., "device": ...}

One process proves every segment in turn, so the prover's caches (plans,
the preprocessed commitment, twiddles) serve every segment after the first;
``warm_value`` is the rate over those.  Per segment, standard error gets
the reference's ``segment k: ...`` line and the prove's ``kernel launches
{...}``.  ``--device`` and ``--test-scale`` as in `bench`: the card by
default, an error without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import profile
from .bench import device_name, log
from .compiler import compile_cairo
from .device import DEFAULT_DEVICE, resolve_device
from .prover.adapter.native_import import native_segment_prover_inputs
from .prover.verify import verify_cairo_m

METRIC = "fib10m_cycles_proved_per_sec"
DEFAULT_ITERS = 1_250_000
DEFAULT_MAX_STEPS = (1 << 20) - 1


def run(iters: int, max_steps: int, cfg, device=DEFAULT_DEVICE):
    """The chain's protocol on ``device``; -> (line, the proofs in segment
    order)."""
    device = resolve_device(device)
    t0 = time.time()
    # scripts/bench_segments.py's source, as profile.py has it
    program = compile_cairo(profile.FIB_SRC).program
    total_cycles = 0
    prove_s = 0.0
    adapter_s = 0.0
    seg_times = []  # (cycles, prove seconds) per segment
    proofs = []
    prev_final_root = None
    all_verified = True
    t_seg = time.time()
    for pi in native_segment_prover_inputs(program, "main", [iters], max_steps):
        adapter_s += time.time() - t_seg
        if prev_final_root is not None and pi.merkle_trees.initial_root != prev_final_root:
            raise RuntimeError(f"segment root chain broken before segment {len(proofs) + 1}")
        prev_final_root = pi.merkle_trees.final_root
        proof, rec = profile.timed_prove(pi, cfg, device)
        dt = rec["seconds"]
        prove_s += dt
        seg_times.append((pi.total_steps, round(dt, 2)))
        all_verified &= bool(verify_cairo_m(proof, cfg, device=device))
        total_cycles += pi.total_steps
        proofs.append(proof)
        log(f"  segment {len(proofs)}: {pi.total_steps} cycles, "
            f"prove {dt:.2f}s, chain ok")
        log("  kernel launches " + json.dumps(rec["launches"]))
        t_seg = time.time()
    value = total_cycles / prove_s if prove_s else 0.0
    # warm rate: segments after the first (segment 1 absorbs this process's
    # first load of the kernels and the caches' filling), as bench.py's
    # warm-up and timed proves split them
    warm = seg_times[1:]
    warm_cycles = sum(c for c, _ in warm)
    warm_s = sum(t for _, t in warm)
    line = {
        "metric": METRIC,
        "value": round(value, 2),
        "unit": "cycles/s",
        "segments": len(proofs),
        "total_cycles": total_cycles,
        "prove_s": round(prove_s, 2),
        "adapter_s": round(adapter_s, 2),
        "warm_value": round(warm_cycles / warm_s, 2) if warm_s else 0.0,
        "warm_segments": len(warm),
        "per_segment": seg_times,
        "root_chain_ok": True,
        "all_verified": all_verified,
        "wall_s": round(time.time() - t0, 2),
        "device": device_name(device),
    }
    return line, proofs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cairo_m_tpu_torch.bench_segments",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=DEFAULT_DEVICE)
    ap.add_argument("--test-scale", action="store_true",
                    help="set_test_scale(10, 8), 8 queries, 2 PoW bits")
    args = ap.parse_args(argv)
    iters = int(os.environ.get("SEG_FIB_ITERS", str(DEFAULT_ITERS)))
    max_steps = int(os.environ.get("SEG_MAX_STEPS", str(DEFAULT_MAX_STEPS)))
    line, _ = run(iters, max_steps, profile.scale_config(args.test_scale), args.device)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
