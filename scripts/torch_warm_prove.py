"""Warm-prove seconds of cairo_m_tpu_torch on one CUDA card, for comparing
two checkouts of the port in turns on one card.

    python3 scripts/torch_warm_prove.py [--root CHECKOUT] [--proves 3]

Compiles the fibonacci loop, runs the native VM for 100,000 iterations
(800,010 cycles) and proves ``--proves`` times at ``REGULAR_96_BITS`` in one
process (the first proof is cold).  For every proof it prints one JSON
line: wall seconds, the prover's phase seconds, the kernel launches, and
the host seconds and calls spent in ``merkle._host_inner_levels`` (NumPy
hashing of Merkle levels on the host).  ``--root`` names the checkout whose
``cairo_m_tpu_torch`` is imported (default: the one this script lies in),
so the same script times a parent commit unpacked beside the working tree.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import torch

FIB_SRC = """
fn main(n: felt) -> felt {
    let a = 0; let b = 1; let i = 0;
    while i != n { let t = a + b; a = b; b = t; i = i + 1; }
    return a;
}
"""


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=here)
    ap.add_argument("--proves", type=int, default=3)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("needs a CUDA device")
    sys.path.insert(0, os.path.abspath(args.root))

    from cairo_m_tpu_torch import kernels
    from cairo_m_tpu_torch.compiler import compile_cairo
    from cairo_m_tpu_torch.prover import config
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.prove import prove_cairo_m
    from cairo_m_tpu_torch.prover.stark import merkle
    from cairo_m_tpu_torch.prover.verify import verify_cairo_m

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    host = {"s": 0.0, "calls": 0}
    inner = merkle._host_inner_levels

    def timed_inner(digests):
        t = time.perf_counter()
        out = inner(digests)
        host["s"] += time.perf_counter() - t
        host["calls"] += 1
        return out

    merkle._host_inner_levels = timed_inner
    pi = native_prover_input(compile_cairo(FIB_SRC).program, "main", [100_000])
    for i in range(args.proves):
        kernels.reset_launches()
        host.update(s=0.0, calls=0)
        timing = {}
        torch.cuda.synchronize()
        t = time.time()
        proof = prove_cairo_m(pi, config.REGULAR_96_BITS, timing)
        torch.cuda.synchronize()
        print(json.dumps({
            "label": args.label, "root": os.path.abspath(args.root), "card": card,
            "prove": i, "cycles": pi.total_steps, "seconds": time.time() - t,
            "phases": timing, "launches": dict(kernels.launches),
            "host_inner_levels_s": host["s"], "host_inner_levels_calls": host["calls"],
        }), flush=True)
    if not verify_cairo_m(proof, config.REGULAR_96_BITS):
        raise AssertionError("the last proof did not verify")
    print(json.dumps({"label": args.label, "verified": True}), flush=True)


if __name__ == "__main__":
    main()
