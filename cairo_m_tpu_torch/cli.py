"""Command line of the PyTorch prover: prove and verify on a named device.

  python -m cairo_m_tpu_torch.cli compile program.cm -o program.json
  python -m cairo_m_tpu_torch.cli prove program.json --entrypoint main \
      --arguments 5 --output proof.json --device cuda [--verify] \
      [--framing {native,stwo}] [--max-steps N] [--from-trace trace.bin]
  python -m cairo_m_tpu_torch.cli verify proof.json --device cuda

Counterpart of ``cairo_m_tpu.cli``.  ``prove`` and ``verify`` take the
reference's flags plus a required ``--device`` (there is no default, and
``cuda`` without a card is an error) and run this package's prover.  A run
longer than ``--max-steps`` is cut into continuation segments, one proof
each; the proof file is the reference's ``{"segments": [...], "framing":
...}``, and ``verify`` checks every segment and the Poseidon2 root chain
``initial_root(k) == final_root(k-1)``.  ``compile``, ``run``, ``fmt``,
``init``, ``wasm`` and ``build`` are the reference's own commands, which
never import JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from cairo_m_tpu import cli as reference_cli

from .prover.config import REGULAR_96_BITS, STWO_FRAMING_96_BITS

_REFERENCE_COMMANDS = ("compile", "run", "fmt", "init", "wasm", "build")


def config_for(framing: str):
    """The PcsConfig a proof file of ``framing`` is proved and verified at."""
    return STWO_FRAMING_96_BITS if framing == "stwo" else REGULAR_96_BITS


def _device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {name}: no CUDA device is available")
    return device


def _segments_from_trace(program, entrypoint, trace_path):
    """(segments, public address ranges) from the binary trace files that
    ``run --trace-output`` writes; the ranges are recomputed from the
    program ABI as the runner does."""
    from cairo_m_tpu.isa.program import PublicAddressRanges
    from cairo_m_tpu.vm import trace_io

    base, ext = os.path.splitext(trace_path)
    segments = trace_io.segments_from_files(
        trace_path, f"{base}_mem{ext}", f"{base}_initmem{ext}"
    )
    info = program.entrypoints[entrypoint]
    M = sum(p.ty.call_slot_size() for p in info.params)
    K = sum(r.ty.call_slot_size() for r in info.returns)
    return segments, PublicAddressRanges.new(len(program.qm31_words()), M, K)


def cmd_prove(args):
    from cairo_m_tpu.vm.runner import RunnerOptions, run_cairo_program

    from . import kernels
    from .prover.adapter.adapter import import_from_runner_output
    from .prover.prove import prove_cairo_m
    from .prover.verify import verify_cairo_m

    device = _device(args.device)
    cfg = config_for(args.framing)
    program = reference_cli._load_program(args.program)
    return_values = []
    if args.from_trace:
        segments, ranges = _segments_from_trace(
            program, args.entrypoint, args.from_trace
        )
    else:
        res = run_cairo_program(
            program,
            args.entrypoint,
            reference_cli._parse_args_list(args.arguments),
            RunnerOptions(max_steps=args.max_steps),
        )
        segments, ranges = res.vm.segments, res.public_address_ranges
        return_values = res.return_values
    proofs = []
    for seg in segments:
        pi = import_from_runner_output(seg, ranges)
        timing = {}
        before = dict(kernels.launches)
        proof = prove_cairo_m(pi, cfg, timing, device=device)
        launched = {k: n - before[k] for k, n in kernels.launches.items()}
        n_rows = sum(1 << l for l in proof.log_sizes)
        print(
            f"segment: {len(seg.trace) - 1} steps, {n_rows} trace rows, "
            f"proved in {timing['total']:.2f}s "
            f"({n_rows / timing['total'] / 1e6:.3f} MHz), "
            f"kernel launches {json.dumps(launched)}",
            file=sys.stderr,
        )
        proofs.append(proof)
    if args.output:
        with open(args.output, "w") as f:
            json.dump(
                {"segments": [p.to_json_obj() for p in proofs],
                 "framing": cfg.framing},
                f,
            )
        print(f"proof written to {args.output}")
    if args.verify:
        for i, proof in enumerate(proofs):
            ok = verify_cairo_m(proof, cfg, device=device)
            print(f"segment {i}: verified={ok}")
    for v in return_values:
        print("return:", v.flatten())
    return 0


def cmd_verify(args):
    from .prover.prove import Proof
    from .prover.verify import VerificationError, verify_cairo_m

    device = _device(args.device)
    with open(args.proof) as f:
        obj = json.load(f)
    segs = obj["segments"] if "segments" in obj else [obj]
    cfg = config_for(obj.get("framing", "native"))
    prev_final_root = None
    for i, p in enumerate(segs):
        proof = Proof.from_json_obj(p)
        try:
            verify_cairo_m(proof, cfg, device=device)
        except (VerificationError, ValueError) as e:
            print(f"segment {i}: INVALID ({e})")
            return 1
        pd = proof.public_data
        if prev_final_root is not None and pd.initial_root != prev_final_root:
            print(f"segment {i}: continuation root mismatch")
            return 1
        prev_final_root = pd.final_root
        print(f"segment {i}: OK")
    print("proof verified")
    return 0


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in _REFERENCE_COMMANDS:
        return reference_cli.main(argv)
    ap = argparse.ArgumentParser(prog="cairo-m-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("prove")
    p.add_argument("program")
    p.add_argument("--entrypoint", default="main")
    p.add_argument("--arguments", nargs="*", default=[])
    p.add_argument("--max-steps", type=int, default=(1 << 20) - 1)
    p.add_argument("--output", "-o")
    p.add_argument("--verify", action="store_true")
    p.add_argument(
        "--framing", default="native", choices=["native", "stwo"],
        help="commitment/channel framing: native grouped trees or the stwo "
        "mixed-degree trees and channel",
    )
    p.add_argument(
        "--from-trace",
        help="prove from binary trace files written by `run --trace-output` "
        "instead of re-running the VM",
    )
    p.add_argument("--device", required=True,
                   help="torch device to prove on, e.g. cuda, cuda:1 or cpu")
    p.set_defaults(fn=cmd_prove)

    v = sub.add_parser("verify")
    v.add_argument("proof")
    v.add_argument("--device", required=True,
                   help="torch device that recomputes the preprocessed "
                   "commitment")
    v.set_defaults(fn=cmd_verify)

    for name in _REFERENCE_COMMANDS:  # dispatched above; listed for --help
        sub.add_parser(name, help=f"the reference's `{name}` command")

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
