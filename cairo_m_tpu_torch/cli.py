"""Command line of the PyTorch prover: compile / run / prove / verify.

  python -m cairo_m_tpu_torch.cli compile program.cm -o program.json
  python -m cairo_m_tpu_torch.cli run program.json --entrypoint main --arguments 5
  python -m cairo_m_tpu_torch.cli prove program.json --entrypoint main \
      --arguments 5 --output proof.json [--device cuda] [--verify] \
      [--framing {native,stwo}] [--max-steps N] [--from-trace trace.bin]
  python -m cairo_m_tpu_torch.cli verify proof.json [--device cuda]
  python -m cairo_m_tpu_torch.cli {fmt,init,wasm,build} ...

Counterpart of ``cairo_m_tpu.cli``, with the same commands and flags, served
by this package's own compiler, VM and prover.  ``prove`` and ``verify`` also
take ``--device``: it defaults to ``cuda``, and ``cuda`` without a card is an
error, never a quiet move to the CPU (``--device cpu`` asks for that).  A run
longer than ``--max-steps`` is cut into continuation segments, one proof
each; the proof file is the reference's ``{"segments": [...], "framing":
...}``, and ``verify`` checks every segment and the Poseidon2 root chain
``initial_root(k) == final_root(k-1)``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .device import DEFAULT_DEVICE, resolve_device
from .prover.config import REGULAR_96_BITS, STWO_FRAMING_96_BITS


def _load_program(path):
    from .isa.program import Program

    with open(path) as f:
        return Program.from_json(f.read())


def _parse_args_list(raw):
    from .isa.abi_codec import parse_arg

    return [parse_arg(a) for a in raw]


def _write_program(program, dest):
    with open(dest, "w") as f:
        f.write(program.to_json())


def cmd_compile(args):
    from .compiler import CompilationError, CompilerOptions, compile_cairo

    with open(args.input) as f:
        src = f.read()
    try:
        out = compile_cairo(
            src,
            name=args.input,
            options=CompilerOptions(optimization_level=args.opt),
        )
    except CompilationError as e:
        for d in e.diagnostics:
            print(f"{d.file_path}:{d.line}: {d.severity}: {d.message}", file=sys.stderr)
        return 1
    dest = args.output or args.input.rsplit(".", 1)[0] + ".json"
    _write_program(out.program, dest)
    print(f"compiled {args.input} -> {dest}")
    return 0


def cmd_run(args):
    from .vm import trace_io
    from .vm.runner import RunnerOptions, run_cairo_program

    program = _load_program(args.program)
    res = run_cairo_program(
        program,
        args.entrypoint,
        _parse_args_list(args.arguments),
        RunnerOptions(max_steps=args.max_steps),
    )
    for v in res.return_values:
        print(v.flatten())
    if args.trace_output:
        base, ext = os.path.splitext(args.trace_output)
        segs = res.vm.segments
        trace_io.write_binary_trace(segs, args.trace_output)
        trace_io.write_binary_memory_trace(
            segs, res.vm.program_length, f"{base}_mem{ext}"
        )
        trace_io.write_initial_memory(segs, f"{base}_initmem{ext}")
    return 0


def cmd_fmt(args):
    from .compiler.formatter import format_source

    changed = 0
    for path in args.files:
        with open(path) as f:
            src = f.read()
        out = format_source(src)
        if out != src:
            changed += 1
            if args.check:
                print(f"would reformat {path}")
            else:
                with open(path, "w") as f:
                    f.write(out)
                print(f"reformatted {path}")
    return 1 if args.check and changed else 0


def cmd_init(args):
    from .compiler.project import init_project

    name = args.name or os.path.basename(os.path.abspath(args.path))
    proj = init_project(args.path, name)
    print(f"created project {proj.manifest.name} at {proj.root}")
    return 0


def cmd_wasm(args):
    from .wasm import WasmError, compile_wasm

    with open(args.input, "rb") as f:
        data = f.read()
    try:
        out = compile_wasm(data)
    except WasmError as e:
        print(f"wasm: {e}", file=sys.stderr)
        return 1
    dest = args.output or args.input.rsplit(".", 1)[0] + ".json"
    _write_program(out.program, dest)
    eps = ", ".join(out.program.entrypoints)
    print(f"compiled {args.input} -> {dest} (entrypoints: {eps})")
    return 0


def cmd_build(args):
    from .compiler import CompilationError, CompilerOptions
    from .compiler.project import compile_project, discover_project

    try:
        out = compile_project(
            args.path, options=CompilerOptions(optimization_level=args.opt)
        )
    except CompilationError as e:
        print(e.render(), file=sys.stderr)
        return 1
    proj = discover_project(args.path)
    dest = args.output or f"{proj.manifest.name}.json"
    _write_program(out.program, dest)
    print(f"built {proj.manifest.name} -> {dest}")
    return 0


def config_for(framing: str):
    """The PcsConfig a proof file of ``framing`` is proved and verified at."""
    return STWO_FRAMING_96_BITS if framing == "stwo" else REGULAR_96_BITS


def _device(name: str):
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(f"--device {name}: {e}")


def _segments_from_trace(program, entrypoint, trace_path):
    """(segments, public address ranges) from the binary trace files that
    ``run --trace-output`` writes; the ranges are recomputed from the
    program ABI as the runner does."""
    from .isa.program import PublicAddressRanges
    from .vm import trace_io

    base, ext = os.path.splitext(trace_path)
    segments = trace_io.segments_from_files(
        trace_path, f"{base}_mem{ext}", f"{base}_initmem{ext}"
    )
    info = program.entrypoints[entrypoint]
    M = sum(p.ty.call_slot_size() for p in info.params)
    K = sum(r.ty.call_slot_size() for r in info.returns)
    return segments, PublicAddressRanges.new(len(program.qm31_words()), M, K)


def cmd_prove(args):
    from . import kernels
    from .prover.adapter.adapter import import_from_runner_output
    from .prover.prove import prove_cairo_m
    from .prover.verify import verify_cairo_m
    from .vm.runner import RunnerOptions, run_cairo_program

    device = _device(args.device)
    cfg = config_for(args.framing)
    program = _load_program(args.program)
    return_values = []
    if args.from_trace:
        segments, ranges = _segments_from_trace(
            program, args.entrypoint, args.from_trace
        )
    else:
        res = run_cairo_program(
            program,
            args.entrypoint,
            _parse_args_list(args.arguments),
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
    ap = argparse.ArgumentParser(prog="cairo-m-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compile")
    c.add_argument("input")
    c.add_argument("-o", "--output")
    c.add_argument("--opt", default="standard", choices=["none", "standard"])
    c.set_defaults(fn=cmd_compile)

    r = sub.add_parser("run")
    r.add_argument("program")
    r.add_argument("--entrypoint", default="main")
    r.add_argument("--arguments", nargs="*", default=[])
    r.add_argument("--max-steps", type=int, default=(1 << 20) - 1)
    r.add_argument("--trace-output")
    r.set_defaults(fn=cmd_run)

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
    p.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device to prove on, e.g. cuda, cuda:1 or cpu "
                   "(default: cuda)")
    p.set_defaults(fn=cmd_prove)

    v = sub.add_parser("verify")
    v.add_argument("proof")
    v.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device that recomputes the preprocessed "
                   "commitment (default: cuda)")
    v.set_defaults(fn=cmd_verify)

    f = sub.add_parser("fmt", help="format .cm sources in place")
    f.add_argument("files", nargs="+")
    f.add_argument("--check", action="store_true",
                   help="exit 1 if any file would change")
    f.set_defaults(fn=cmd_fmt)

    i = sub.add_parser("init", help="scaffold a new cairom.toml project")
    i.add_argument("path")
    i.add_argument("--name")
    i.set_defaults(fn=cmd_init)

    w = sub.add_parser("wasm", help="compile a WebAssembly module (i32 subset)")
    w.add_argument("input")
    w.add_argument("--output", "-o")
    w.set_defaults(fn=cmd_wasm)

    b = sub.add_parser("build", help="compile a cairom.toml project")
    b.add_argument("path", nargs="?", default=".")
    b.add_argument("--output", "-o")
    b.add_argument("--opt", default="standard", choices=["none", "standard"])
    b.set_defaults(fn=cmd_build)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
