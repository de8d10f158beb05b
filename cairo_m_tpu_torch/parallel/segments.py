"""Multi-process continuation-segment proving on named torch devices.

Counterpart of ``cairo_m_tpu.parallel.segments`` (reference continuation
semantics `crates/runner/src/vm/mod.rs:177-227`, chained proofs
`crates/prover/tests/prover.rs:204-243`).  A program longer than the
segment cap (2^20 - 1 steps in production) is proved as chained segments:
every worker process re-runs the (cheap, deterministic) native VM + adapter
and proves segments ``proc_id, proc_id + N, ...`` independently on
``devices[proc_id % len(devices)]``, then verifies each of its proofs.
Segment proofs share no state, so the only communication is the final
collection; several workers may share one card.

Chain integrity: the coordinator raises unless the segment set is complete
and ``final_root(k) == initial_root(k+1)`` holds across every boundary.

Each record also carries the worker that proved it, its prove and verify
seconds, and the kernel launches of its prove + verify
(``cairo_m_tpu_torch.kernels.launches``), so a caller can show that the
CUDA kernels ran inside the workers.  Workers never import JAX.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time


def _worker_main(argv):
    import argparse

    ap = argparse.ArgumentParser()
    # the coordinator's ephemeral port; segment proving needs no
    # collectives, so no worker joins a process group on it (a
    # torch.distributed group comes with row-sharding)
    ap.add_argument("--coordinator", required=True)
    ap.add_argument("--num-procs", type=int, required=True)
    ap.add_argument("--proc-id", type=int, required=True)
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--device", required=True)
    args = ap.parse_args(argv)

    from .. import kernels
    from ..compiler import compile_cairo
    from ..device import resolve_device
    from ..prover.adapter.native_import import native_segment_prover_inputs
    from ..prover.config import REGULAR_96_BITS, set_test_scale, test_config
    from ..prover.prove import prove_cairo_m
    from ..prover.verify import verify_cairo_m

    device = resolve_device(args.device)
    with open(os.path.join(args.workdir, "job.json")) as f:
        spec = json.load(f)
    if spec.get("test_scale"):
        set_test_scale(**spec["test_scale"])
    cfg = (
        test_config(**spec["test_config"])
        if spec.get("test_config")
        else REGULAR_96_BITS
    )
    program = compile_cairo(spec["source"]).program
    out = []
    for k, pi in enumerate(
        native_segment_prover_inputs(
            program, spec["entrypoint"], spec["args"], spec["max_steps"]
        )
    ):
        if k % args.num_procs != args.proc_id:
            continue
        kernels.reset_launches()
        t = time.perf_counter()
        proof = prove_cairo_m(pi, cfg, device=device)
        prove_s = time.perf_counter() - t
        if not verify_cairo_m(proof, cfg, device=device):
            raise RuntimeError(f"segment {k}: proof failed verification")
        out.append(
            {
                "segment": k,
                "worker": args.proc_id,
                "initial_root": pi.merkle_trees.initial_root,
                "final_root": pi.merkle_trees.final_root,
                "n_steps": pi.total_steps,
                "prove_s": prove_s,
                "verify_s": time.perf_counter() - t - prove_s,
                "launches": dict(kernels.launches),
                "proof": proof.to_json_obj(),
            }
        )
    with open(os.path.join(args.workdir, f"proofs_{args.proc_id}.json"), "w") as f:
        json.dump(out, f)


def check_chain(records):
    """Sort per-segment records by segment; raise unless the set is
    complete and ``final_root(k) == initial_root(k+1)`` at every boundary.
    Explicit raises, not asserts: this is the chain-integrity contract and
    must survive ``python -O``."""
    records = sorted(records, key=lambda r: r["segment"])
    if [r["segment"] for r in records] != list(range(len(records))):
        raise RuntimeError(
            "segment set incomplete or duplicated: "
            f"{[r['segment'] for r in records]}"
        )
    for a, b in zip(records, records[1:]):
        if a["final_root"] != b["initial_root"]:
            raise RuntimeError(
                f"segment root chain broken between {a['segment']} and "
                f"{b['segment']}"
            )
    return records


def prove_segments_multiprocess(
    source: str,
    entrypoint: str,
    args: list,
    max_steps: int,
    devices=("cuda:0",),
    n_processes: int = 2,
    test_scale: dict = None,
    test_config: dict = None,
    timeout: int = 900,
):
    """Launch N worker processes, worker ``i`` on
    ``devices[i % len(devices)]``; round-robin the continuation segments
    across them, collect the proofs, check the Poseidon2 root chain, and
    return the ordered per-segment records.  The default is the first card;
    a worker whose device is a card that does not exist raises."""
    if not devices:
        raise ValueError("prove_segments_multiprocess needs at least one device")
    with tempfile.TemporaryDirectory(prefix="cm_segments_") as workdir:
        # an ephemeral port, never a pid-derived one: those collide across
        # concurrent jobs and pid reuse
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        with open(os.path.join(workdir, "job.json"), "w") as f:
            json.dump(
                {
                    "source": source,
                    "entrypoint": entrypoint,
                    "args": args,
                    "max_steps": max_steps,
                    "test_scale": test_scale,
                    "test_config": test_config,
                },
                f,
            )
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        )
        procs = [
            subprocess.Popen(
                [
                    sys.executable, "-m", "cairo_m_tpu_torch.parallel.segments",
                    "--coordinator", f"localhost:{port}",
                    "--num-procs", str(n_processes),
                    "--proc-id", str(i),
                    "--workdir", workdir,
                    "--device", str(devices[i % len(devices)]),
                ],
                cwd=repo,
            )
            for i in range(n_processes)
        ]
        try:
            for p in procs:
                rc = p.wait(timeout=timeout)
                if rc != 0:
                    raise RuntimeError(f"segment worker exited with {rc}")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        records = []
        for i in range(n_processes):
            with open(os.path.join(workdir, f"proofs_{i}.json")) as f:
                records += json.load(f)
    return check_chain(records)


if __name__ == "__main__":
    _worker_main(sys.argv[1:])
