"""The control of the comparison that decides ``correct``: the program
run one step below the security its configuration states (one query
fewer: 95 bits, the step that would buy a faster prove and verify), its
proofs judged by the reference at the stated security, beside the program
run as stated, on the same seeds' jobs, in one process.

    python3 -m benchmark.control --workload <cell> --seeds <n> <n> <n> [--sides control]

One line of JSON a seed and side on standard output: the numbers that a
run compares (``wrong_answers``, ``rejected_proofs``) and the reference's
reason.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

from . import run as R
from .traffic import Stream


def weakened(config: dict) -> dict:
    c = copy.deepcopy(config)
    c["security"]["n_queries"] -= 1
    return c


SIDES = ("program", "control")


def readings(config: dict, mix: dict, seeds, device: str = "cuda", seconds: float = 0.0,
             chips: int = 1, sides=SIDES):
    """[(side, seed, checks)]: for each side (the program as stated, the
    control), one set-up, then for each seed the jobs of a window of
    ``seconds`` (at least one) on that seed's stream, judged at the stated
    security.  The job is the configuration's kind (`run.job_kind`)."""
    if R.job_kind(config) == "chain":
        return chain_readings(config, mix, seeds, device, seconds, chips, sides)
    import torch

    on_card = device.startswith("cuda")

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    R.set_port_scale(config)
    prog = R.Program(config)
    out = []
    for side, cfg in (("program", config), ("control", weakened(config))):
        security = R.port_security(cfg)
        R.run_job(prog, Stream(mix, seeds[0]).next(), security, device, sync)  # cold
        for seed in seeds:
            stream = Stream(mix, seed)
            jobs, _, _ = R.run_window(
                lambda: R.run_job(prog, stream.next(), security, device, sync), seconds)
            out.append((side, seed, R.judge(config, jobs, seed, n_verified=len(jobs))))
    return out


def chain_readings(config: dict, mix: dict, seeds, device: str, seconds: float, chips: int,
                   sides=SIDES):
    """`readings` for a chain configuration: each chain's workers are
    fresh processes, so no set-up chain warms anything; a window's
    chains are judged as a run judges them (`chain.judge_chain`)."""
    from .chain import Chain, judge_chain, run_chain_job

    out = []
    for side in sides:
        chain = Chain(config if side == "program" else weakened(config), chips, device)
        for seed in seeds:
            stream = Stream(mix, seed)
            jobs, _, _ = R.run_window(lambda: run_chain_job(chain, stream.next()), seconds)
            out.append((side, seed, judge_chain(config, jobs, seed)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--sides", nargs="+", choices=SIDES, default=list(SIDES))
    a = ap.parse_args(argv)
    bench = R.load_benchmark()
    cell, config, mix = R.load_cell(bench, a.workload)
    import torch

    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        R.log(f"needs {chips} CUDA card(s)")
        return 2
    R.log(f"card: {R.card_line()}")
    t = time.monotonic()
    for side, seed, checks in readings(config, mix, a.seeds, seconds=a.seconds, chips=chips,
                                       sides=a.sides):
        print(json.dumps({"workload": a.workload, "side": side, "seed": seed,
                          "checks": checks}), flush=True)
    R.log(f"control readings in {time.monotonic() - t:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
