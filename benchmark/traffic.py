"""The one traffic generator: a mix is a JSON file under ``traffic/`` that
names, for each argument of the cell's entry point, the closed range its
value is drawn from (``{"args": [{"low": 99000, "high": 100000}]}``).

Jobs arrive closed-loop, one at a time: the next job is drawn when the
last one has finished.  The seed fixes the whole stream, so two runs with
one seed send the same jobs in the same order; no job's arguments equal
the job's before it.
"""

from __future__ import annotations

import json
import random
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    mix = json.loads((HERE / "traffic" / f"{name}.json").read_text())
    for a in mix["args"]:
        if not 0 <= int(a["low"]) <= int(a["high"]) < 1 << 32:
            raise ValueError(f"traffic {name}: bad range {a}")
    return mix


class Stream:
    """The seed's stream of argument lists for one mix."""

    def __init__(self, mix: dict, seed: int):
        self.ranges = [(int(a["low"]), int(a["high"])) for a in mix["args"]]
        self.rng = random.Random(int(seed))
        self.last = None
        if all(lo == hi for lo, hi in self.ranges) and self.ranges:
            raise ValueError("a mix needs a range with more than one value")

    def next(self) -> list:
        while True:
            args = [self.rng.randint(lo, hi) for lo, hi in self.ranges]
            if args != self.last:
                self.last = args
                return args
