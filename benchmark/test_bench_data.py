"""The benchmark's data: BENCHMARK.json against the contract's forms, each
name's files, the traffic streams, the answers, and the seeded inputs'
shapes."""

import json
import re
from pathlib import Path

import pytest

from benchmark import run as R
from benchmark.traffic import Stream, load_mix

ROOT = Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("benchmark/")
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert w["config"] in [c["name"] for c in BENCH["configs"]]
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        names += [w["name"], w["traffic"]]
    for kind in ("end_to_end", "per_layer"):
        for m in BENCH[kind]:
            assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
            assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
            names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    assert "setup_s" in [m["name"] for m in BENCH["end_to_end"]]
    for n in names:
        assert NAME.match(n), n
    assert len(ROOT.joinpath("BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_configs_match_their_entries():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] == []
        assert (ROOT / cfg["program"]).is_file()
        assert (ROOT / "benchmark" / "reference" / "answers" / f"{c['name']}.py").is_file()


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_stream_is_fixed_by_the_seed(seed):
    mix = load_mix("fib_100k")
    a, b = Stream(mix, seed), Stream(mix, seed)
    xs = [a.next() for _ in range(50)]
    assert xs == [b.next() for _ in range(50)]
    assert all(99000 <= x[0] <= 100000 for x in xs)
    assert all(x != y for x, y in zip(xs, xs[1:]))
    assert xs != [Stream(mix, seed + 1).next() for _ in range(50)]


def test_fib_answer_matches_the_loop():
    from benchmark.reference.answers import fib_loop

    a, b = 0, 1
    for n in range(300):
        assert fib_loop.output_slots([n]) == [a]
        a, b = b, (a + b) % ((1 << 31) - 1)


def test_sha256_answer_at_zero_is_bench1k():
    import hashlib
    import struct

    from benchmark.reference.answers import sha256_1k

    msg = b"".join(struct.pack(">I", i * 16 + j) for i in range(16) for j in range(16))
    words = struct.unpack(">8I", hashlib.sha256(msg).digest())
    assert sha256_1k.output_slots([0]) == [x for w in words for x in (w & 0xFFFF, w >> 16)]
    assert sha256_1k.input_slots([0x12345678]) == [0x5678, 0x1234]


def _shape(config_name, args):
    from cairo_m_tpu_torch.prover import config as pc
    from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet
    from cairo_m_tpu_torch.prover.relations import Relations

    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{config_name}.json").read_text())
    pc.set_production_scale()
    prog = R.Program(cfg)
    pi = native_prover_input(prog.program, prog.entry, prog.slots(args), prog.max_steps)
    comps = ComponentSet(Relations())
    comps.write_traces(pi)
    return pi.total_steps, [c.log_size for c in comps.all]


@pytest.mark.parametrize("mix,config,upstream", [
    ("fib_100k", "fib_loop", [100000]),
    ("fib_1m", "fib_loop", [1000000]),
    ("sha256_bench1k", "sha256_1k", [0]),
])
def test_seeded_inputs_keep_every_log_size(mix, config, upstream):
    m = load_mix(mix)
    lo = [a["low"] for a in m["args"]]
    hi = [a["high"] for a in m["args"]]
    _, want = _shape(config, upstream)
    for args in (lo, hi, Stream(m, 2**35 + 1).next()):
        assert _shape(config, args)[1] == want, args
