"""The prover's observability layer in cairo_m_tpu_torch, at test scale
(set_test_scale(10, 8), test_config(n_queries=8, pow_bits=2)), fib-40:

- (a) ``python -m cairo_m_tpu_torch.profile prove --device cpu`` in a
  fresh interpreter that cannot import JAX or cairo_m_tpu: exit 0, its proof
  digest equal to tests/golden/fib40_proof_sha256.json, verified, a JSON
  summary as its last line;
- (b) ``components``: every live component's interaction columns and its
  weighted composition contribution, as the observer saw them, summed, are
  bit-equal to what `prove_cairo_m` itself commits;
- (c) the ``CM_DEBUG_PHASES`` labels, in order, are the reference's,
  printed by the JAX package in a subprocess with the variable set, under
  the native and the stwo framing;
- (d) proof bytes are equal with ``CM_DEBUG_PHASES`` and ``CM_DEBUG_MICRO``
  on and off.
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys

import pytest
import torch

from cairo_m_tpu_torch import profile
from cairo_m_tpu_torch.prover.adapter.native_import import native_prover_input
from cairo_m_tpu_torch.compiler import compile_cairo
from cairo_m_tpu_torch.prover import prove as prove_mod
from cairo_m_tpu_torch.prover.stark import domain, framework, pcs
from cairo_m_tpu_torch.field import m31
from torch_port_helpers import (
    FIB_SRC,
    GOLDEN_DIR,
    both_at_test_scale,
    configs,
    no_jax_command,
    proof_sha256,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDENS = {"native": "fib40_proof_sha256.json",
           "stwo": "fib40_stwo_proof_sha256.json"}


def _golden(framing):
    with open(os.path.join(GOLDEN_DIR, GOLDENS[framing])) as f:
        return json.load(f)["sha256"]


@pytest.fixture(scope="module", autouse=True)
def _test_scale():
    with both_at_test_scale():
        yield


@pytest.fixture(scope="module")
def fib40():
    return native_prover_input(compile_cairo(FIB_SRC).program, "main", [40])


def test_profile_prove_command_without_jax(tmp_path):
    """(a)"""
    argv = ["prove", "--device", "cpu", "--test-scale", "--iters", "40",
            "--runs", "cold", "--verify", "--save-proof", str(tmp_path)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("CM_DEBUG_PHASES", None)
    res = subprocess.run(no_jax_command("cairo_m_tpu_torch.profile", argv),
                         capture_output=True, text=True, cwd=REPO, env=env,
                         timeout=600)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    lines = res.stdout.strip().splitlines()
    summary = json.loads(lines[-1])
    (entry,) = summary["fib"]
    assert entry["iters"] == 40 and entry["cycles"] == 330
    assert entry["sha256"] == _golden("native")
    assert entry["verified"] is True
    assert set(entry["runs"]) == {"cold"}
    cold = entry["runs"]["cold"]
    assert set(cold["phases"]) == {"trace", "interaction", "composition", "pcs", "total",
                                   "poseidon2_witness"}
    assert cold["seconds"] > 0 and cold["peak_device_bytes"] is None
    assert entry["log_sizes"]["store_add_fp_imm"] == 8
    # the last run prints its phase lines
    assert any(l.startswith("[prove +") and l.endswith("pcs prove_values") for l in lines)
    with open(os.path.join(tmp_path, "fib_40_proof.json")) as f:
        saved = f.read()
    assert profile.hashlib.sha256(saved.encode()).hexdigest() == _golden("native")
    with open(os.path.join(tmp_path, "fib_40_proof.json.sha256")) as f:
        assert f.read().strip() == _golden("native")


def test_components_pieces_are_what_the_prover_commits(fib40, monkeypatch):
    """(b) The observed pieces of the profiled proof against the columns the
    warm-up proof (no observer) commits: interaction columns equal, and
    the composition contributions summed per domain equal the committed
    composition."""
    _, cfg = configs()
    commits = []
    orig = pcs.CommitmentSchemeProver.commit

    def commit(self, columns, prepare=None):
        # the columns in the FFT order the phase commits them in
        commits.append([(l, prepare(st) if prepare else st) for l, st in columns])
        return orig(self, columns, prepare)

    monkeypatch.setattr(pcs.CommitmentSchemeProver, "commit", commit)
    proof, rec, timer = profile.profile_components(fib40, cfg, torch.device("cpu"),
                                                   keep=True)
    # each proof commits trace, interaction, composition
    assert len(commits) == 6
    _, inter, comp_commit = commits[:3]
    assert proof_sha256(proof) == _golden("native")

    names = [c.name for c in prove_mod.ComponentSet(prove_mod.Relations()).all]
    log_size = dict(zip(names, proof.log_sizes))
    live = [n for n in names if ("interaction", n) in timer.outputs]
    assert len(live) == 11
    assert [r["component"] for r in timer.rows if r["stage"] == "interaction"] == live
    for name, (l, committed) in zip(names, inter, strict=True):
        assert l == log_size[name]
        out = timer.outputs.get(("interaction", name))
        if out is None:
            assert not committed.any()  # zero-witness component
        else:
            assert torch.equal(domain.to_fft_order(out), committed), name

    blowup = cfg.fri_config.log_blowup_factor
    by_elog = {}
    for name in live:
        weighted = timer.outputs[("composition", name)]
        elog = log_size[name] + blowup
        acc = by_elog.get(elog)
        by_elog[elog] = weighted if acc is None else tuple(
            m31.add(a, b) for a, b in zip(acc, weighted))
    max_elog = max(proof.log_sizes) + blowup
    summed = torch.stack(framework.composition_from_sums(by_elog, max_elog))
    ((l, committed),) = comp_commit
    assert l == max_elog
    assert torch.equal(summed, committed)
    for r in timer.rows:
        assert 0 <= r["dispatch_s"] <= r["seconds"]
    assert rec["phases"]["total"] > 0


def _labels(text):
    """The CM_DEBUG_PHASES labels of a run's output, in order; the numbers
    inside ``write_traces (...)`` (and the reference's ``pack`` where the
    port uploads without packing) are not part of the label."""
    out = []
    for line in text.splitlines():
        m = re.match(r"^(\[prove|  \[pcs) \+\s*[0-9.]+s\] (.*)$", line)
        if m:
            label = m.group(2)
            if label.startswith("write_traces ("):
                label = "write_traces (...)"
            out.append((m.group(1).strip(), label))
    return out


_REFERENCE_LABELS = """
import sys
sys.path[:0] = [{repo!r}, {tests!r}]
import conftest, torch_port_helpers as h
for framing in ("native", "stwo"):
    print("=== " + framing, flush=True)
    h.reference_fib40_proof(framing)
"""


@pytest.fixture(scope="module")
def reference_labels():
    """The reference's labels per framing, printed by the JAX package in a
    subprocess with CM_DEBUG_PHASES set (it reads the switch at import)."""
    env = dict(os.environ, CM_DEBUG_PHASES="1", JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, "-c", _REFERENCE_LABELS.format(
            repo=REPO, tests=os.path.join(REPO, "tests"))],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    parts = res.stdout.split("=== ")[1:]
    return {p.split("\n", 1)[0]: _labels(p) for p in parts}


@pytest.fixture(scope="module")
def port_runs(fib40):
    """Per framing: (stdout, proof digest) of the port's proof with both
    switches on, and the digest with both off."""
    out = {}
    for framing in ("native", "stwo"):
        _, cfg = configs(framing)
        runs = {}
        for on in (True, False):
            buf = io.StringIO()
            with contextlib.ExitStack() as stack:
                for name in ("CM_DEBUG_PHASES", "CM_DEBUG_MICRO"):
                    stack.enter_context(profile.env_switch(name, on))
                    if not on:
                        stack.enter_context(_unset(name))
                stack.enter_context(contextlib.redirect_stdout(buf))
                proof = prove_mod.prove_cairo_m(fib40, cfg, device="cpu")
            runs[on] = (buf.getvalue(), proof_sha256(proof))
        out[framing] = runs
    return out


@contextlib.contextmanager
def _unset(name):
    old = os.environ.pop(name, None)
    try:
        yield
    finally:
        if old is not None:
            os.environ[name] = old


@pytest.mark.parametrize("framing", ["native", "stwo"])
def test_debug_phase_labels_match_the_reference(framing, reference_labels, port_runs):
    """(c)"""
    want = reference_labels[framing]
    assert want[0] == ("[prove", "public data") and want[-1] == ("[prove", "pcs prove_values")
    got = _labels(port_runs[framing][True][0])
    assert got == want
    # the port's switch is read when the prover runs: off means silent
    assert _labels(port_runs[framing][False][0]) == []


@pytest.mark.parametrize("framing", ["native", "stwo"])
def test_debug_switches_leave_proof_bytes(framing, port_runs):
    """(d)"""
    (on_out, on_digest), (_, off_digest) = port_runs[framing][True], port_runs[framing][False]
    assert on_digest == off_digest == _golden(framing)
    micro = [l for l in on_out.splitlines() if re.match(r"^    \[(micro|fri) \+", l)]
    assert any("fft k=" in l for l in micro) and any("layer k=" in l for l in micro)
    if framing == "native":
        assert any("merkle pyramid" in l for l in micro)
        assert any("top pull + host mirror" in l for l in micro)
    else:
        assert any("stwo mixed-degree tree" in l for l in micro)
