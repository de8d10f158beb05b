"""A run with the timed path broken underneath comes out not correct: the
harness's run on the CPU at the tests' scale (its look for a card
skipped), once sound and once for each fault a cell can have, and once
for the control (the program one query below the stated security).

The faults: the VM's answer altered where it is produced; kernel A's
digests altered (every leaf); kernel B's output altered in the
interaction pass and in the composition pass; a job handed the proof of
the job before it (a state returned unchanged).  One job at a time on one card,
so no batch can lose half its rows and no exchange between cards can be
left out."""

import sys

import pytest
import torch

from benchmark import run as R
from benchmark.conftest import small

P = (1 << 31) - 1
MIX = {"args": [{"low": 30, "high": 40}]}


@pytest.fixture(autouse=True)
def fresh_port_caches(monkeypatch):
    """The port caches the preprocessed commitment a process: a fault in
    one test must not leave its tables to the next."""
    import cairo_m_tpu_torch.prover.prove as pv

    monkeypatch.setattr(pv, "_PRE_PHASE_CACHE", {})
    monkeypatch.setattr(pv, "_PRE_STACK_CACHE", {})


def _cell():
    bench = R.load_benchmark()
    cell, config, _ = R.load_cell(bench, "fib_loop.100k")
    return bench, cell, small(config)


def _alter_output(monkeypatch):
    import cairo_m_tpu_torch.prover.adapter.native_import as ni

    real = ni.native_prover_input

    def fake(*a, **k):
        pi = real(*a, **k)
        addr = pi.public_address_ranges.output[0]
        v, clock = pi.final_memory[addr][0], pi.final_memory[addr][1:]
        pi.final_memory[addr] = ((tuple([(v[0] + 1) % P, *v[1:]]),) + tuple(clock))
        return pi

    monkeypatch.setattr(ni, "native_prover_input", fake)


def _alter_kernel_a(monkeypatch):
    import cairo_m_tpu_torch.hash.blake2s as b

    real = b.hash_leaves

    def fake(stacked, n_words=None, out=None):
        out = real(stacked, n_words, out)
        out[0] ^= 1
        return out

    monkeypatch.setattr(b, "hash_leaves", fake)


def _alter_kernel_b(pass_name):
    def patch(monkeypatch):
        import cairo_m_tpu_torch.prover.stark.framework as fw

        real = fw.run_wide

        def fake(*a, **k):
            out = real(*a, **k)
            if sys._getframe(1).f_code.co_name == pass_name:
                out[0, 0] = (out[0, 0] + 1) % P
            return out

        monkeypatch.setattr(fw, "run_wide", fake)
    return patch


def _stale_proof(monkeypatch):
    import cairo_m_tpu_torch.prover.prove as pv

    real, first = pv.prove_cairo_m, []

    def fake(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    monkeypatch.setattr(pv, "prove_cairo_m", fake)


FAULTS = {
    "vm_output": _alter_output,
    "kernel_a_digests": _alter_kernel_a,
    "kernel_b_interaction": _alter_kernel_b("gen_interaction_trace_device"),
    "kernel_b_composition": _alter_kernel_b("compute_composition"),
    "stale_proof": _stale_proof,
}


def _run(config, seconds=0.0):
    bench, cell, _ = _cell()
    torch.set_num_threads(2)
    res = R.run(cell, config, MIX, R.cell_metrics(bench, cell, False), 2**33 + 5,
                seconds, False, device="cpu")
    res["peak_bytes"] = 0
    return R.result_line(res, "cpu", False)


def test_sound_run_is_correct():
    line = _run(_cell()[2])
    assert line["correct"] is True and line["attempted"] == 1
    assert not R.forbidden_modules()


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line = _run(_cell()[2])
    assert line["correct"] is False, line["checks"]


def test_control_is_not_correct():
    """The control: the program one query below what the configuration
    states, its proofs judged at the stated security, on three seeds;
    the program as stated on the same seeds reads sound."""
    from benchmark.control import readings

    torch.set_num_threads(2)
    out = readings(_cell()[2], MIX, [3, 2**32 + 9, 2**40 + 17], device="cpu")
    for side, seed, checks in out:
        want = 0 if side == "program" else 1
        assert checks["rejected_proofs"]["value"] == want, (side, seed, checks)
        assert checks["wrong_answers"]["value"] == 0
