"""The compiler, formatter, wasm lowering and mdtest runner that
cairo_m_tpu_torch keeps as its own copies vs the JAX package's originals:
the same text or bytes through both give equal output.  Everything compared
is text or integers, so equality is exact.

- every ``.cm`` under examples/ and every ```cairo-m block of the language
  conformance corpus tests/mdtest/ (grouped by file) through both
  ``compile_cairo`` at both optimization levels: equal ``Program`` JSON, or
  the same diagnostics where compilation fails;
- the formatter's output on the same sources;
- the wasm lowering on the modules tests/test_wasm.py assembles in code;
- the port's own mdtest runner passes the corpus (its compiler and VM
  end to end against the corpus's expected values).
"""

import glob
import os

import pytest

import test_wasm as W
from cairo_m_tpu import compiler as rcompiler
from cairo_m_tpu import wasm as rwasm
from cairo_m_tpu.compiler import formatter as rformatter
from cairo_m_tpu_torch import compiler as tcompiler
from cairo_m_tpu_torch import wasm as twasm
from cairo_m_tpu_torch.compiler import formatter as tformatter
from cairo_m_tpu_torch.testing.mdtest import discover, run_md_test
from torch_port_helpers import FIB_SRC

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
CORPUS = os.path.join(TESTS, "mdtest")


def _sources():
    """{case id: [source text, ...]}: the examples one by one, the corpus
    one case per markdown file."""
    out = {"fib": [FIB_SRC]}
    for path in sorted(glob.glob(os.path.join(REPO, "examples", "**", "*.cm"),
                                 recursive=True)):
        with open(path) as f:
            out[os.path.relpath(path, REPO)] = [f.read()]
    for t in discover(CORPUS):
        rel = os.path.relpath(t.path, CORPUS).replace(".md", "")
        out.setdefault(rel, []).append(t.cairo_source)
    return out


SOURCES = _sources()


def _compile(mod, src, level):
    """Program JSON, or the diagnostics of a failed compilation."""
    try:
        out = mod.compile_cairo(
            src, options=mod.CompilerOptions(optimization_level=level))
    except mod.CompilationError as e:
        return ("error", [(d.line, d.severity, d.message) for d in e.diagnostics])
    return ("program", out.program.to_json(),
            [(d.line, d.severity, d.message) for d in out.diagnostics])


def test_corpus_is_there():
    assert len(SOURCES) >= 15
    assert sum(len(v) for v in SOURCES.values()) >= 50
    assert any(k.startswith("examples") for k in SOURCES)


@pytest.mark.parametrize("level", ["none", "standard"])
@pytest.mark.parametrize("case", sorted(SOURCES))
def test_compile_equal(case, level):
    compiled = 0
    for src in SOURCES[case]:
        want = _compile(rcompiler, src, level)
        assert _compile(tcompiler, src, level) == want
        compiled += want[0] == "program"
    if "diagnostics" not in case:
        assert compiled  # the case is not only failures


def _format(mod, lex_error, src):
    try:
        return mod.format_source(src)
    except lex_error as e:
        return ("error", str(e))


@pytest.mark.parametrize("case", sorted(SOURCES))
def test_format_equal(case):
    for src in SOURCES[case]:
        want = _format(rformatter, rformatter.LexError, src)
        got = _format(tformatter, tformatter.LexError, src)
        assert got == want
        if isinstance(want, str):  # formatting is idempotent in the copy too
            assert tformatter.format_source(got) == got


def _wasm_modules():
    w = W
    fib_body = (
        w.i32c(1) + w.LS2 + b"\x02\x40" + b"\x03\x40"
        + w.LG0 + b"\x45" + b"\x0d\x01"
        + w.LG2 + w.LG1 + w.LG2 + b"\x6a" + w.LS2 + w.LS1
        + w.LG0 + w.i32c(1) + b"\x6b" + w.LS0
        + b"\x0c\x00" + b"\x0b" + b"\x0b" + w.LG1
    )
    if_body = (
        w.LG0 + w.i32c(10) + b"\x4b" + b"\x04\x7f" + w.LG0 + w.i32c(10) + b"\x6b"
        + b"\x05" + w.LG0 + w.i32c(100) + b"\x6a" + b"\x0b"
    )
    g = (0, w.LG0 + w.i32c(3) + b"\x6c")
    f = (0, w.LG0 + b"\x10\x01" + w.LG1 + b"\x10\x01" + w.LG0 + w.LG1
         + b"\x49" + b"\x1b")
    peek = w.LG0 + w.I32_LOAD + w._memarg()
    return {
        "addmul": w.module([(2, 1)], [0], {"addmul": 0},
                           [(0, w.LG0 + w.LG1 + b"\x6a" + w.LG0 + b"\x6c")]),
        "divrem": w.module(
            [(2, 1)], [0], {"f": 0},
            [(0, w.LG0 + w.LG1 + b"\x6b" + w.LG0 + w.LG1 + b"\x6e" + b"\x6a"
              + w.LG0 + w.LG1 + b"\x70" + b"\x6a")]),
        "cmp": w.module(
            [(2, 1)], [0], {"cmp": 0},
            [(0, w.LG0 + w.LG1 + b"\x49" + w.LG0 + w.LG1 + b"\x46" + b"\x6a"
              + w.LG0 + b"\x45" + b"\x6a")]),
        "fib_loop": w.module([(1, 1)], [0], {"fib": 0}, [(2, fib_body)]),
        "call_select": w.module([(2, 1), (1, 1)], [0, 1], {"f": 0, "g": 1}, [f, g]),
        "if_else": w.module([(1, 1)], [0], {"f": 0}, [(0, if_body)]),
        "memory_rw": w._mem_rw_module(),
        "data_segment": w.module(
            [(1, 1)], [0], {"peek": 0}, [(0, peek)], mem_pages=1,
            data=[(8, (42).to_bytes(4, "little")), (16, b"abcd")]),
    }


WASM = _wasm_modules()


@pytest.mark.parametrize("name", sorted(WASM))
def test_wasm_lowering_equal(name):
    want = rwasm.compile_wasm(WASM[name]).program.to_json()
    assert twasm.compile_wasm(WASM[name]).program.to_json() == want


@pytest.mark.parametrize("data", [b"not wasm", WASM["addmul"][:12] + b"\xff\x01\x00"],
                         ids=["no_magic", "bad_section"])
def test_wasm_rejects_like_the_reference(data):
    with pytest.raises(rwasm.WasmError) as want:
        rwasm.compile_wasm(data)
    with pytest.raises(twasm.WasmError) as got:
        twasm.compile_wasm(data)
    assert str(got.value) == str(want.value)


MD_FILES = sorted({t.path for t in discover(CORPUS)})


@pytest.mark.parametrize(
    "path", MD_FILES, ids=[os.path.relpath(p, CORPUS).replace(".md", "") for p in MD_FILES])
def test_port_mdtest_runner_passes_corpus(path):
    ran = 0
    for t in discover(CORPUS):
        if t.path == path and t.ignore is None:
            run_md_test(t)
            ran += 1
    assert ran
