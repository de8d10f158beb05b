"""The port's language server (cairo_m_tpu_torch/lsp.py, and through it
compiler/semindex.py) vs the JAX package's: the JSON-RPC message sequences
of tests/test_lsp.py, and hover, definition, references and completion at
every position of their sources, go to both ``Server``s; the responses must
be equal once the package name is replaced."""

import json

import pytest

from cairo_m_tpu.lsp import Server as RServer
from cairo_m_tpu_torch.lsp import Server as TServer

GOOD = """
const LIMIT = 10;
struct Point { x: felt, y: u32 }
fn square(v: felt) -> felt { return v * v; }
fn main(n: felt) -> felt { return square(n) + LIMIT; }
"""

BAD = """
fn main() -> felt { return missing_var; }
fn other() -> u32 { return 1u32 + also_missing; }
"""

NAV = """const K = 7;
struct Point { x: felt, y: felt }
fn helper(v: felt) -> felt {
    let doubled = v * 2;
    return doubled + K;
}
fn main() -> felt {
    let p = Point { x: 1, y: 2 };
    return helper(p.x);
}
"""

SHADOW = """fn f(n: felt) -> felt {
    let x = 1;
    if (n != 0) {
        let x = 2;
        let y = x + 1;
    }
    return x;
}
"""

COMPLETE = """struct Point { x: felt, y: felt }
fn helper(value: felt) -> felt {
    return value;
}
fn main(count: felt) -> felt {
    let pt: Point = Point { x: 1, y: 2 };
    let total = 0;
    return total;
}
"""


def _open(text, uri="u"):
    return [("initialize", {}),
            ("textDocument/didOpen",
             {"textDocument": {"uri": uri, "text": text, "version": 1}})]


def _change(text, uri="u"):
    return ("textDocument/didChange",
            {"textDocument": {"uri": uri}, "contentChanges": [{"text": text}]})


def _at(method, line, ch, uri="u"):
    return (method, {"textDocument": {"uri": uri},
                     "position": {"line": line, "character": ch}})


def _everywhere(text, methods):
    """``methods`` at every position of ``text``, one past each line's end
    included."""
    return [_at(m, i, j) for i, line in enumerate(text.split("\n"))
            for j in range(len(line) + 1) for m in methods]


MEMBER = COMPLETE.replace("    return total;", "    return pt.;\n    return total;")

SEQUENCES = {
    "initialize": [("initialize", {})],
    "diagnostics": _open(BAD) + [_change(GOOD), _change(BAD)],
    "hover": _open(GOOD) + _everywhere(GOOD, ["textDocument/hover"]),
    "formatting": _open("fn main( )->felt{return  1;}") + [
        ("textDocument/formatting", {"textDocument": {"uri": "u"}, "options": {}})],
    "shutdown": [("shutdown", {})],
    "definition_references": _open(NAV) + _everywhere(
        NAV, ["textDocument/definition", "textDocument/references"]) + [
        ("textDocument/documentSymbol", {"textDocument": {"uri": "u"}})],
    "shadowing": _open(SHADOW) + _everywhere(
        SHADOW, ["textDocument/definition", "textDocument/references"]),
    "completion": _open(COMPLETE) + _everywhere(
        COMPLETE, ["textDocument/completion"]) + [_change(MEMBER)] + _everywhere(
        MEMBER, ["textDocument/completion"]),
}


def _responses(server, sequence):
    out = []
    for method, params in sequence:
        out.append(server.handle(method, json.loads(json.dumps(params))))
    out.append({"shutdown_requested": server.shutdown_requested})
    return json.dumps(out, sort_keys=True)


@pytest.mark.parametrize("name", list(SEQUENCES))
def test_responses_identical(name):
    sequence = SEQUENCES[name]
    want = _responses(RServer(), sequence)
    got = _responses(TServer(), sequence).replace("cairo_m_tpu_torch", "cairo_m_tpu")
    assert got == want
    assert len(json.loads(want)) == len(sequence) + 1


def test_sequences_reach_every_handler():
    """The sequences above call every method the reference's tests call,
    and get answers, not errors."""
    methods = {m for seq in SEQUENCES.values() for m, _ in seq}
    assert methods >= {
        "initialize", "shutdown", "textDocument/didOpen", "textDocument/didChange",
        "textDocument/hover", "textDocument/formatting", "textDocument/definition",
        "textDocument/references", "textDocument/documentSymbol",
        "textDocument/completion"}
    s = TServer()
    for method, params in SEQUENCES["definition_references"][:2]:
        s.handle(method, params)
    assert s.handle(*_at("textDocument/definition", 8, 12))["range"]["start"]["line"] == 2
