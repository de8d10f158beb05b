"""Cairo-M source formatter: token stream -> Wadler doc IR -> text.

Role of `crates/compiler/formatter` (doc-IR pretty printer with comment
preservation, SURVEY.md §2.3; doc engine `formatter/src/doc.rs`, defaults
`config.rs`: max_width 100, indent 4, no trailing comma).

Design: comment preservation is token-first — formatting re-emits the
comment-carrying token stream, so comments survive by construction and
idempotence is structural (format(format(x)) == format(x), tested in
tests/test_tooling.py).  Statement structure (blocks, `}`-chains, blank
lines) is resolved on the token walk; each logical line then becomes a
`doc.py` document where every bracket pair is a group — rendered flat
when it fits the width, otherwise broken after the open bracket and at
commas with a 4-space relative indent.

Canon: 4-space indent; 100-column width; one space around binary
operators, after commas and around `->`; no space inside parens/brackets
or before `;`/`,`; `{` on the same line; at most one consecutive blank
line; line comments keep their attachment (same line -> two spaces before
`//`).
"""

from __future__ import annotations

from . import doc
from .lexer import LexError, tokenize

INDENT = "    "
INDENT_W = 4
MAX_WIDTH = 100

# operators glued to the previous token (no space before)
_NO_SPACE_BEFORE = {",", ";", ")", "]", ".", ":"}
_NO_SPACE_AFTER = {"(", "[", ".", "!"}


def format_source(src: str, max_width: int = MAX_WIDTH) -> str:
    toks = [t for t in tokenize(src, keep_comments=True) if t.kind != "eof"]
    out_lines: list[str] = []
    cur: list = []  # tokens of the logical line being collected
    line_depth = 0  # indent depth captured at the line's first token
    depth = 0
    prev_line = 0

    def flush(trailing: str | None = None):
        nonlocal cur
        if not cur and trailing is None:
            return
        base = INDENT * line_depth
        if cur:
            body = doc.render(
                doc.concat(_line_doc(cur)),
                max(max_width - len(base), 24),
            )
            lines = body.split("\n")
            rendered = [base + lines[0]] + [base + l for l in lines[1:]]
        else:
            rendered = [base.rstrip()]
        if trailing is not None:
            rendered[-1] = (rendered[-1] + "  " + trailing).strip() if not cur else rendered[-1] + "  " + trailing
        out_lines.extend(r.rstrip() for r in rendered)
        cur = []

    def begin(tok):
        nonlocal line_depth
        if not cur:
            line_depth = depth
            blank_gap(tok)

    def blank_gap(tok):
        """Preserve at most one blank line from the original."""
        if prev_line and tok.line > prev_line + 1 and out_lines and out_lines[-1] != "":
            out_lines.append("")

    i = 0
    while i < len(toks):
        t = toks[i]
        if t.kind == "comment":
            if cur and t.line == prev_line:
                flush(trailing=t.text)
            else:
                flush()
                blank_gap(t)
                for k, cl in enumerate(t.text.splitlines()):
                    out_lines.append(
                        (INDENT * depth + (cl.strip() if k else cl.rstrip())).rstrip()
                    )
            prev_line = t.line + t.text.count("\n")
            i += 1
            continue

        if t.text == "}":
            flush()
            depth = max(0, depth - 1)
            begin(t)
            cur.append(t)
            prev_line = t.line
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            # `} else`, `};`, `},` continue the line
            if nxt is not None and (nxt.text in (";", ",") or nxt.text == "else"):
                i += 1
                continue
            flush()
            i += 1
            continue

        begin(t)
        cur.append(t)
        prev_line = t.line

        if t.text == "{":
            depth += 1
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            # attached trailing comment stays on this line
            if not (nxt is not None and nxt.kind == "comment" and nxt.line == t.line):
                flush()
        elif t.text == ";":
            nxt = toks[i + 1] if i + 1 < len(toks) else None
            if not (nxt is not None and nxt.kind == "comment" and nxt.line == t.line):
                flush()
        i += 1

    flush()
    while out_lines and out_lines[-1] == "":
        out_lines.pop()
    return "\n".join(out_lines) + "\n"


def _line_doc(toks):
    """Token list (one logical line) -> doc parts.  Every bracket pair is a
    group: flat when it fits, else broken after the open bracket and at its
    commas, body indented one level."""

    def walk(i, prev, closer):
        parts = []
        while i < len(toks):
            t = toks[i]
            if closer is not None and t.text == closer:
                return parts, i, prev
            if t.text in ("(", "["):
                close = ")" if t.text == "(" else "]"
                open_txt = _sep(prev, t) + t.text
                inner, j, _last = walk(i + 1, None, close)
                if j < len(toks):
                    parts.append(
                        doc.group(
                            doc.concat(
                                [
                                    doc.text(open_txt),
                                    doc.indent(
                                        INDENT_W,
                                        doc.concat([doc.softline()] + inner),
                                    ),
                                    doc.softline(),
                                    doc.text(close),
                                ]
                            )
                        )
                    )
                    prev = toks[j]
                    i = j + 1
                    continue
                # unbalanced bracket (broken source): emit verbatim
                parts.append(doc.text(open_txt))
                parts.extend(inner)
                return parts, j, _last
            if t.text == "," and closer is not None:
                parts.append(doc.text(","))
                parts.append(doc.line())
                prev = None  # no separator after a break point
                i += 1
                continue
            parts.append(doc.text(_sep(prev, t) + t.text))
            prev = t
            i += 1
        return parts, i, prev

    parts, _, _ = walk(0, None, None)
    return parts


def _sep(prev, t) -> str:
    """Separator between the previous emitted token and t."""
    if prev is None:
        return ""
    a, b = prev.text, t.text
    if b in _NO_SPACE_BEFORE:
        return ""
    if a in _NO_SPACE_AFTER:
        return ""
    if b in ("(", "["):
        # call/index glue: ident( fn( )( ][  — but keyword ( gets a space
        if prev.kind in ("ident", "u32lit", "int") or a in (")", "]"):
            return ""
        if prev.kind == "kw" and a in ("fn",):
            return ""
        return " " if a not in ("(", "[") else ""
    if a == ")" and b == "{":
        return " "
    if a in ("{",):
        return " " if b == "}" else ""
    if b == "}":
        return " "
    # unary +/-/! after operator/keyword/open: glue
    if b in ("-", "!", "&", "*") and (prev.kind == "op" and a not in (")", "]")):
        return "" if a in ("(", "[", ",") else " "
    if prev.kind == "op" and a in ("-", "!"):
        # after a unary operator, glue the operand
        return ""
    if a == "," or a == ";":
        return " "
    if a == ":":
        return " "
    if prev.kind == "op" and a not in (")", "]"):
        return " "
    if t.kind == "op":
        return " "
    return " "


def check_idempotent(src: str) -> bool:
    once = format_source(src)
    return format_source(once) == once
