"""Wadler-style document IR and renderer for the source formatter.

Role of the reference's `crates/compiler/formatter/src/doc.rs`: a small
algebra of layout documents — text, hard/soft line breaks, groups that
render flat when they fit in the remaining width, and relative indents —
with a width-aware renderer.  `formatter.py` builds one document per
logical source line (so comments keep their token-stream attachment) and
renders it at the configured width.

Constructors:
  text(s)           literal text
  hardline()        always breaks
  line()            space when flat, newline when broken
  softline()        nothing when flat, newline when broken
  group(d)          render d flat iff it fits in the remaining width
  indent(n, d)      add n spaces after every break inside d
  concat([d...])    sequence
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Doc:
    kind: str  # text | hardline | line | softline | group | indent | concat
    text: str = ""
    n: int = 0
    children: tuple = ()


def text(s: str) -> Doc:
    return Doc("text", text=s)


def hardline() -> Doc:
    return Doc("hardline")


def line() -> Doc:
    return Doc("line")


def softline() -> Doc:
    return Doc("softline")


def group(d: Doc) -> Doc:
    return Doc("group", children=(d,))


def indent(n: int, d: Doc) -> Doc:
    return Doc("indent", n=n, children=(d,))


def concat(ds) -> Doc:
    return Doc("concat", children=tuple(ds))


NIL = Doc("concat")


def _fits(width: int, items) -> bool:
    """Can the items (already-flattened work list of (doc, flat) entries)
    render on the current line within ``width`` columns?"""
    stack = list(reversed(items))
    while stack:
        if width < 0:
            return False
        d = stack.pop()
        k = d.kind
        if k == "text":
            width -= len(d.text)
        elif k == "hardline":
            return True  # fits up to the forced break
        elif k == "line":
            width -= 1
        elif k == "softline":
            pass
        elif k in ("group", "indent", "concat"):
            stack.extend(reversed(d.children))
    return width >= 0


def render(doc: Doc, max_width: int = 100) -> str:
    """Render the document.  Breaks are emitted as '\n' + (indent spaces);
    trailing whitespace never survives a break."""
    out: list[str] = []
    pos = 0
    # work list of (doc, indent, flat)
    stack = [(doc, 0, False)]
    while stack:
        d, ind, flat = stack.pop()
        k = d.kind
        if k == "text":
            out.append(d.text)
            pos += len(d.text)
        elif k == "hardline" or (
            k in ("line", "softline") and not flat
        ):
            # strip trailing spaces on the finished line
            while out and out[-1].endswith(" "):
                s = out[-1].rstrip(" ")
                if s:
                    out[-1] = s
                    break
                out.pop()
            out.append("\n" + " " * ind)
            pos = ind
        elif k == "line":
            out.append(" ")
            pos += 1
        elif k == "softline":
            pass
        elif k == "group":
            inner = d.children[0]
            f = flat or _fits(max_width - pos, [inner])
            stack.append((inner, ind, f))
        elif k == "indent":
            stack.append((d.children[0], ind + d.n, flat))
        elif k == "concat":
            for c in reversed(d.children):
                stack.append((c, ind, flat))
    return "".join(out)
