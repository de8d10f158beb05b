"""Scope-resolved semantic index for editor tooling.

Role of the reference's `SemanticIndex` (crates/compiler/semantic/src/
semantic_index.rs: scopes, definitions, identifier usages) at the
granularity the language server needs: every identifier occurrence is
resolved to its *binding* through lexical scopes — so goto-definition and
references are shadowing-correct (two `let x` in sibling blocks are
different symbols), and completion can list exactly the bindings visible
at a position.

Built from the token stream with a brace-tracked scope stack rather than
the typed AST: the index needs (line, col) for every occurrence, which the
tokens carry; layering it on tokens also keeps it total on broken sources
(an editor's steady state) where the parser would bail.

Structures:
  Binding(name, kind, line0, col0, type_text)   kinds: fn struct const
                                                param let field
  SemanticIndex.refs: {(line0, col0): binding_id} for every resolved
  identifier occurrence (definitions included)
  SemanticIndex.scopes: [(start, end, [binding_id])] for visibility
  queries (completion)
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .lexer import LexError, tokenize

KEYWORDS = [
    "fn", "let", "return", "if", "else", "while", "loop", "for", "break",
    "continue", "struct", "const", "use", "true", "false", "felt", "u32",
    "bool",
]


@dataclass
class Binding:
    id: int
    name: str
    kind: str  # fn | struct | const | param | let | field
    line0: int
    col0: int
    type_text: str = ""
    owner: str = ""  # struct name for fields


@dataclass
class SemanticIndex:
    bindings: list = field(default_factory=list)
    refs: dict = field(default_factory=dict)  # (line0, col0) -> binding id
    scopes: list = field(default_factory=list)  # (start, end, [ids])
    struct_fields: dict = field(default_factory=dict)  # name -> [Binding]

    def binding_at(self, line0: int, col0: int):
        """Binding for the identifier whose span covers (line0, col0)."""
        for (l, c), bid in self.refs.items():
            b = self.bindings[bid]
            if l == line0 and c <= col0 <= c + len(b.name):
                return b
        return None

    def references_to(self, bid: int):
        return sorted(
            [(l, c) for (l, c), r in self.refs.items() if r == bid]
        )

    def visible_at(self, line0: int, col0: int):
        """Bindings visible at a position (innermost shadowing outer)."""
        pos = (line0, col0)
        out: dict[str, Binding] = {}
        # outer scopes first (earlier start) so inner bindings shadow
        for start, end, ids in sorted(
            self.scopes, key=lambda s: s[0]
        ):
            if start <= pos and (end is None or pos <= end):
                for bid in ids:
                    b = self.bindings[bid]
                    # a local binding is visible only after its definition
                    if b.kind in ("let", "param") and (b.line0, b.col0) > pos:
                        continue
                    out[b.name] = b
        return list(out.values())


def build_index(text: str) -> SemanticIndex:
    try:
        toks = [
            t for t in tokenize(text, keep_comments=False)
            if t.kind != "eof"
        ]
    except LexError:
        return SemanticIndex()
    idx = SemanticIndex()

    def new_binding(name, kind, tok, type_text="", owner=""):
        b = Binding(
            len(idx.bindings), name, kind, tok.line - 1, tok.col - 1,
            type_text, owner,
        )
        idx.bindings.append(b)
        idx.refs[(b.line0, b.col0)] = b.id
        return b

    # ---- scope walk ----
    # scope frame: (start_pos, {name: binding_id}, ids_in_order)
    root: tuple = ((0, 0), {}, [])
    stack = [root]

    def declare(b: Binding):
        stack[-1][1][b.name] = b.id
        stack[-1][2].append(b.id)

    def resolve(name):
        for frame in reversed(stack):
            if name in frame[1]:
                return frame[1][name]
        return None

    def type_text_until(i, stop_texts):
        parts = []
        depth = 0
        while i < len(toks):
            t = toks[i]
            if depth == 0 and t.text in stop_texts:
                break
            if t.text in ("(", "[", "<"):
                depth += 1
            elif t.text in (")", "]", ">"):
                if depth == 0:
                    break
                depth -= 1
            parts.append(t.text)
            i += 1
        return "".join(
            p + (", " if p == "," else "") for p in parts
        ).replace(",, ", ", "), i

    in_struct: str | None = None
    i = 0
    n = len(toks)
    while i < n:
        t = toks[i]
        txt, kind = t.text, t.kind
        if txt == "{":
            stack.append(((t.line - 1, t.col - 1), {}, []))
            i += 1
            continue
        if txt == "}":
            if len(stack) > 1:
                start, _, ids = stack.pop()
                idx.scopes.append((start, (t.line - 1, t.col - 1), ids))
            if len(stack) == 1:
                in_struct = None
            i += 1
            continue
        if kind == "kw" and txt in ("fn", "struct", "const") and i + 1 < n:
            name_tok = toks[i + 1]
            if name_tok.kind == "ident":
                kmap = {"fn": "fn", "struct": "struct", "const": "const"}
                b = new_binding(name_tok.text, kmap[txt], name_tok)
                declare(b)
                if txt == "struct":
                    in_struct = name_tok.text
                    idx.struct_fields[in_struct] = []
                if txt == "fn":
                    # params: ident ':' type (',' ...) ')' — declared in a
                    # scope frame opened HERE so they live with the body
                    stack.append(
                        ((name_tok.line - 1, name_tok.col - 1), {}, [])
                    )
                    j = i + 2
                    if j < n and toks[j].text == "(":
                        j += 1
                        while j < n and toks[j].text != ")":
                            if (
                                toks[j].kind == "ident"
                                and j + 1 < n
                                and toks[j + 1].text == ":"
                            ):
                                ty, k = type_text_until(
                                    j + 2, {",", ")"}
                                )
                                pb = new_binding(
                                    toks[j].text, "param", toks[j], ty
                                )
                                declare(pb)
                                j = k
                                continue
                            j += 1
                        # consume past the body '{' (the body shares the
                        # param frame; matching '}' closes it)
                        depth = 0
                        while j < n:
                            if toks[j].text == "{":
                                break
                            j += 1
                        i = j + 1
                        continue
                i += 2
                continue
        if kind == "kw" and txt == "let":
            # let NAME [: ty] = ...   |   let (a, b) = ...
            j = i + 1
            names = []
            if j < n and toks[j].text == "(":
                j += 1
                while j < n and toks[j].text != ")":
                    if toks[j].kind == "ident":
                        names.append(toks[j])
                    j += 1
                j += 1
            elif j < n and toks[j].kind == "ident":
                names.append(toks[j])
                j += 1
            ty = ""
            if j < n and toks[j].text == ":":
                ty, j = type_text_until(j + 1, {"=", ";"})
            for nt in names:
                b = new_binding(nt.text, "let", nt, ty)
                declare(b)
            i = j
            continue
        if in_struct is not None and kind == "ident" and i + 1 < n and toks[i + 1].text == ":" and len(stack) == 2:
            ty, j = type_text_until(i + 2, {",", "}"})
            fb = new_binding(t.text, "field", t, ty, owner=in_struct)
            idx.struct_fields[in_struct].append(fb)
            i = j
            continue
        if kind == "ident":
            prev = toks[i - 1] if i > 0 else None
            if prev is not None and prev.text == ".":
                i += 1  # member access: field refs resolve via type info
                continue
            # struct-literal / annotation field keys `name:` are refs only
            # when they resolve; unresolved ones are skipped silently
            bid = resolve(t.text)
            if bid is not None:
                idx.refs[(t.line - 1, t.col - 1)] = bid
            i += 1
            continue
        i += 1

    # close remaining frames at EOF
    while len(stack) > 1:
        start, _, ids = stack.pop()
        idx.scopes.append((start, None, ids))
    idx.scopes.append(((0, 0), None, root[2]))
    return idx


def let_type_from_literal(text: str, b: Binding) -> str:
    """Infer `let x = StructName { .. }` annotation-free literal types."""
    lines = text.splitlines()
    if b.line0 >= len(lines):
        return ""
    s = lines[b.line0]
    import re

    m = re.search(
        re.escape(b.name) + r"\s*=\s*([A-Za-z_]\w*)\s*\{", s[b.col0:]
    )
    return m.group(1) if m else ""
