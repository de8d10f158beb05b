"""Cairo-M lexer (reference: crates/compiler/parser lexer.rs)."""

from __future__ import annotations

from dataclasses import dataclass

KEYWORDS = {
    "fn", "let", "const", "struct", "return", "if", "else", "while", "for",
    "loop", "break", "continue", "true", "false", "as", "new", "use",
    "felt", "bool", "u32",
}

TWO_CHAR = {"==", "!=", "<=", ">=", "&&", "||", "->"}
ONE_CHAR = set("+-*/%()[]{},;:.<>=!&|^")


@dataclass(frozen=True)
class Token:
    kind: str  # ident | int | u32lit | kw | op | eof
    text: str
    line: int
    col: int


class LexError(Exception):
    pass


def tokenize(src: str, keep_comments: bool = False):
    toks = []
    i, line, col = 0, 1, 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == "\n":
            i += 1
            line += 1
            col = 1
            continue
        if c in " \t\r":
            i += 1
            col += 1
            continue
        if src.startswith("//", i):
            j = src.find("\n", i)
            j = n if j < 0 else j
            if keep_comments:
                toks.append(Token("comment", src[i:j].rstrip(), line, col))
            i = j
            continue
        if src.startswith("/*", i):
            j = src.find("*/", i)
            if j < 0:
                raise LexError(f"{line}:{col}: unterminated block comment")
            seg = src[i : j + 2]
            if keep_comments:
                toks.append(Token("comment", seg, line, col))
            line += seg.count("\n")
            i = j + 2
            continue
        start_line, start_col = line, col
        if c.isdigit():
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
                val = src[i:j]
            else:
                while j < n and src[j].isdigit():
                    j += 1
                val = src[i:j]
            if src.startswith("u32", j):
                toks.append(Token("u32lit", val, start_line, start_col))
                j += 3
            else:
                toks.append(Token("int", val, start_line, start_col))
            col += j - i
            i = j
            continue
        if c.isalpha() or c == "_":
            j = i
            while j < n and (src[j].isalnum() or src[j] == "_"):
                j += 1
            word = src[i:j]
            toks.append(
                Token("kw" if word in KEYWORDS else "ident", word, start_line, start_col)
            )
            col += j - i
            i = j
            continue
        if src[i : i + 2] in TWO_CHAR:
            toks.append(Token("op", src[i : i + 2], start_line, start_col))
            i += 2
            col += 2
            continue
        if c in ONE_CHAR:
            toks.append(Token("op", c, start_line, start_col))
            i += 1
            col += 1
            continue
        raise LexError(f"{line}:{col}: unexpected character {c!r}")
    toks.append(Token("eof", "", line, col))
    return toks
