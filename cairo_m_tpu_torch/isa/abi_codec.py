"""ABI value codec (reference `crates/common/src/abi_codec.rs`).

``InputValue`` is the untyped CLI-side value; ``CairoMValue`` the typed
decoded output.  The CLI argument grammar accepts numbers, ``true/false``,
tuples/lists ``(a, b, c)`` / ``[a, b]``, and positional structs ``{a, b}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

P = (1 << 31) - 1


@dataclass(frozen=True)
class InputValue:
    kind: str  # number | bool | list | struct | unit
    value: Any = None

    @staticmethod
    def number(n: int):
        return InputValue("number", int(n))

    @staticmethod
    def boolean(b: bool):
        return InputValue("bool", bool(b))

    @staticmethod
    def list_(vals):
        return InputValue("list", tuple(vals))

    @staticmethod
    def struct(vals):
        return InputValue("struct", tuple(vals))

    @staticmethod
    def unit():
        return InputValue("unit")


@dataclass(frozen=True)
class CairoMValue:
    kind: str  # felt | bool | u32 | pointer | tuple | struct | array | unit
    value: Any = None

    def flatten(self):
        """Python-friendly view: ints for scalars, lists for aggregates."""
        k = self.kind
        if k in ("felt", "u32", "pointer"):
            return self.value
        if k == "bool":
            return bool(self.value)
        if k in ("tuple", "array"):
            return [v.flatten() for v in self.value]
        if k == "struct":
            return {n: v.flatten() for n, v in self.value}
        return None


def m31_from_i64(n: int) -> int:
    return n % P


class AbiCodecError(Exception):
    pass


def parse_arg(text: str) -> InputValue:
    """Parse one CLI argument string into an InputValue."""
    val, rest = _parse_value(text.strip())
    if rest.strip():
        raise AbiCodecError(f"Trailing input: {rest!r}")
    return val


def _parse_value(s: str):
    s = s.lstrip()
    if not s:
        raise AbiCodecError("Empty value")
    if s.startswith("("):
        vals, rest = _parse_seq(s[1:], ")")
        return InputValue.list_(vals), rest
    if s.startswith("["):
        vals, rest = _parse_seq(s[1:], "]")
        return InputValue.list_(vals), rest
    if s.startswith("{"):
        vals, rest = _parse_seq(s[1:], "}")
        return InputValue.struct(vals), rest
    if s.startswith("true"):
        return InputValue.boolean(True), s[4:]
    if s.startswith("false"):
        return InputValue.boolean(False), s[5:]
    i = 0
    if s[0] in "+-":
        i = 1
    start = i
    if s[i:].startswith("0x") or s[i:].startswith("0X"):
        i += 2
        while i < len(s) and s[i] in "0123456789abcdefABCDEF":
            i += 1
        return InputValue.number(int(s[:i], 16)), s[i:]
    while i < len(s) and s[i].isdigit():
        i += 1
    if i == start:
        raise AbiCodecError(f"Cannot parse value: {s!r}")
    return InputValue.number(int(s[:i])), s[i:]


def _parse_seq(s: str, close: str):
    vals = []
    while True:
        s = s.lstrip()
        if s.startswith(close):
            return vals, s[1:]
        v, s = _parse_value(s)
        vals.append(v)
        s = s.lstrip()
        if s.startswith(","):
            s = s[1:]
        elif not s.startswith(close):
            raise AbiCodecError(f"Expected ',' or '{close}' at {s!r}")
