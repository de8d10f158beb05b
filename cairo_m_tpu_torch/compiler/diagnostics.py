"""Diagnostics: accumulation + ariadne-style terminal rendering.

Role of `crates/compiler/diagnostics` (Diagnostic struct + ariadne
rendering, SURVEY.md §2.3): the compiler collects EVERY error it can recover
past instead of aborting at the first, and renders each with the offending
source line and a caret column marker.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Diagnostic:
    severity: str  # "error" | "warning"
    message: str
    file_path: str = "<input>"
    line: int = 0  # 1-based; 0 = unknown
    col: int = 0  # 1-based; 0 = unknown

    def render(self, source: str = None) -> str:
        head = f"{self.severity}: {self.message}"
        loc = f"  --> {self.file_path}:{self.line}"
        out = [head, loc]
        if source and self.line:
            lines = source.splitlines()
            if 0 < self.line <= len(lines):
                text = lines[self.line - 1]
                gutter = f"{self.line:>4} | "
                out.append(f"{'':>4} |")
                out.append(gutter + text)
                caret_at = self.col - 1 if self.col else _first_nonspace(text)
                out.append(f"{'':>4} | " + " " * caret_at + "^")
        return "\n".join(out)


def _first_nonspace(text: str) -> int:
    stripped = text.lstrip()
    return len(text) - len(stripped)


@dataclass
class DiagnosticBag:
    file_path: str = "<input>"
    source: str = ""
    items: list = field(default_factory=list)

    def error(self, line: int, message: str, col: int = 0):
        self.items.append(
            Diagnostic("error", message, self.file_path, line, col)
        )

    def warning(self, line: int, message: str, col: int = 0):
        self.items.append(
            Diagnostic("warning", message, self.file_path, line, col)
        )

    @property
    def has_errors(self) -> bool:
        return any(d.severity == "error" for d in self.items)

    def render(self) -> str:
        return "\n\n".join(d.render(self.source) for d in self.items)
