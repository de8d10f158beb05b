"""Project model: `cairom.toml` discovery + multi-file `use` resolution.

Role of `crates/compiler/cairo-m-project` (manifest discovery -> Project
model, SURVEY.md §2.3) plus the multi-module part of `compile_project`
(`crates/compiler/src/lib.rs:141-178`):

- a project root holds `cairom.toml` ([project] name, optional entry =
  "src/main.cm") and sources under `src/`;
- `use a::b::item;` in module `m` resolves to `src/a/b.cm`'s top-level
  `item` (function, struct or const), loaded transitively;
- all reachable modules merge into one compilation (one shared address
  space/Program); duplicate top-level names across modules are a
  collision diagnostic.
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field

from . import CompilationError, CompilerOptions, CompilerOutput, compile_cairo
from .diagnostics import Diagnostic
from .parser import parse


@dataclass
class Manifest:
    name: str
    entry: str = "src/main.cm"
    version: str = "0.1.0"


@dataclass
class Project:
    root: str
    manifest: Manifest

    @property
    def entry_path(self) -> str:
        return os.path.join(self.root, self.manifest.entry)

    def module_path(self, segments) -> str:
        return os.path.join(self.root, "src", *segments) + ".cm"


def discover_project(path: str) -> Project:
    """Walk up from `path` to the nearest directory holding cairom.toml."""
    cur = os.path.abspath(path)
    if os.path.isfile(cur):
        cur = os.path.dirname(cur)
    while True:
        manifest = os.path.join(cur, "cairom.toml")
        if os.path.exists(manifest):
            return Project(cur, _load_manifest(manifest))
        parent = os.path.dirname(cur)
        if parent == cur:
            raise FileNotFoundError(f"no cairom.toml above {path}")
        cur = parent


def _load_manifest(path: str) -> Manifest:
    with open(path, "rb") as f:
        data = tomllib.load(f)
    proj = data.get("project", {})
    return Manifest(
        name=proj.get("name", os.path.basename(os.path.dirname(path))),
        entry=proj.get("entry", "src/main.cm"),
        version=str(proj.get("version", "0.1.0")),
    )


def compile_project(path: str, options: CompilerOptions = None) -> CompilerOutput:
    """Discover the project containing `path` and compile its entry module
    with all `use`-reachable modules merged."""
    project = discover_project(path)
    merged_src, file_of_line = _merge_sources(project)
    try:
        return compile_cairo(
            merged_src, name=project.manifest.name, options=options
        )
    except CompilationError as e:
        # re-home line numbers to their source files
        for d in e.diagnostics:
            if d.line and d.line in file_of_line:
                d.file_path, d.line = file_of_line[d.line]
        raise


def _merge_sources(project: Project):
    """Load the entry module and every use-reachable module; concatenate
    their sources (uses stripped) with a line map back to original files."""
    seen: dict[str, str] = {}  # abs path -> source
    order: list[str] = []

    def load(p: str, line=0, from_file=""):
        p = os.path.abspath(p)
        if p in seen:
            return
        if not os.path.exists(p):
            raise CompilationError(
                [
                    Diagnostic(
                        "error",
                        f"module file not found: {p}",
                        from_file or project.entry_path,
                        line,
                    )
                ]
            )
        src = open(p).read()
        seen[p] = src
        order.append(p)
        mod = parse(src)
        for u in mod.uses:
            if len(u.path) < 2:
                raise CompilationError(
                    [
                        Diagnostic(
                            "error",
                            f"use needs module::item, got {'::'.join(u.path)}",
                            p,
                            u.line,
                        )
                    ]
                )
            load(project.module_path(u.path[:-1]), u.line, p)

    load(project.entry_path)
    pieces = []
    file_of_line = {}
    line_no = 1
    for p in order:
        src = seen[p]
        # strip `use` lines (resolution already happened) but keep line
        # counts so diagnostics map back
        kept = []
        for k, raw in enumerate(src.splitlines()):
            kept.append("" if raw.lstrip().startswith("use ") else raw)
        for k in range(len(kept)):
            file_of_line[line_no + k] = (p, k + 1)
        pieces.append("\n".join(kept))
        line_no += len(kept) + 1
    return "\n\n".join(pieces), file_of_line


def init_project(root: str, name: str):
    """Scaffold a new project (reference cargo-cairo-m `init`,
    crates/cargo-cairo-m/src/main.rs:19-80)."""
    os.makedirs(os.path.join(root, "src"), exist_ok=True)
    manifest = os.path.join(root, "cairom.toml")
    if not os.path.exists(manifest):
        with open(manifest, "w") as f:
            f.write(
                f'[project]\nname = "{name}"\nversion = "0.1.0"\n'
                'entry = "src/main.cm"\n'
            )
    main = os.path.join(root, "src", "main.cm")
    if not os.path.exists(main):
        with open(main, "w") as f:
            f.write(
                "fn main(n: felt) -> felt {\n"
                "    let a = 0;\n    let b = 1;\n    let i = 0;\n"
                "    while i != n {\n"
                "        let t = a + b;\n        a = b;\n        b = t;\n"
                "        i = i + 1;\n    }\n    return a;\n}\n"
            )
    return Project(root, _load_manifest(manifest))
