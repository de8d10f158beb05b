"""mdtest: markdown-driven language conformance tests.

Each ```cairo-m fenced code block in a markdown file becomes one test case,
named from the enclosing headings.  Annotation comments at the top of a
block configure it:

    //! ignore: reason          skip the test
    //! expected: value         expected return of main() (abi-codec grammar)
    //! error: "substring"      compilation or execution must fail with this
    //! tags: [a, b]            free-form categorization
    //! args: 1 2 (3, 4)        entrypoint arguments (abi-codec grammar)
    //! entrypoint: name        entrypoint to run (default "main")

A ```toml block before the first test sets file-wide config ([mdtest]
max-steps, [compiler] optimization-level).  Blocks in other languages
(e.g. ```rust differential equivalents) are attached to the preceding
cairo-m test but not executed here.

Reference behavior modeled on crates/test_utils/src/mdtest/{parser,config,
runner}.rs and mdtest/README.md of kkrt-labs/cairo-m; re-implemented
line-based (no markdown library needed for fenced blocks + headings).
"""

from __future__ import annotations

import re
import tomllib
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class MdTestConfig:
    max_steps: int = 1_000_000
    # 0 = none, >=1 = standard pipeline; the reference serde default is 0
    # (crates/test_utils/src/mdtest/config.rs)
    optimization_level: int = 0


@dataclass
class MdTest:
    name: str
    cairo_source: str
    path: str
    line: int
    expected: str | None = None
    error: str | None = None
    ignore: str | None = None
    tags: list = field(default_factory=list)
    args: str | None = None
    entrypoint: str = "main"
    rust_source: str | None = None
    config: MdTestConfig = field(default_factory=MdTestConfig)


_ANNOT = re.compile(r"^//!\s*([a-z-]+):\s*(.*)$")


def _slug(s: str) -> str:
    return re.sub(r"[^a-z0-9]+", "_", s.lower()).strip("_") or "test"


def _parse_annotations(test: MdTest) -> str:
    """Strip //! annotation lines anywhere in the source (reference parser
    behavior, crates/test_utils/src/mdtest/parser.rs), filling test fields;
    returns the body."""
    body = []
    for ln in test.cairo_source.splitlines():
        m = _ANNOT.match(ln.strip())
        if m:
            key, val = m.group(1), m.group(2).strip()
            if key == "expected":
                test.expected = val
            elif key == "error":
                test.error = val.strip('"')
            elif key == "ignore":
                test.ignore = val or "ignored"
            elif key == "tags":
                test.tags = [t.strip() for t in val.strip("[]").split(",")]
            elif key == "args":
                test.args = val
            elif key == "entrypoint":
                test.entrypoint = val
            # unknown keys tolerated (forward compat)
        else:
            body.append(ln)
    return "\n".join(body)


def _config_from_toml(text: str) -> MdTestConfig:
    try:
        data = tomllib.loads(text)
    except tomllib.TOMLDecodeError:
        return MdTestConfig()
    cfg = MdTestConfig()
    md = data.get("mdtest", {})
    if "max-steps" in md:
        cfg.max_steps = int(md["max-steps"])
    comp = data.get("compiler", {})
    if "optimization-level" in comp:
        cfg.optimization_level = int(comp["optimization-level"])
    return cfg


def extract_tests(markdown_path) -> list[MdTest]:
    path = Path(markdown_path)
    lines = path.read_text().splitlines()
    tests: list[MdTest] = []
    headings = {1: "", 2: "", 3: ""}
    counts: dict[str, int] = {}
    cfg = MdTestConfig()

    i = 0
    while i < len(lines):
        ln = lines[i]
        hm = re.match(r"^(#{1,3})\s+(.*)$", ln)
        if hm:
            level = len(hm.group(1))
            headings[level] = hm.group(2).strip()
            for deeper in range(level + 1, 4):
                headings[deeper] = ""
            i += 1
            continue
        fm = re.match(r"^```([A-Za-z0-9_-]*)\s*$", ln)
        if fm:
            lang = fm.group(1).lower()
            start = i + 1
            j = start
            while j < len(lines) and not lines[j].startswith("```"):
                j += 1
            block = "\n".join(lines[start:j])
            if lang == "toml":
                cfg = _config_from_toml(block)
            elif lang == "cairo-m":
                section = headings[3] or headings[2] or headings[1] or path.stem
                counts[section] = counts.get(section, 0) + 1
                name = _slug(section)
                if counts[section] > 1:
                    name = f"{name}_{counts[section]}"
                t = MdTest(
                    name=name,
                    cairo_source=block,
                    path=str(path),
                    line=start + 1,
                    config=cfg,
                )
                t.cairo_source = _parse_annotations(t)
                tests.append(t)
            elif lang == "rust" and tests:
                tests[-1].rust_source = block
            i = j + 1
            continue
        i += 1
    return tests


def discover(root) -> list[MdTest]:
    """All tests under a directory tree, sorted by path."""
    out = []
    for md in sorted(Path(root).rglob("*.md")):
        out.append((md, extract_tests(md)))
    return [t for _, ts in out for t in ts]


class MdTestFailure(AssertionError):
    pass


def _expected_to_py(val):
    """abi-codec InputValue -> plain python for comparison."""
    if val.kind == "number":
        return val.value
    if val.kind == "bool":
        return bool(val.value)
    if val.kind in ("list", "struct"):
        return [_expected_to_py(v) for v in val.value]
    return None


def run_md_test(test: MdTest):
    """Compile + run one test; raises MdTestFailure on mismatch.

    Returns the list of flattened return values on success (None for
    ignored tests)."""
    from ..compiler import CompilerOptions, compile_cairo
    from ..isa.abi_codec import parse_arg
    from ..vm.runner import RunnerOptions, run_cairo_program

    if test.ignore is not None:
        return None

    def fail(msg):
        raise MdTestFailure(f"{test.path}:{test.line} [{test.name}] {msg}")

    try:
        opt = "none" if test.config.optimization_level == 0 else "standard"
        out = compile_cairo(
            test.cairo_source,
            Path(test.path).stem,
            CompilerOptions(optimization_level=opt),
        )
        program = out.program
        args = (
            [parse_arg(a) for a in _split_args(test.args)]
            if test.args
            else []
        )
        result = run_cairo_program(
            program,
            test.entrypoint,
            args,
            RunnerOptions(max_steps=test.config.max_steps),
        )
    except Exception as e:  # noqa: BLE001 - error-matching harness
        if test.error is not None:
            if test.error in str(e):
                return None
            fail(f"error {e!r} does not contain expected {test.error!r}")
        raise
    if test.error is not None:
        fail(f"expected error containing {test.error!r}, but run succeeded")

    flat = [v.flatten() for v in result.return_values]
    if test.expected is not None:
        want = _expected_to_py(parse_arg(test.expected))
        got = flat[0] if len(flat) == 1 else flat
        # single tuple return: compare as list
        if got != want:
            fail(f"expected {want!r}, got {got!r}")
    return flat


def _split_args(text: str) -> list[str]:
    """Split an args annotation on top-level whitespace."""
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in "([{":
            depth += 1
        elif ch in ")]}":
            depth -= 1
        if ch.isspace() and depth == 0:
            if cur:
                parts.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        parts.append("".join(cur))
    return parts
