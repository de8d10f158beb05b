"""Binary trace file export/import — the cross-process handoff format.

Byte-compatible with the reference's per-segment files:

- trace files (`crates/runner/src/vm/mod.rs:306-326`,
  `crates/common/src/execution.rs:28-39`): `<base>_segment_<N><ext>`,
  a flat sequence of (fp, pc) little-endian u32 pairs, one per VM step;
- memory-trace files (`vm/mod.rs:328-373`, `execution.rs:51-66`): a u32
  program-length header, then 20-byte entries (addr, 4 QM31 limbs) in
  access order — the reader is `crates/prover/src/adapter/io.rs:38-154`.

The reference stops there: its `import_from_runner_artifacts` is
`unimplemented!` (`adapter/mod.rs:213-233`) because the access log alone
cannot reconstruct a continuation segment's initial-memory snapshot.  This
framework closes that gap with one extra file per segment (an extension,
not in the reference): `<base>_segment_<N><ext>` of 28-byte entries
(addr, 4 value limbs, clock, multiplicity) — exactly the
`Segment.initial_memory` map.  With all three files a segment round-trips
bit-exactly: VM -> files -> `segments_from_files` -> adapter -> proof
(tests/test_trace_io.py).
"""

from __future__ import annotations

import os
import struct

from ..isa.state import Segment, State


def _segment_path(path: str, index: int) -> str:
    base, ext = os.path.splitext(path)
    return f"{base}_segment_{index}{ext}"


def write_binary_trace(segments, path: str) -> list:
    """One `<base>_segment_<N><ext>` file per segment of (fp, pc) LE u32
    pairs.  Returns the written paths."""
    out = []
    for i, seg in enumerate(segments):
        p = _segment_path(path, i)
        with open(p, "wb") as f:
            f.write(seg.serialize_trace())
        out.append(p)
    return out


def write_binary_memory_trace(segments, program_length: int, path: str) -> list:
    """One file per segment: u32 program-length header + 20-byte access
    entries (addr, v0..v3)."""
    out = []
    for i, seg in enumerate(segments):
        p = _segment_path(path, i)
        with open(p, "wb") as f:
            f.write(struct.pack("<I", program_length))
            f.write(seg.serialize_memory_trace())
        out.append(p)
    return out


def write_initial_memory(segments, path: str) -> list:
    """Extension files: 28-byte entries (addr, v0..v3, clock, mult) of each
    segment's initial-memory snapshot, ascending address order."""
    out = []
    for i, seg in enumerate(segments):
        p = _segment_path(path, i)
        with open(p, "wb") as f:
            for addr in sorted(seg.initial_memory):
                v, clock, mult = seg.initial_memory[addr]
                f.write(struct.pack("<7I", addr, *v, clock, mult % (1 << 32)))
        out.append(p)
    return out


def read_trace_file(path: str) -> list:
    data = open(path, "rb").read()
    if len(data) % 8:
        raise ValueError(f"{path}: trace file length not a multiple of 8")
    states = []
    for off in range(0, len(data), 8):
        fp, pc = struct.unpack_from("<II", data, off)
        states.append(State(pc=pc, fp=fp))
    return states


def read_memory_trace_file(path: str):
    """-> (program_length, [(addr, (v0, v1, v2, v3)), ...])"""
    data = open(path, "rb").read()
    if len(data) < 4 or (len(data) - 4) % 20:
        raise ValueError(f"{path}: bad memory trace file length")
    (program_length,) = struct.unpack_from("<I", data, 0)
    entries = []
    for off in range(4, len(data), 20):
        addr, v0, v1, v2, v3 = struct.unpack_from("<5I", data, off)
        entries.append((addr, (v0, v1, v2, v3)))
    return program_length, entries


def read_initial_memory_file(path: str) -> dict:
    data = open(path, "rb").read()
    if len(data) % 28:
        raise ValueError(f"{path}: bad initial-memory file length")
    mem = {}
    for off in range(0, len(data), 28):
        addr, v0, v1, v2, v3, clock, mult = struct.unpack_from(
            "<7I", data, off
        )
        # multiplicity is signed on the Segment (stored mod 2^32)
        if mult >= 1 << 31:
            mult -= 1 << 32
        mem[addr] = ((v0, v1, v2, v3), clock, mult)
    return mem


def count_segments(path: str) -> int:
    n = 0
    while os.path.exists(_segment_path(path, n)):
        n += 1
    return n


def segments_from_files(
    trace_path: str, memory_path: str, initmem_path: str
) -> list:
    """Read all `<base>_segment_<N><ext>` triplets back into Segments."""
    n = count_segments(trace_path)
    if n == 0:
        raise FileNotFoundError(f"no segment files at {trace_path}")
    segs = []
    for i in range(n):
        trace = read_trace_file(_segment_path(trace_path, i))
        _, mem_trace = read_memory_trace_file(_segment_path(memory_path, i))
        init = read_initial_memory_file(_segment_path(initmem_path, i))
        segs.append(
            Segment(initial_memory=init, memory_trace=mem_trace, trace=trace)
        )
    return segs


def export_run(vm, program_length: int, base_dir: str, stem: str = "trace"):
    """Write all three file families for a finished VM run; returns the
    (trace, memory, initmem) base paths."""
    tp = os.path.join(base_dir, f"{stem}.bin")
    mp = os.path.join(base_dir, f"{stem}_mem.bin")
    ip = os.path.join(base_dir, f"{stem}_initmem.bin")
    write_binary_trace(vm.segments, tp)
    write_binary_memory_trace(vm.segments, program_length, mp)
    write_initial_memory(vm.segments, ip)
    return tp, mp, ip
