"""WASM frontend: WebAssembly binary -> Cairo-M MIR -> CASM Program.

Role of `crates/wasm` (womir BlocklessDAG -> Cairo-M MIR lowering,
SURVEY.md §2.8), built directly on this repo's compiler stack: the binary
loader below parses the MVP sections needed for compute kernels, and
`lower.py` turns each function's structured instruction stream into the
compiler's SSA MIR (wasm i32 maps to the native u32 type), which then runs
the standard pass pipeline and MIR code generator.

Supported subset (enough for loop/arith kernels; extend as needed):
  - types: i32 params/results (single result)
  - sections: type, function, memory, export, code, data
  - ops: i32.const, i32.{add,sub,mul,div_u,rem_u,and,or,xor},
    i32.{eq,ne,lt_u,gt_u,le_u,ge_u,eqz}, i32.{load,store},
    local.{get,set,tee}, block/loop/if/else/end, br, br_if, return, call,
    drop, nop, select

Linear memory (reference `crates/wasm/src/lowering/mod.rs` lowers womir
memory ops; here mapped Cairo-M-natively): wasm memory 0 lives at the TOP
of the Cairo-M heap segment — u32 word ``i`` occupies the two cells at
``MAX_ADDRESS - mem_cells + 1 + 2*i`` (a u32 is two 16-bit-limb cells).
``i32.load/store`` must be 4-byte aligned (the compute-kernel subset);
active data segments with i32.const offsets are materialized by a
synthesized per-export init wrapper; untouched cells read as wasm zero
pages (Cairo-M memory defaults to 0).
"""

from __future__ import annotations

from dataclasses import dataclass, field


class WasmError(Exception):
    pass


@dataclass
class FuncType:
    params: list  # of "i32"
    results: list


@dataclass
class WasmFunc:
    type_idx: int
    locals: list  # of "i32" (beyond params)
    body: bytes


@dataclass
class WasmModule:
    types: list = field(default_factory=list)
    func_type_idx: list = field(default_factory=list)
    exports: dict = field(default_factory=dict)  # name -> func index
    funcs: list = field(default_factory=list)  # of WasmFunc
    mem_min_pages: int = 0  # memory section limits.min (64 KiB pages)
    data_segments: list = field(default_factory=list)  # (byte offset, bytes)


class _Reader:
    def __init__(self, data: bytes, pos=0):
        self.d = data
        self.i = pos

    def u8(self) -> int:
        b = self.d[self.i]
        self.i += 1
        return b

    def bytes(self, n) -> bytes:
        out = self.d[self.i : self.i + n]
        self.i += n
        return out

    def uleb(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def sleb(self) -> int:
        out = shift = 0
        while True:
            b = self.u8()
            out |= (b & 0x7F) << shift
            shift += 7
            if not b & 0x80:
                if b & 0x40:
                    out -= 1 << shift
                return out

    def name(self) -> str:
        return self.bytes(self.uleb()).decode()

    @property
    def eof(self):
        return self.i >= len(self.d)


_VALTYPE = {0x7F: "i32", 0x7E: "i64", 0x7D: "f32", 0x7C: "f64"}


def load_wasm(data: bytes) -> WasmModule:
    r = _Reader(data)
    if r.bytes(4) != b"\x00asm":
        raise WasmError("not a wasm binary (bad magic)")
    if r.bytes(4) != b"\x01\x00\x00\x00":
        raise WasmError("unsupported wasm version")
    mod = WasmModule()
    bodies = []
    while not r.eof:
        sec = r.u8()
        size = r.uleb()
        body = _Reader(r.bytes(size))
        if sec == 1:  # types
            for _ in range(body.uleb()):
                if body.u8() != 0x60:
                    raise WasmError("bad functype")
                params = [_vt(body) for _ in range(body.uleb())]
                results = [_vt(body) for _ in range(body.uleb())]
                mod.types.append(FuncType(params, results))
        elif sec == 3:  # functions
            mod.func_type_idx = [body.uleb() for _ in range(body.uleb())]
        elif sec == 7:  # exports
            for _ in range(body.uleb()):
                name = body.name()
                kind = body.u8()
                idx = body.uleb()
                if kind == 0:
                    mod.exports[name] = idx
        elif sec == 5:  # memory
            count = body.uleb()
            if count > 1:
                raise WasmError("at most one linear memory supported")
            if count:
                flags = body.u8()
                mn = body.uleb()
                if flags & 0x01:
                    body.uleb()  # max pages (ignored; static min allocation)
                mod.mem_min_pages = mn
        elif sec == 10:  # code
            for _ in range(body.uleb()):
                n = body.uleb()
                fr = _Reader(body.bytes(n))
                locs = []
                for _ in range(fr.uleb()):
                    count = fr.uleb()
                    vt = _vt(fr)
                    locs += [vt] * count
                bodies.append((locs, fr.d[fr.i :]))
        elif sec == 11:  # data
            for _ in range(body.uleb()):
                flags = body.uleb()
                if flags not in (0, 2):
                    raise WasmError("passive data segments unsupported")
                if flags == 2 and body.uleb() != 0:
                    raise WasmError("data segment memidx must be 0")
                if body.u8() != 0x41:  # offset expr: i32.const N; end
                    raise WasmError("data offset must be an i32.const expr")
                off = body.sleb()
                if body.u8() != 0x0B:
                    raise WasmError("data offset expr must be a single const")
                mod.data_segments.append((off, body.bytes(body.uleb())))
        # other sections (imports, globals, ...) are skipped; compute-kernel
        # modules in the supported subset don't carry them
    for (ti, (locs, code)) in zip(mod.func_type_idx, bodies):
        mod.funcs.append(WasmFunc(ti, locs, code))
    return mod


def _vt(r: _Reader) -> str:
    t = _VALTYPE.get(r.u8())
    if t != "i32":
        raise WasmError(f"unsupported value type {t} (i32-only subset)")
    return t


def compile_wasm(data: bytes, options=None):
    """WASM binary -> CompilerOutput (Program with one entrypoint per
    exported function)."""
    from .lower import lower_module

    return lower_module(load_wasm(data), options)
