"""VM memory: flat 2^28-cell QM31 address space with access logging.

Mirrors the reference model (`crates/runner/src/memory/mod.rs`):

- ``locals`` grows up from address 0 (program at 0, then stack frames);
- ``heap`` grows down from ``MAX_ADDRESS = 2^28 - 1`` (``heap[i]`` is address
  ``MAX_ADDRESS - i``);
- every *traced* read and write appends ``(addr, qm31)`` to the access log —
  reads log too, because the AIR memory argument is read-write clock-based;
- felt reads project QM31 -> M31 and fail on non-zero extension limbs;
- u32 values are two 16-bit limbs at ``addr`` and ``addr + 1``.

Values are 4-tuples of Python ints (QM31 limbs).  The access log is kept as
two parallel lists (addrs, values) for cheap NumPy export to the adapter.
"""

from __future__ import annotations

P = (1 << 31) - 1
MAX_MEMORY_SIZE_BITS = 28
MAX_ADDRESS = (1 << MAX_MEMORY_SIZE_BITS) - 1
U32_LIMB_BITS = 16
U32_LIMB_MASK = (1 << U32_LIMB_BITS) - 1

ZERO = (0, 0, 0, 0)


class MemoryError(Exception):
    pass


class Memory:
    __slots__ = ("locals", "heap", "trace_addrs", "trace_values")

    def __init__(self, program_words=()):
        self.locals: list = [tuple(w) for w in program_words]
        self.heap: list = []
        self.trace_addrs: list = []
        self.trace_values: list = []

    # -- raw cell access --

    def _get_qm31(self, addr: int):
        if addr > MAX_ADDRESS:
            raise MemoryError(f"Address {addr} out of bounds")
        if addr < len(self.locals):
            return self.locals[addr]
        h = MAX_ADDRESS - addr
        if h < len(self.heap):
            return self.heap[h]
        return ZERO

    def _felt(self, addr: int, v):
        if v[1] or v[2] or v[3]:
            raise MemoryError(f"Value at {addr} not a base-field element: {v}")
        return v[0]

    # -- traced ops (the adapter contract) --

    def get_data(self, addr: int) -> int:
        v = self._get_qm31(addr)
        f = self._felt(addr, v)
        self.trace_addrs.append(addr)
        self.trace_values.append(v)
        return f

    def get_data_no_trace(self, addr: int) -> int:
        return self._felt(addr, self._get_qm31(addr))

    def insert(self, addr: int, value):
        self.insert_no_trace(addr, value)
        self.trace_addrs.append(addr)
        self.trace_values.append(tuple(value))

    def insert_no_trace(self, addr: int, value):
        if addr > MAX_ADDRESS:
            raise MemoryError(f"Address {addr} out of bounds")
        value = tuple(value)
        la = addr
        ha = MAX_ADDRESS - addr
        locals_, heap = self.locals, self.heap
        if la < len(locals_):
            locals_[la] = value
            return
        if ha < len(heap):
            heap[ha] = value
            return
        if la - len(locals_) < ha - len(heap):
            locals_.extend([ZERO] * (la + 1 - len(locals_)))
            locals_[la] = value
        else:
            heap.extend([ZERO] * (ha + 1 - len(heap)))
            heap[ha] = value

    def get_u32(self, addr: int) -> int:
        lo = self.get_data(addr)
        hi = self.get_data((addr + 1) % P)
        if lo > U32_LIMB_MASK or hi > U32_LIMB_MASK:
            raise MemoryError(f"U32 limbs out of range: lo={lo} hi={hi}")
        return (hi << U32_LIMB_BITS) | lo

    def get_u32_no_trace(self, addr: int) -> int:
        lo = self.get_data_no_trace(addr)
        hi = self.get_data_no_trace((addr + 1) % P)
        if lo > U32_LIMB_MASK or hi > U32_LIMB_MASK:
            raise MemoryError(f"U32 limbs out of range: lo={lo} hi={hi}")
        return (hi << U32_LIMB_BITS) | lo

    def insert_u32(self, addr: int, value: int):
        self.insert(addr, (value & U32_LIMB_MASK, 0, 0, 0))
        self.insert((addr + 1) % P, ((value >> U32_LIMB_BITS) & U32_LIMB_MASK, 0, 0, 0))

    def insert_entrypoint_call(self, final_pc: int, fp: int):
        """[fp-2] = fp, [fp-1] = final_pc, untraced (memory/mod.rs:304-324)."""
        if fp - 1 >= len(self.locals):
            self.locals.extend([ZERO] * (fp - len(self.locals)))
        self.locals[fp - 2] = (fp, 0, 0, 0)
        self.locals[fp - 1] = (final_pc, 0, 0, 0)
