"""Blake2s Fiat-Shamir channel + proof-of-work grind.

Host-side and serial by design (the transcript is a sequential object; only
reductions feed it — SURVEY.md §5).  Role-equivalent of stwo's
`Blake2sChannel`/`GrindOps` (SURVEY.md §2.9).

Convention (documented; self-consistent across prover and verifier):

- state = 32-byte digest, starts all-zero;
- ``mix(data)``: digest = blake2s(digest || data), draw counter resets;
- ``draw_bytes()``: out = blake2s(digest || le64(counter)); counter += 1
  (digest unchanged between draws, as in stwo);
- felts: u32 LE words of drawn bytes, reduced mod P; a QM31 uses 4 words;
- ``trailing_zeros()``: of the digest's first 16 bytes as a LE u128;
- PoW grind: smallest nonce with
  ``blake2s(digest || le64(nonce)).trailing_zeros() >= bits``; the nonce is
  then mixed with ``mix_u64``.
"""

from __future__ import annotations

import hashlib
import struct

P = (1 << 31) - 1


class Blake2sChannel:
    __slots__ = ("digest", "counter")

    def __init__(self):
        self.digest = b"\x00" * 32
        self.counter = 0

    # -- mixing --

    def mix_bytes(self, data: bytes):
        self.digest = hashlib.blake2s(self.digest + data).digest()
        self.counter = 0

    def mix_u32s(self, values):
        self.mix_bytes(b"".join(struct.pack("<I", v & 0xFFFFFFFF) for v in values))

    def mix_u64(self, value: int):
        self.mix_bytes(struct.pack("<Q", value & 0xFFFFFFFFFFFFFFFF))

    def mix_felts(self, qm31s):
        """Mix QM31 values (sequences of 4 M31 ints)."""
        data = b"".join(
            struct.pack("<4I", *[int(l) for l in q]) for q in qm31s
        )
        self.mix_bytes(data)

    def mix_root(self, root: bytes):
        assert len(root) == 32
        self.mix_bytes(root)

    # -- drawing --

    def draw_bytes(self) -> bytes:
        out = hashlib.blake2s(self.digest + struct.pack("<Q", self.counter)).digest()
        self.counter += 1
        return out

    def draw_felt(self):
        """One QM31 as a 4-tuple of M31 ints."""
        words = struct.unpack("<8I", self.draw_bytes())
        return tuple(w % P for w in words[:4])

    def draw_felts(self, n: int):
        out = []
        while len(out) < n:
            words = struct.unpack("<8I", self.draw_bytes())
            out.append(tuple(w % P for w in words[:4]))
            if len(out) < n:
                out.append(tuple(w % P for w in words[4:]))
        return out[:n]

    def draw_queries(self, n_queries: int, log_domain_size: int) -> list[int]:
        """Distinct query positions in [0, 2^log_domain_size), sorted."""
        mask = (1 << log_domain_size) - 1
        out = set()
        while len(out) < n_queries:
            data = self.draw_bytes()
            for i in range(0, 32, 4):
                out.add(struct.unpack("<I", data[i : i + 4])[0] & mask)
                if len(out) >= n_queries:
                    break
        return sorted(out)

    # -- proof of work --

    def trailing_zeros(self) -> int:
        v = int.from_bytes(self.digest[:16], "little")
        if v == 0:
            return 128
        return (v & -v).bit_length() - 1

    def grind(self, pow_bits: int) -> int:
        digest = self.digest
        nonce = 0
        while True:
            h = hashlib.blake2s(digest + struct.pack("<Q", nonce)).digest()
            v = int.from_bytes(h[:16], "little")
            if v == 0 or ((v & -v).bit_length() - 1) >= pow_bits:
                return nonce
            nonce += 1

    def verify_pow(self, nonce: int, pow_bits: int) -> bool:
        h = hashlib.blake2s(self.digest + struct.pack("<Q", nonce)).digest()
        v = int.from_bytes(h[:16], "little")
        return v == 0 or ((v & -v).bit_length() - 1) >= pow_bits
