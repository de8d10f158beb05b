"""Stwo-framing BLAKE2s Fiat-Shamir channel.

Byte-for-byte reimplementation of stwo's ``Blake2sChannel`` framing
(reference import surface SURVEY.md §2.9: ``core::channel::Blake2sChannel``;
the framework's default channel in `channel.py` uses its own framing —
PROTOCOL.md §2.3).  Selected by ``PcsConfig(framing="stwo")``.

Stwo conventions implemented here:

- state = 32-byte digest (zeros) + ``n_sent`` draw counter;
- ``mix``: digest = blake2s(digest ‖ payload); the draw counter resets
  (stwo ``ChannelTime::inc_challenges``);
- ``mix_u64(v)``: payload = le32(lo) ‖ le32(hi)  (two u32 words, low first);
- ``mix_felts``: payload = 4 le32 M31 words per QM31;
- ``mix_root``: payload = the 32 root bytes (stwo
  ``Blake2sMerkleChannel::mix_root`` = ``concat_and_hash(digest, root)``);
- ``draw_random_bytes()``: blake2s(digest ‖ le-counter zero-padded to 32
  bytes); counter += 1 (digest unchanged between draws);
- ``draw_base_felts``: one 32-byte draw -> 8 u32 words; the whole batch is
  REJECTED unless every word < 2·(2^31−1), then each reduces mod P (stwo's
  uniformity rejection — the framework channel reduces unconditionally);
- ``draw_felt``: first 4 of a fresh 8-felt batch (rest discarded, as stwo);
- ``draw_felts(n)``: consecutive batches, all 8 felts consumed, chunked
  into QM31 4-tuples;
- queries: le32 words of successive 32-byte draws, masked to the domain,
  deduplicated until n_queries positions (stwo ``Queries::generate``);
- PoW: nonce such that mixing le64(nonce) leaves a digest whose first 16
  bytes (LE u128) have >= ``bits`` trailing zeros (stwo ``GrindOps`` mixes
  the nonce and tests the *resulting* digest — the framework channel hashes
  digest ‖ nonce without mixing).  ``verify_pow`` here is non-mutating
  (probe on a copy); callers mix the nonce afterwards exactly as with the
  default channel, so both channels share one call protocol.
"""

from __future__ import annotations

import hashlib
import struct

P = (1 << 31) - 1
_TWO_P = 2 * P


class StwoBlake2sChannel:
    __slots__ = ("digest", "n_sent")

    def __init__(self):
        self.digest = b"\x00" * 32
        self.n_sent = 0

    # -- mixing --

    def mix_bytes(self, data: bytes):
        self.digest = hashlib.blake2s(self.digest + data).digest()
        self.n_sent = 0

    def mix_u32s(self, values):
        self.mix_bytes(
            b"".join(struct.pack("<I", v & 0xFFFFFFFF) for v in values)
        )

    def mix_u64(self, value: int):
        value &= 0xFFFFFFFFFFFFFFFF
        self.mix_u32s([value & 0xFFFFFFFF, value >> 32])

    def mix_felts(self, qm31s):
        self.mix_bytes(
            b"".join(
                struct.pack("<4I", *[int(l) for l in q]) for q in qm31s
            )
        )

    def mix_root(self, root: bytes):
        assert len(root) == 32
        self.mix_bytes(root)

    # -- drawing --

    def draw_bytes(self) -> bytes:
        counter = struct.pack("<Q", self.n_sent) + b"\x00" * 24
        out = hashlib.blake2s(self.digest + counter).digest()
        self.n_sent += 1
        return out

    def _draw_base_felts(self):
        """8 M31 felts; rejection-samples whole 8-word batches (stwo)."""
        while True:
            words = struct.unpack("<8I", self.draw_bytes())
            if all(w < _TWO_P for w in words):
                return [w % P for w in words]

    def draw_felt(self):
        return tuple(self._draw_base_felts()[:4])

    def draw_felts(self, n: int):
        out = []
        buf = []
        while len(out) < n:
            buf.extend(self._draw_base_felts())
            while len(buf) >= 4 and len(out) < n:
                out.append(tuple(buf[:4]))
                buf = buf[4:]
        return out

    def draw_queries(self, n_queries: int, log_domain_size: int) -> list[int]:
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

    def _mixed_tz(self, nonce: int) -> int:
        payload = struct.pack("<2I", nonce & 0xFFFFFFFF, (nonce >> 32) & 0xFFFFFFFF)
        h = hashlib.blake2s(self.digest + payload).digest()
        v = int.from_bytes(h[:16], "little")
        return 128 if v == 0 else (v & -v).bit_length() - 1

    def grind(self, pow_bits: int) -> int:
        nonce = 0
        while True:
            if self._mixed_tz(nonce) >= pow_bits:
                return nonce
            nonce += 1

    def verify_pow(self, nonce: int, pow_bits: int) -> bool:
        return self._mixed_tz(nonce) >= pow_bits
