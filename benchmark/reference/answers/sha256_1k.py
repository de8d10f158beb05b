"""What a proof of `bench1k_seeded(s)` states: s in its input (a u32, as
its low and high 16-bit limbs), and in its output the SHA-256 digest
(hashlib) of the 1 KiB message whose word j of block i is s + 16i + j mod
2^32, big endian: eight u32 words, each as two limbs."""

import hashlib
import struct


def _limbs(w: int):
    return [w & 0xFFFF, w >> 16]


def input_slots(args):
    return _limbs(int(args[0]))


def output_slots(args):
    s = int(args[0])
    msg = b"".join(struct.pack(">I", (s + 16 * i + j) & 0xFFFFFFFF)
                   for i in range(16) for j in range(16))
    words = struct.unpack(">8I", hashlib.sha256(msg).digest())
    return [x for w in words for x in _limbs(w)]
