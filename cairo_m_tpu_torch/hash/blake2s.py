"""BLAKE2s-256 — host (hashlib / NumPy) and batched device (torch) paths.

Counterpart of ``cairo_m_tpu.hash.blake2s`` and of the Pallas leaf kernel
``cairo_m_tpu.hash.blake2s_pallas``.  Messages are whole little-endian
uint32 words, which is all the Merkle trees need (column values and child
digests).

Two hand-written CUDA kernels replace ``blake2s_pallas._leaf_kernel``, which
the TPU used for leaves and, level by level, for inner nodes:

- ``hash_leaves`` wraps ``csrc/blake2s_leaves.cu``: a ``(K, n)`` stack of
  words becomes ``(8, n)`` digests, written into ``out=`` where the caller
  gives one (a leaf pass writes into the first columns of a packed
  pyramid).  The TPU gate (``K <= 64``, ``n >= 1024``) is gone.
- ``merkle_pyramid`` wraps ``csrc/blake2s_pyramid.cu``: from the leaf
  digests in the first ``m`` columns of a packed ``(8, 2m - 1)`` pyramid it
  writes every level above them, down to the root, in place: each launch
  climbs nine or eleven levels in shared memory, so a tree takes at most
  three.

A tensor on the card goes through the kernels; a tensor on the CPU goes
through the plain torch versions ``hash_words`` and ``merkle_pyramid_plain``
below.  The design notes are in the CUDA sources, the times in PERF.md.

Words are int64 tensors holding values in ``[0, 2^32)``; the plain version
masks every sum to 32 bits and rotates on non-negative int64, so ``>>`` is
a logical shift.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from .. import kernels

IV = np.array(
    [
        0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
        0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
    ],
    dtype=np.uint32,
)

SIGMA = np.array(
    [
        [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
        [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
        [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
        [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
        [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
        [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
        [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
        [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
        [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
        [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
    ],
    dtype=np.int32,
)

# Parameter word 0 for unkeyed BLAKE2s-256: digest_length=32, fanout=1, depth=1
_PARAM0 = np.uint32(0x01010020)
_M32 = 0xFFFFFFFF


def hash_bytes(data: bytes) -> bytes:
    """Host one-shot BLAKE2s-256."""
    return hashlib.blake2s(data).digest()


# ---------------------------------------------------------------------------
# Plain torch path (int64 words < 2^32)
# ---------------------------------------------------------------------------


def _rotr_t(x, n: int):
    return ((x >> n) | (x << (32 - n))) & _M32


def _g_t(v, a, b, c, d, x, y):
    v[a] = (v[a] + v[b] + x) & _M32
    v[d] = _rotr_t(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr_t(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y) & _M32
    v[d] = _rotr_t(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]) & _M32
    v[b] = _rotr_t(v[b] ^ v[c], 7)


def _compress_t(h, m, t: int, last: bool):
    v = list(h) + [torch.full_like(h[0], int(iv)) for iv in IV]
    v[12] = v[12] ^ (t & _M32)
    v[13] = v[13] ^ ((t >> 32) & _M32)
    if last:
        v[14] = v[14] ^ _M32
    for s in SIGMA:
        _g_t(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g_t(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g_t(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g_t(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g_t(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g_t(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g_t(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g_t(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def hash_words(cols, n_words: int = None):
    """Batched BLAKE2s-256 of word-aligned messages (plain torch).

    ``cols``: list of equal-shape int64 tensors — element ``i`` of each forms
    message ``i``; ``n_words`` (>= len(cols), default len(cols)) zero-pads
    every message to that many words.  Returns 8 digest-word tensors."""
    k = len(cols)
    n_words = k if n_words is None else n_words
    assert 1 <= k <= n_words
    like = cols[0]
    h = [
        torch.full_like(like, int(IV[i]) ^ (int(_PARAM0) if i == 0 else 0))
        for i in range(8)
    ]
    zero = torch.zeros_like(like)
    padded = list(cols) + [zero] * (n_words - k)
    n_blocks = max(1, -(-n_words // 16))
    for blk in range(n_blocks):
        block = padded[blk * 16 : (blk + 1) * 16]
        block = block + [zero] * (16 - len(block))
        is_last = blk == n_blocks - 1
        t = 4 * n_words if is_last else (blk + 1) * 64
        h = _compress_t(h, block, t, is_last)
    return h


def _check_cuda(t: torch.Tensor, who: str):
    if t.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {t.device}")


def hash_leaves(
    stacked: torch.Tensor, n_words: int = None, out: torch.Tensor = None
) -> torch.Tensor:
    """(K, n) int64 word stack -> (8, n) int64 digest words.

    Each lane's message is its K words zero-padded to ``n_words`` (default
    K).  ``out``: an (8, n) int64 tensor or view on the stack's device whose
    rows are contiguous (any row stride), written in place and returned.
    CUDA tensors launch ``csrc/blake2s_leaves.cu``; CPU tensors take the
    plain torch version."""
    if stacked.dim() != 2 or stacked.dtype != torch.int64:
        raise ValueError(f"hash_leaves wants a 2-D int64 stack, got "
                         f"{tuple(stacked.shape)} {stacked.dtype}")
    if not stacked.is_contiguous():
        raise ValueError("hash_leaves wants a contiguous stack")
    k, n = int(stacked.shape[0]), int(stacked.shape[1])
    n_words = k if n_words is None else int(n_words)
    if not 1 <= k <= n_words:
        raise ValueError(f"hash_leaves: need 1 <= K <= n_words, got {k}, {n_words}")
    if out is None:
        out = torch.empty((8, n), dtype=torch.int64, device=stacked.device)
    elif (tuple(out.shape) != (8, n) or out.dtype != torch.int64
          or out.device != stacked.device or (n > 1 and out.stride(1) != 1)):
        raise ValueError(
            f"hash_leaves: out must be (8, {n}) int64 on {stacked.device} with "
            f"contiguous rows, got {tuple(out.shape)} {out.dtype} on "
            f"{out.device}, strides {out.stride()}")
    if stacked.device.type == "cpu":
        for row, words in zip(out, hash_words(list(stacked), n_words)):
            row.copy_(words)
        return out
    _check_cuda(stacked, "hash_leaves")
    lib = kernels.lib()
    with torch.cuda.device(stacked.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.cm_blake2s_leaves(
            stacked.data_ptr(), out.data_ptr(), n, out.stride(0), k, n_words,
            stream,
        )
    kernels.check(err, "blake2s_leaves")
    kernels.count("blake2s_leaves", (k, n_words, n))
    return out


def pyramid_log_tile(m: int) -> int:
    """Levels one launch of the pyramid kernel climbs from a level of m
    digests (a block takes 2^that adjacent children): 11 where the level is
    wide enough to fill the card with such blocks, else 9 (measured on an
    H100: PERF.md)."""
    return 11 if m >= 1 << 18 else 9


def pyramid_launches(m: int, log_tile: int = None) -> int:
    """Launches `merkle_pyramid` makes for a tree of m leaves."""
    n = 0
    while m > 1:
        m >>= min(log_tile or pyramid_log_tile(m), m.bit_length() - 1)
        n += 1
    return n


def pyramid_offset(n: int, level: int) -> int:
    """First column of ``level`` (0 = the n leaves) in a packed pyramid."""
    return 2 * n - ((2 * n) >> level)


def _pyramid_leaves(packed: torch.Tensor) -> int:
    """Check a packed (8, 2m - 1) pyramid; -> m."""
    if packed.dim() != 2 or packed.dtype != torch.int64 or packed.shape[0] != 8:
        raise ValueError(f"merkle_pyramid wants an (8, 2m - 1) int64 tensor, "
                         f"got {tuple(packed.shape)} {packed.dtype}")
    m = (int(packed.shape[1]) + 1) // 2
    if m < 1 or m & (m - 1) or packed.shape[1] != 2 * m - 1:
        raise ValueError(f"merkle_pyramid: {packed.shape[1]} columns are not "
                         f"2m - 1 for a power of two m")
    if not packed.is_contiguous():
        raise ValueError("merkle_pyramid wants a contiguous tensor")
    return m


def merkle_pyramid_plain(packed: torch.Tensor) -> torch.Tensor:
    """Plain torch version of `merkle_pyramid`: one `hash_words` per level
    over strided views of the level below, written in place."""
    m = _pyramid_leaves(packed)
    off = 0
    while m > 1:
        level = packed[:, off : off + m]
        msg = list(level[:, 0::2]) + list(level[:, 1::2])
        parents = packed[:, off + m : off + m + m // 2]
        for row, words in zip(parents, hash_words(msg)):
            row.copy_(words)
        off += m
        m //= 2
    return packed


def merkle_pyramid(packed: torch.Tensor, log_tile: int = None) -> torch.Tensor:
    """Fill a packed Merkle pyramid above its leaves, in place.

    ``packed``: (8, 2m - 1) int64, m a power of two; columns [0, m) hold the
    leaf digests (one digest a column, word i in row i).  Columns [m, 2m - 1)
    are written: the m/2 parents of the leaves, then their parents, ... ,
    the root in the last column; a parent is the BLAKE2s-256 of its left
    child's 8 words followed by its right child's.  Returns ``packed``.
    CUDA tensors launch ``csrc/blake2s_pyramid.cu`` once per ``log_tile``
    levels (9 or 11; default: `pyramid_log_tile` of the level a launch starts
    from); CPU tensors take `merkle_pyramid_plain`."""
    m = _pyramid_leaves(packed)
    if packed.device.type == "cpu":
        return merkle_pyramid_plain(packed)
    _check_cuda(packed, "merkle_pyramid")
    lib = kernels.lib()
    stride = int(packed.shape[1])
    off = 0
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        while m > 1:
            tile = log_tile or pyramid_log_tile(m)
            c = min(1 << tile, m)  # children a block takes
            err = lib.cm_blake2s_pyramid(
                packed.data_ptr(), stride, off, m, tile, stream
            )
            kernels.check(err, "blake2s_pyramid")
            kernels.count("blake2s_pyramid", (m, c.bit_length() - 1))
            off += 2 * m - 2 * m // c
            m //= c
    return packed


# ---------------------------------------------------------------------------
# Host paths
# ---------------------------------------------------------------------------


def hash_words_np(cols) -> np.ndarray:
    """Host golden path for hash_words (loops over hashlib)."""
    cols = [np.asarray(c, dtype=np.uint32) for c in cols]
    n = cols[0].shape[0] if cols[0].ndim else 1
    out = np.zeros((n, 8), dtype=np.uint32)
    stacked = np.stack([c.reshape(-1) for c in cols], axis=1)  # (n, n_words)
    for i in range(n):
        d = hashlib.blake2s(stacked[i].astype("<u4").tobytes()).digest()
        out[i] = np.frombuffer(d, dtype="<u4")
    return out


def _rotr(x, n: int):
    return (x >> np.uint32(n)) | (x << np.uint32(32 - n))


def _g_np(v, a, b, c, d, x, y):
    u32 = np.uint32
    v[a] = (v[a] + v[b] + x).astype(u32)
    v[d] = _rotr(v[d] ^ v[a], 16)
    v[c] = (v[c] + v[d]).astype(u32)
    v[b] = _rotr(v[b] ^ v[c], 12)
    v[a] = (v[a] + v[b] + y).astype(u32)
    v[d] = _rotr(v[d] ^ v[a], 8)
    v[c] = (v[c] + v[d]).astype(u32)
    v[b] = _rotr(v[b] ^ v[c], 7)


def _compress_np(h, m, t: int, last: bool):
    u32 = np.uint32
    v = list(h) + [np.full_like(h[0], iv) for iv in IV]
    v[12] = v[12] ^ u32(t & 0xFFFFFFFF)
    v[13] = v[13] ^ u32((t >> 32) & 0xFFFFFFFF)
    if last:
        v[14] = v[14] ^ u32(0xFFFFFFFF)
    for s in SIGMA:
        _g_np(v, 0, 4, 8, 12, m[s[0]], m[s[1]])
        _g_np(v, 1, 5, 9, 13, m[s[2]], m[s[3]])
        _g_np(v, 2, 6, 10, 14, m[s[4]], m[s[5]])
        _g_np(v, 3, 7, 11, 15, m[s[6]], m[s[7]])
        _g_np(v, 0, 5, 10, 15, m[s[8]], m[s[9]])
        _g_np(v, 1, 6, 11, 12, m[s[10]], m[s[11]])
        _g_np(v, 2, 7, 8, 13, m[s[12]], m[s[13]])
        _g_np(v, 3, 4, 9, 14, m[s[14]], m[s[15]])
    return [h[i] ^ v[i] ^ v[i + 8] for i in range(8)]


def hash_words_np_vec(cols) -> list:
    """NumPy twin of `hash_words`: list of equal-shape uint32 arrays ->
    list of 8 digest-word arrays (the host Merkle pyramid tops)."""
    with np.errstate(over="ignore"):
        cols = [np.asarray(c, dtype=np.uint32) for c in cols]
        n_words = len(cols)
        n_bytes = n_words * 4
        shape_like = cols[0]
        h = [
            np.full_like(
                shape_like, IV[i] ^ (_PARAM0 if i == 0 else 0), dtype=np.uint32
            )
            for i in range(8)
        ]
        zero = np.zeros_like(shape_like)
        n_blocks = max(1, -(-n_words // 16))
        for blk in range(n_blocks):
            block = cols[blk * 16 : (blk + 1) * 16]
            block = list(block) + [zero] * (16 - len(block))
            is_last = blk == n_blocks - 1
            t = n_bytes if is_last else (blk + 1) * 64
            h = _compress_np(h, block, t, is_last)
        return h
