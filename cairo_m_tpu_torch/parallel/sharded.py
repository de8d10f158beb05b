"""Row sharding of the prover across torch.distributed ranks.

Counterpart of ``cairo_m_tpu.parallel.sharded``.  The reference places
every stack with its domain (trailing) axis sharded over a device mesh and
lets XLA GSPMD insert the collectives.  Torch has no GSPMD: here each rank
is one process that runs ``prove_cairo_m`` under ``prover_mesh(mesh)`` on
its own share, every rank runs the same host transcript, and each step that
crosses shards calls one of the exchange primitives below.  The proof is
byte-identical to the single-device proof (all arithmetic is exact), and
every rank ends with it.

Layout, one for the whole prover.  With D ranks (a power of two) and a
domain of n = 2^L points:

- **evaluations** are held in FFT order, *cyclically*: rank r holds the FFT
  indices i = m*D + r, local index m.  Circle-FFT levels that pair
  elements at a distance >= D are rank-local (strided twiddles).  The bit
  reversal to commit order is a local bit reversal of m, and rank r's
  elements form the contiguous commit-order block ``bitrev_d(r)``, so Merkle
  subtrees, quotients and the natural-order FRI folds (pairs (u, u + n/2))
  are rank-local;
- **coefficients** are held in *blocks*: rank r holds indices
  [r*n/D, (r+1)*n/D).  The transform levels at a distance < D run in this
  layout, one all-to-all away from the cyclic one, and embedding into a
  bigger basis (index << gap) is rank-local;
- a stack whose n is not a multiple of D^2 is held whole by every rank
  and computed redundantly (`shards`): test scale has components of 16
  rows, whole at world size 8.  FRI layers stay on the device down to 2^12
  points, so a mesh holds at most 64 ranks (64^2 = 2^12) and every layer
  there splits.

Whether a tensor is this rank's share of a domain axis or the whole axis
is decided in one place, `is_share`, which every mesh-aware stage of the
prover asks (directly or through `share_of`, `whole` and `whole_commit`);
it also rejects an axis of any other length, with a mesh or without.

The cross-shard steps and their primitives: the cyclic <-> block transposes
of each transform (`cyclic_to_block`, `block_to_cyclic`); the wide-tape
bank gather of a row shift and the row-order LogUp prefix sums
(`shift_rows`, `row_cumsum_mod`, both routed all-to-alls, `gather_lanes`);
the LogUp totals and the OODS partial sums (`psum_mod`); the exclusive
scan of the ranks' prefix totals (`exclusive_scan_mod`); the Merkle subtree
tops, the stwo commit stacks and the FRI layers that leave the device
(`all_gather`, `gather_cyclic`, `gather_commit`); the table multiplicities
(`psum`); and the query openings, each read from the rank that owns it
(`psum` of vectors with one owner per entry).

Values cross as int32: every field value is below 2^31 and a digest word
keeps its 32 bits, half the bytes of the int64 carrier.  Under gloo a
device tensor goes through host memory for the collective and back
(`_staged`, the one place that does it, and which refuses a tensor off
the mesh's device under either backend); NCCL takes device tensors and
needs one card per rank (`rank_devices`), each rank's card current before
it joins the group (`make_row_mesh`).  Outside ``prover_mesh`` every
primitive here is unused and `maybe_shard` is a no-op: the single-device
prover keeps its own code path.

The rank entry is ``python -m cairo_m_tpu_torch.parallel.sharded`` and the
launcher `prove_sharded`: every rank re-runs the deterministic compile,
native VM and adapter (as the segment workers do), proves under the mesh,
and the launcher checks that all ranks' proofs are byte-equal.
"""

from __future__ import annotations

import json
import os
import resource
import subprocess
import sys
import tempfile
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np
import torch
import torch.distributed as dist

P = (1 << 31) - 1
_M32 = 0xFFFFFFFF
# FRI layers of 2^12 points and more stay on the device (fri._FRI_HOST_LOG
# is 11), and D^2 must divide every one of them
MAX_WORLD_SIZE = 64


@dataclass
class RowMesh:
    """One rank's view of the row mesh: the process group, this rank, the
    world size (a power of two), the rank's device and the backend; and
    the exchange counters (bytes this rank sent to other ranks, seconds
    spent in exchanges, number of exchanges).  Under NCCL an exchange's
    seconds are read from CUDA events when `stats` is called, so the card
    is never synchronised to count them."""

    group: object
    rank: int
    world_size: int
    device: torch.device
    backend: str
    bytes_sent: int = 0
    exchange_s: float = 0.0
    n_exchanges: int = 0
    # (start, end) CUDA events of the NCCL exchanges not yet read
    events: list = field(default_factory=list)

    @property
    def log_ws(self) -> int:
        return self.world_size.bit_length() - 1

    def key(self):
        """What a cached sharded value depends on."""
        return (self.world_size, self.rank, self.backend)

    def reset_stats(self):
        self.bytes_sent, self.exchange_s, self.n_exchanges = 0, 0.0, 0
        self.events.clear()

    def stats(self) -> dict:
        if self.events:
            self.events[-1][1].synchronize()
            self.exchange_s += sum(a.elapsed_time(b) for a, b in self.events) / 1e3
            self.events.clear()
        return {"bytes": self.bytes_sent, "seconds": self.exchange_s,
                "exchanges": self.n_exchanges}


def rank_devices(world_size: int, backend: str, devices=None) -> list:
    """The device of every rank: rank r runs on ``devices[r % len(devices)]``
    (default ``cuda:{r % torch.cuda.device_count()}``).  Raises, before any
    process group exists, for a backend other than gloo or nccl, and for
    NCCL unless every rank has a card of its own (NCCL refuses two ranks on
    one GPU; several ranks may share a card under gloo)."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
    if world_size < 1 or world_size & (world_size - 1):
        raise ValueError(f"world size {world_size}: must be a power of two")
    if world_size > MAX_WORLD_SIZE:
        raise ValueError(f"world size {world_size}: at most {MAX_WORLD_SIZE} "
                         "ranks (every FRI layer on the device must split)")
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("no CUDA device is available: name the ranks' "
                               "devices (e.g. devices=['cpu'] with gloo)")
        devices = [f"cuda:{r % count}" for r in range(world_size)]
    if not devices:
        raise ValueError("rank_devices needs at least one device")
    per = [torch.device(devices[r % len(devices)]) for r in range(world_size)]
    if backend == "nccl":
        if any(d.type != "cuda" for d in per):
            raise ValueError(f"backend 'nccl' needs a CUDA device per rank, got "
                             f"{[str(d) for d in per]}")
        cards = [d.index or 0 for d in per]
        if len(set(cards)) != world_size:
            raise ValueError(
                f"backend 'nccl' with {world_size} ranks on cards {cards}: NCCL "
                "refuses two ranks on one card; give each rank its own card or "
                "use backend='gloo'")
    return per


def make_row_mesh(world_size=None, *, backend, init_method=None, device=None,
                  rank=None) -> RowMesh:
    """Join (or reuse) the default process group and describe this rank.

    Without an initialised group, ``world_size``, ``rank`` and
    ``init_method`` (``file://...`` on one host, or ``tcp://host:port``)
    are required.  ``device`` defaults to ``cuda:{rank % device_count}``
    (`rank_devices`).  A rank on a card makes that card current before it
    joins the group, so that nothing it does makes a context on another
    card; an NCCL group is bound to the card as it is made."""
    from ..device import use_device

    if dist.is_initialized():
        rank, ws = dist.get_rank(), dist.get_world_size()
        if world_size is not None and world_size != ws:
            raise ValueError(f"world size {world_size}, but the group has {ws}")
        if dist.get_backend() != backend:
            raise ValueError(f"backend {backend!r}, but the group runs "
                             f"{dist.get_backend()!r}")
    else:
        if world_size is None or rank is None or init_method is None:
            raise ValueError("make_row_mesh: world_size, rank and init_method "
                             "are needed to join a process group")
        if backend not in ("gloo", "nccl"):
            raise ValueError(f"backend {backend!r}: use 'gloo' or 'nccl'")
        ws = world_size
    if ws & (ws - 1) or ws > MAX_WORLD_SIZE:
        raise ValueError(f"world size {ws}: must be a power of two, at most "
                         f"{MAX_WORLD_SIZE}")
    if device is None:
        device = rank_devices(ws, backend)[rank]
    if backend == "nccl" and torch.device(device).type != "cuda":
        raise ValueError(f"backend 'nccl' needs a CUDA device, got {device}")
    device = use_device(device)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=ws,
            device_id=device if backend == "nccl" else None)
    return RowMesh(dist.group.WORLD, rank, ws, device, backend)


_ACTIVE: list = []


@contextmanager
def prover_mesh(mesh: RowMesh):
    """Run ``prove_cairo_m`` (and friends) on this rank's share of every
    stack."""
    _ACTIVE.append(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.pop()


def active_mesh():
    return _ACTIVE[-1] if _ACTIVE else None


def _mesh() -> RowMesh:
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError("no active prover_mesh")
    return mesh


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


def shards(n: int) -> bool:
    """Is a domain axis of length n split over the active mesh?  Only when
    D^2 divides n: both layouts and the transposes between them need n/D
    to be a multiple of D."""
    mesh = active_mesh()
    return mesh is not None and n % (mesh.world_size ** 2) == 0


def is_share(x, log_size: int) -> bool:
    """Is ``x`` (NumPy or torch) this rank's share, cyclic or block, of a
    domain axis of 2^log_size points, rather than the whole axis?  Raises
    for a trailing axis of any other length, with a mesh or without."""
    n, m = 1 << log_size, int(x.shape[-1])
    if m == n:
        return False
    mesh = active_mesh()
    if mesh is None or not shards(n) or m != n // mesh.world_size:
        raise ValueError(f"a trailing axis of {m} points is neither a domain "
                         f"of {n} points nor this rank's share of it")
    return True


def share_of(t, x, log_size: int):
    """The entries of a per-point vector ``t`` (FFT order: points,
    twiddles) that the lanes of ``x`` meet: all of ``t`` where ``x`` holds
    its 2^log_size axis whole, every D-th from this rank's where it holds
    its cyclic share."""
    return cyclic_slice(t) if is_share(x, log_size) else t


def whole(x, log_size: int):
    """FFT-order evaluations of a 2^log_size axis, whole on every rank
    (gathered if ``x`` is a cyclic share)."""
    return gather_cyclic(x) if is_share(x, log_size) else x


def whole_commit(x, log_size: int):
    """Commit-order values of a 2^log_size axis, whole on every rank
    (gathered if ``x`` is a commit-order block)."""
    return gather_commit(x) if is_share(x, log_size) else x


def local_len(n: int) -> int:
    """Length of this rank's share of a domain axis of length n (n itself
    outside a mesh or where the axis stays whole)."""
    return n // _mesh().world_size if shards(n) else n


def maybe_shard(x):
    """This rank's cyclic share of the trailing (domain) axis of an
    FFT-order array (NumPy or torch): a no-op outside a mesh and where the
    axis is too small for the layout (`shards`)."""
    mesh = active_mesh()
    if mesh is None or not hasattr(x, "ndim") or x.ndim == 0:
        return x
    if not shards(int(x.shape[-1])):
        return x
    return x[..., mesh.rank :: mesh.world_size]


def cyclic_slice(t):
    """Rank r's entries r, r + D, ... of a (twiddle) vector, whatever its
    length: the factors a cyclic share's lanes meet."""
    mesh = _mesh()
    return t[..., mesh.rank :: mesh.world_size]


def block_share(x):
    """This rank's block of the trailing axis of a coefficient array (no-op
    outside a mesh or where the axis is too small)."""
    mesh = active_mesh()
    n = int(x.shape[-1])
    if mesh is None or not shards(n):
        return x
    nl = n // mesh.world_size
    return x[..., mesh.rank * nl : (mesh.rank + 1) * nl]


def bitrev_bits(v: int, bits: int) -> int:
    return int(format(v, f"0{bits}b")[::-1], 2) if bits else 0


def commit_block(mesh: RowMesh = None) -> int:
    """Index of the commit-order block a rank's cyclic share becomes."""
    mesh = mesh or _mesh()
    return bitrev_bits(mesh.rank, mesh.log_ws)


# ---------------------------------------------------------------------------
# Collectives (int32 on the wire; gloo stages device tensors on the host)
# ---------------------------------------------------------------------------


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32) if x.dtype == torch.int64 else x


def _from_wire(x: torch.Tensor) -> torch.Tensor:
    return x.long() & _M32


def _staged(mesh: RowMesh, fn, *tensors):
    """Run collective ``fn`` over ``tensors`` and return its outputs on the
    mesh's device, counting its seconds.

    Every input must lie on the mesh's device, under every backend (NCCL
    takes no host tensors, and an exchange on the wrong device is a fault
    of the caller that gloo would hide): anything else raises.  gloo takes
    no device tensors for most collectives, so under gloo a device tensor
    is copied to the host and the result back; the card is synchronised
    first (the copy would wait for it anyway) so that the seconds are the
    exchange's own.  NCCL runs on the device, in stream order: two CUDA
    events around it are read later (`RowMesh.stats`), and nothing waits
    for the card here."""
    for x in tensors:
        if x.device != mesh.device:
            raise ValueError(f"an exchange got a tensor on {x.device}; the "
                             f"mesh's device is {mesh.device}")
    mesh.n_exchanges += 1
    dev = mesh.device
    if mesh.backend == "nccl":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        outs = fn(*tensors)
        end.record()
        mesh.events.append((start, end))
        return outs
    stage = dev.type == "cuda"
    if stage:
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    outs = fn(*[x.cpu() for x in tensors] if stage else tensors)
    if stage:
        outs = [o.to(dev) for o in outs]
    mesh.exchange_s += time.perf_counter() - t
    return outs


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """(...) per rank -> (D, ...) in rank order, on every rank."""
    mesh = _mesh()
    w = _to_wire(x.contiguous())
    mesh.bytes_sent += w.numel() * w.element_size() * (mesh.world_size - 1)

    def fn(t):
        parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
        dist.all_gather(parts, t, group=mesh.group)
        return [torch.stack(parts)]

    (out,) = _staged(mesh, fn, w)
    return _from_wire(out) if x.dtype == torch.int64 else out


def all_to_all(chunks: torch.Tensor) -> torch.Tensor:
    """(D, ...) chunks, chunk s for rank s -> (D, ...), chunk s from rank s."""
    mesh = _mesh()
    w = _to_wire(chunks.contiguous())
    mesh.bytes_sent += w[0].numel() * w.element_size() * (mesh.world_size - 1)

    def fn(t):
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=mesh.group)
        return [out]

    (out,) = _staged(mesh, fn, w)
    return _from_wire(out)


def _all_to_all_v(send: torch.Tensor, send_splits, recv_splits) -> torch.Tensor:
    """(S, R) rows, ``send_splits[s]`` of them for rank s, in rank order ->
    (sum(recv_splits), R) rows, ``recv_splits[s]`` of them from rank s."""
    mesh = _mesh()
    w = _to_wire(send.contiguous())
    row = w.element_size() * (int(w.shape[1]) if w.dim() > 1 else 1)
    mesh.bytes_sent += row * (sum(send_splits) - send_splits[mesh.rank])

    def fn(t):
        out = t.new_empty((sum(recv_splits),) + tuple(t.shape[1:]))
        dist.all_to_all_single(out, t, list(recv_splits), list(send_splits),
                               group=mesh.group)
        return [out]

    (out,) = _staged(mesh, fn, w)
    return _from_wire(out)


def psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over ranks of an int64 tensor (exact)."""
    mesh = _mesh()
    mesh.bytes_sent += x.numel() * x.element_size() * (mesh.world_size - 1)

    def fn(t):
        t = t.clone()
        dist.all_reduce(t, group=mesh.group)
        return [t]

    return _staged(mesh, fn, x.contiguous())[0]


def psum_mod(x: torch.Tensor) -> torch.Tensor:
    """Modular sum over ranks of M31 values in [0, P): an int64 all-reduce
    cannot overflow (D * P < 2^63), then one reduction mod P."""
    return psum(x.long()) % P


def psum_owned(x: torch.Tensor) -> torch.Tensor:
    """Entries each of which one rank holds and every other rank leaves 0
    (opened values, digest words < 2^32) -> the entries on every rank; int32
    on the wire, which keeps each entry's bits."""
    mesh = _mesh()
    w = _to_wire(x.contiguous())
    mesh.bytes_sent += w.numel() * w.element_size() * (mesh.world_size - 1)

    def fn(t):
        t = t.clone()
        dist.all_reduce(t, group=mesh.group)
        return [t]

    return _from_wire(_staged(mesh, fn, w)[0])


def exclusive_scan_mod(total: torch.Tensor) -> torch.Tensor:
    """Sum mod P of the ``total`` vectors of the ranks below this one."""
    mesh = _mesh()
    parts = all_gather(total.long())
    if mesh.rank == 0:
        return torch.zeros_like(total)
    return parts[: mesh.rank].sum(dim=0) % P


# ---------------------------------------------------------------------------
# Layout changes
# ---------------------------------------------------------------------------


def cyclic_to_block(x: torch.Tensor) -> torch.Tensor:
    """Cyclic share (lane m = index m*D + r) -> block share (lane t = index
    r*n/D + t) of the same length-n axis: one all-to-all.  Lanes
    [q*c, (q+1)*c), c = n/D^2, go to rank q, which interleaves the D pieces
    it receives."""
    mesh = _mesh()
    D = mesh.world_size
    lead, nl = tuple(x.shape[:-1]), int(x.shape[-1])
    c = nl // D
    send = x.reshape(-1, D, c).permute(1, 0, 2)  # (dest, rows, c)
    recv = all_to_all(send)  # (src, rows, c)
    return recv.permute(1, 2, 0).reshape(lead + (nl,))


def block_to_cyclic(x: torch.Tensor) -> torch.Tensor:
    """Inverse of `cyclic_to_block`."""
    mesh = _mesh()
    D = mesh.world_size
    lead, nl = tuple(x.shape[:-1]), int(x.shape[-1])
    c = nl // D
    send = x.reshape(-1, c, D).permute(2, 0, 1)  # (dest, rows, c)
    recv = all_to_all(send)  # (src, rows, c)
    return recv.permute(1, 0, 2).reshape(lead + (nl,))


def gather_cyclic(x: torch.Tensor) -> torch.Tensor:
    """Cyclic shares -> the whole axis, on every rank."""
    parts = all_gather(x)  # (D, ..., nl)
    nd = parts.dim()
    whole = parts.permute(*range(1, nd), 0)  # (..., nl, D)
    return whole.reshape(tuple(x.shape[:-1]) + (-1,))


def gather_commit(x: torch.Tensor) -> torch.Tensor:
    """Commit-order blocks (rank r holds block bitrev(r)) -> the whole
    commit-order axis, on every rank."""
    mesh = _mesh()
    parts = all_gather(x)
    order = [bitrev_bits(b, mesh.log_ws) for b in range(mesh.world_size)]
    return torch.cat([parts[r] for r in order], dim=-1)


_ROUTES: dict = {}


def _route(mesh: RowMesh, request, device):
    """Send and receive index tables of a routed gather (see
    `gather_lanes`), on ``device``."""
    D, me = mesh.world_size, mesh.rank
    src_rank, src_local = request(me)
    order = np.argsort(src_rank, kind="stable")
    recv_splits = np.bincount(src_rank, minlength=D).tolist()
    send, send_splits = [], []
    for s in range(D):
        r_s, l_s = (src_rank, src_local) if s == me else request(s)
        sel = l_s[r_s == me]
        send.append(sel)
        send_splits.append(int(sel.size))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int64)).to(device)

    return dev(np.concatenate(send)), send_splits, dev(order), recv_splits


def gather_lanes(x: torch.Tensor, key, request) -> torch.Tensor:
    """Routed all-to-all along the last axis: lane j of the result is the
    entry ``src_local[j]`` of rank ``src_rank[j]``'s ``x``, where
    ``request(s) -> (src_rank, src_local)`` gives those arrays for the lanes
    of any rank s (NumPy; every rank can compute every rank's request, so
    each knows what to send).  The tables are cached under ``key``."""
    mesh = _mesh()
    ck = (key, mesh.key(), str(x.device))
    route = _ROUTES.get(ck)
    if route is None:
        if len(_ROUTES) > 256:
            _ROUTES.clear()
        route = _ROUTES[ck] = _route(mesh, request, x.device)
    send_idx, send_splits, order, recv_splits = route
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, int(x.shape[-1]))
    recv = _all_to_all_v(x2.index_select(1, send_idx).T, send_splits,
                         recv_splits)  # (lanes, rows)
    out = x2.new_empty((x2.shape[0], int(order.shape[0])))
    out[:, order] = recv.T
    return out.reshape(lead + (-1,))


@lru_cache(maxsize=None)
def _fft_perm(n: int):
    """(row at each FFT index, FFT index of each row) of a length-n axis."""
    from ..prover.stark import domain

    pos = np.arange(n, dtype=np.int64)
    perm = domain.to_fft_order(pos)
    inv = np.empty(n, np.int64)
    inv[perm] = pos
    return perm, inv


def shift_rows(x: torch.Tensor, n: int, shift: int) -> torch.Tensor:
    """Cyclic FFT-order shares -> the same lanes holding the row-order value
    ``shift`` rows on, circularly: lane m of rank r (FFT index i = m*D + r,
    row p) gets row (p + shift) mod n, fetched from its owner.  This is the
    wide-tape bank gather of a shifted mask (a permutation for every shift
    that is not a multiple of 2D)."""
    mesh = _mesh()
    D = mesh.world_size
    perm, inv = _fft_perm(n)

    def request(s):
        g = inv[(perm[s::D] + shift) % n]
        return g % D, g // D

    return gather_lanes(x, ("shift", n, shift % n), request)


def row_cumsum_mod(x: torch.Tensor, n: int) -> torch.Tensor:
    """Prefix sums mod P along the ROWS of a cyclic FFT-order share: the
    lanes move to row blocks (routed all-to-all), each rank sums its block,
    adds the exclusive scan of the lower ranks' totals, and the lanes move
    back."""
    mesh = _mesh()
    D = mesh.world_size
    nl = n // D
    perm, inv = _fft_perm(n)

    def to_rows(s):
        g = inv[s * nl : (s + 1) * nl]
        return g % D, g // D

    def to_fft(s):
        p = perm[s::D]
        return p // nl, p % nl

    rows = gather_lanes(x, ("rows", n), to_rows)
    c = torch.cumsum(rows, dim=-1) % P
    c = (c + exclusive_scan_mod(c[..., -1])[..., None]) % P
    return gather_lanes(c, ("unrows", n), to_fft)


# ---------------------------------------------------------------------------
# Launcher and rank entry
# ---------------------------------------------------------------------------


def config_to_json(cfg) -> dict:
    fc = cfg.fri_config
    return {"pow_bits": cfg.pow_bits, "log_blowup_factor": fc.log_blowup_factor,
            "log_last_layer_degree_bound": fc.log_last_layer_degree_bound,
            "n_queries": fc.n_queries, "framing": cfg.framing}


def config_from_json(o):
    from ..prover.stark.fri import FriConfig
    from ..prover.stark.pcs import PcsConfig

    return PcsConfig(
        pow_bits=o["pow_bits"],
        fri_config=FriConfig(
            log_blowup_factor=o["log_blowup_factor"],
            log_last_layer_degree_bound=o["log_last_layer_degree_bound"],
            n_queries=o["n_queries"]),
        framing=o["framing"])


def _rank_main(argv):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--backend", required=True)
    ap.add_argument("--init-method", required=True)
    ap.add_argument("--device", required=True)
    ap.add_argument("--workdir", required=True)
    args = ap.parse_args(argv)

    from .. import kernels
    from ..compiler import compile_cairo
    from ..prover.adapter.native_import import native_prover_input
    from ..prover.config import set_test_scale
    from ..prover.prove import prove_cairo_m

    with open(os.path.join(args.workdir, "job.json")) as f:
        spec = json.load(f)
    if spec.get("test_scale"):
        set_test_scale(**spec["test_scale"])
    cfg = config_from_json(spec["config"])
    mesh = make_row_mesh(args.world_size, backend=args.backend,
                         init_method=args.init_method, device=args.device,
                         rank=args.rank)
    device = mesh.device
    t = time.perf_counter()
    program = compile_cairo(spec["source"]).program
    pi = native_prover_input(program, spec["entrypoint"], spec["args"],
                             spec["max_steps"])
    record = {"rank": args.rank, "device": str(device),
              "backend": args.backend, "world_size": args.world_size,
              "n_steps": pi.total_steps,
              "input_s": time.perf_counter() - t, "runs": []}
    cuda = device.type == "cuda"
    if cuda:
        # a gloo rank has not touched its card yet: make its context first
        torch.zeros((), device=device)
        torch.cuda.reset_peak_memory_stats(device)
    for _ in range(spec["runs"]):
        kernels.reset_launches()
        mesh.reset_stats()
        timing = {}
        if cuda:
            torch.cuda.synchronize(device)
        t = time.perf_counter()
        with prover_mesh(mesh):
            proof = prove_cairo_m(pi, cfg, timing, device=device)
        if cuda:
            torch.cuda.synchronize(device)
        record["runs"].append({
            "seconds": time.perf_counter() - t, "phases": timing,
            "launches": dict(kernels.launches), "exchange": mesh.stats()})
    if cuda:
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated(device)
    # the rank's own peak resident set (Linux reports KiB): each rank runs
    # the whole VM and adapter
    record["host_peak_bytes"] = resource.getrusage(
        resource.RUSAGE_SELF).ru_maxrss * 1024
    record["proof"] = proof.to_json_obj()
    with open(os.path.join(args.workdir, f"rank_{args.rank}.json"), "w") as f:
        json.dump(record, f)
    # every rank has written its proof before any leaves the group
    dist.barrier()
    dist.destroy_process_group()


def prove_sharded(source: str, entrypoint: str, args, *, world_size: int,
                  backend: str, devices=None, config=None, test_scale=None,
                  max_steps=None, runs: int = 1, records=None,
                  timeout: int = 900):
    """Prove ``entrypoint(*args)`` of ``source`` row-sharded over
    ``world_size`` rank processes on one host, and return the proof.

    Rank r runs on ``devices[r % len(devices)]`` (default
    ``cuda:{r % device_count}``) under ``backend`` (`rank_devices` says
    which combinations are allowed).  Each rank compiles, runs the native
    VM + adapter and proves ``runs`` times under the mesh; every rank's
    proof must be byte-equal, and rank 0's is returned.  ``records`` (a
    list) receives each rank's record: seconds and phases per run, kernel
    launches and exchange bytes/seconds per run, peak device memory on its
    own card, peak host memory.  A rank that fails makes this raise."""
    from ..prover.config import REGULAR_96_BITS
    from ..prover.prove import Proof

    config = REGULAR_96_BITS if config is None else config
    per = rank_devices(world_size, backend, devices)
    with tempfile.TemporaryDirectory(prefix="cm_sharded_") as workdir:
        with open(os.path.join(workdir, "job.json"), "w") as f:
            json.dump({"source": source, "entrypoint": entrypoint,
                       "args": list(args),
                       "max_steps": (1 << 32) if max_steps is None else max_steps,
                       "config": config_to_json(config),
                       "test_scale": test_scale, "runs": runs}, f)
        # a file store in the job's own directory: no port to collide on
        init = "file://" + os.path.join(workdir, "store")
        repo = os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        procs = [
            subprocess.Popen(
                [sys.executable, "-m", "cairo_m_tpu_torch.parallel.sharded",
                 "--rank", str(r), "--world-size", str(world_size),
                 "--backend", backend, "--init-method", init,
                 "--device", str(per[r]), "--workdir", workdir],
                cwd=repo)
            for r in range(world_size)
        ]
        try:
            deadline = time.time() + timeout
            pending = list(procs)
            while pending:
                for p in list(pending):
                    rc = p.poll()
                    if rc is None:
                        continue
                    pending.remove(p)
                    if rc != 0:
                        raise RuntimeError(
                            f"rank {procs.index(p)} exited with {rc}")
                if time.time() > deadline:
                    raise RuntimeError(f"ranks still running after {timeout} s")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        recs = []
        for r in range(world_size):
            with open(os.path.join(workdir, f"rank_{r}.json")) as f:
                recs.append(json.load(f))
    texts = [json.dumps(rec["proof"], sort_keys=True) for rec in recs]
    if any(t != texts[0] for t in texts):
        raise RuntimeError("the ranks' proofs differ")
    if records is not None:
        records.extend(recs)
    return Proof.from_json_obj(recs[0]["proof"])


if __name__ == "__main__":
    # run as the package's module, not as __main__: the prover reads the
    # active mesh from cairo_m_tpu_torch.parallel.sharded
    from cairo_m_tpu_torch.parallel import sharded as _sharded

    _sharded._rank_main(sys.argv[1:])
