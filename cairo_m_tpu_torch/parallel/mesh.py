"""Column-sharded building blocks on torch.distributed.

Counterpart of ``cairo_m_tpu.parallel.mesh``, whose ``shard_map`` blocks
split a phase's columns over a device mesh: each device LDEs and hashes its
share of the columns, and modular sums are reduced across the mesh (the
LogUp-reduction pattern).  Here the mesh is a process group of ranks
(`sharded.RowMesh`, one process per rank) and each function runs on one
rank's share, with the collective explicit: for the same inputs and world
size the ranks' outputs, gathered, equal the reference's bit for bit.

The row-sharded prover itself is `parallel/sharded.py`.
"""

from __future__ import annotations

import torch

from ..field import m31
from ..hash import blake2s
from ..prover.stark import domain, fft
from . import sharded

P = (1 << 31) - 1


def make_mesh(world_size=None, *, backend, init_method=None, device=None,
              rank=None) -> sharded.RowMesh:
    """The ranks' process group (reference ``make_mesh``): the same
    `sharded.RowMesh` the row-sharded prover uses, here split by columns."""
    return sharded.make_row_mesh(world_size, backend=backend,
                                 init_method=init_method, device=device,
                                 rank=rank)


def psum_mod(x: torch.Tensor, mesh: sharded.RowMesh) -> torch.Tensor:
    """Modular sum over the ranks of M31 values in [0, P).  The reference
    splits uint32 values into 16-bit halves so that its psum cannot
    overflow; an int64 all-reduce of D values below 2^31 cannot, so one
    reduction mod P follows it."""
    with sharded.prover_mesh(mesh):
        return sharded.psum_mod(x)


def sharded_commit_pipeline(mesh: sharded.RowMesh, trace_log: int, commit_log: int):
    """Column-sharded LDE + commit-order transform: each rank transforms its
    own (k_local, 2^trace_log) FFT-order columns; no collective.
    -> f(columns) -> (coefficients, commit-order LDE), this rank's columns."""

    def f(stacked):
        coeffs = fft.ifft(stacked, trace_log)
        ext = fft.fft(fft.embed_coeffs(coeffs, trace_log, commit_log), commit_log)
        return coeffs, domain.bit_reverse(ext, commit_log)

    return f


def sharded_logup_total(mesh: sharded.RowMesh):
    """-> f(partials): this rank's (n_local, 4) partial LogUp sums added up,
    then reduced over the ranks with `psum_mod` -> (4,), on every rank."""

    def f(partials):
        total = partials[0]
        for i in range(1, partials.shape[0]):
            total = m31.add(total, partials[i])
        return psum_mod(total, mesh)

    return f


def sharded_prove_step(mesh: sharded.RowMesh, trace_log: int, commit_log: int):
    """A column-sharded prove step for dry runs: the LDE/commit transform of
    this rank's columns, BLAKE2s leaf digests of its column share (the leaf
    kernel on the card, its plain version on the CPU) and a `psum_mod`'d
    checksum of the first digest word.  Its value depends on the world
    size (each rank hashes only its columns).
    -> f(columns) -> (commit-order LDE of this rank's columns, checksum)."""
    pipeline = sharded_commit_pipeline(mesh, trace_log, commit_log)

    def f(stacked):
        _, commit = pipeline(stacked)
        digests = blake2s.hash_leaves(commit.contiguous())
        check = m31.sum_mod(digests[0] & (P - 1), dim=0)
        return commit, psum_mod(check, mesh)

    return f
