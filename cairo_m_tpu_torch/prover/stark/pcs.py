"""Polynomial commitment scheme: commit phases -> OODS sampling -> DEEP
quotients -> FRI -> PoW -> query decommitment.

Counterpart of ``cairo_m_tpu.prover.stark.pcs``.  A *phase* is one logical
commitment (preprocessed / trace / interaction / composition) holding many
M31 columns.  Two framings (``PcsConfig.framing``):

- ``"native"``: this framework's channel framing and one dense Merkle tree
  per (phase, log_size) group, built on the columns' device (`merkle.py`);
  the roots are mixed largest-first;
- ``"stwo"``: stwo's ``Blake2sChannel`` byte framing
  (``cairo_m_tpu.prover.stark.stwo_channel``) and ONE mixed-degree tree per
  phase, built on the host from one pull of the phase's committed columns
  (`stwo_merkle.py`).

Transcript order within `prove_values`:

1. mix all sampled values (canonical (phase, column, point) order);
2. ``random_coeff = draw`` (quotient alpha);
3. FRI commit on the quotient columns (mixes layer roots, draws alphas);
4. PoW: ``nonce = grind(pow_bits)``; ``mix_u64(nonce)``;
5. ``queries = draw_queries(n_queries, max_log)``;
6. decommit every phase tree and FRI layer at the query pair positions.

The verifier replays the same transcript and checks Merkle openings, FRI
folds, the last-layer degree, and the PoW.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .channel import Blake2sChannel
from ...parallel import sharded
from .. import observe
from .stwo_channel import StwoBlake2sChannel

from . import domain, fft, fri, merkle, quotients, stwo_merkle

P = (1 << 31) - 1


def _commit_pipeline(stacked, trace_log: int, commit_log: int):
    """(k, 2^trace_log) fft-order stack -> (coeffs, fft-order LDE,
    commit-order LDE).  The fft-order LDE is kept on the phase so the
    composition plans reuse it instead of re-extending columns."""
    coeffs = fft.ifft(stacked, trace_log)
    ext = fft.fft(fft.embed_coeffs(coeffs, trace_log, commit_log), commit_log)
    return coeffs, ext, domain.bit_reverse(ext, commit_log)


@dataclass
class PcsConfig:
    pow_bits: int = 16
    fri_config: fri.FriConfig = field(default_factory=fri.FriConfig)
    framing: str = "native"  # or "stwo" (see the module docstring)

    def make_channel(self):
        if self.framing == "stwo":
            return StwoBlake2sChannel()
        return Blake2sChannel()

    def mix_into(self, channel):
        channel.mix_u64(self.pow_bits)
        channel.mix_u64(self.fri_config.log_blowup_factor)
        channel.mix_u64(self.fri_config.log_last_layer_degree_bound)
        channel.mix_u64(self.fri_config.n_queries)

    def security_bits(self) -> int:
        return (
            self.pow_bits
            + self.fri_config.log_blowup_factor * self.fri_config.n_queries
        )


class CommitmentPhase:
    """One committed phase: columns grouped by log_size, one LDE per group;
    one Merkle tree per group (native framing) or one mixed-degree tree over
    all columns (stwo framing)."""

    def __init__(self, columns_fft, log_blowup: int, framing: str = "native"):
        """columns_fft: list of (trace_log_size, fft-order M31 evals) —
        1-D entries are single columns, 2-D entries are (k, n) stacks of k
        columns of that log size, all int64 tensors on one device.

        Each column is LDE'd by the blowup and committed on the extended
        domain.  The *commit log size* of a column = trace_log + blowup."""
        self.framing = framing
        self.trace_logs = []
        # group columns by trace log (stable order within group)
        self.group_index = {}  # column index -> (trace_log, position in group)
        groups: dict[int, list] = {}
        counts: dict[int, int] = {}
        for l, arr in columns_fft:
            l = int(l)
            arr2 = arr[None] if arr.dim() == 1 else arr
            k = int(arr2.shape[0])
            base = counts.get(l, 0)
            for j in range(k):
                self.group_index[len(self.trace_logs)] = (l, base + j)
                self.trace_logs.append(l)
            counts[l] = base + k
            groups.setdefault(l, []).append(arr2)
        self.commit_logs = [l + log_blowup for l in self.trace_logs]
        self.stacked_coeffs = {}  # trace_log -> (k, n) device
        self.stacked_ext = {}  # commit_log -> (k, 2n) device, FFT order
        self.trees = {}
        stacked_commit = {}  # commit_log -> (k, 2n) device, commit order
        for l in sorted(groups, reverse=True):
            cl = l + log_blowup
            pieces = groups[l]
            with observe.span("lde", k=counts[l], log=l, commit_log=cl,
                              micro=("micro", "fft k={k} log={log}->{commit_log}")):
                stacked = pieces[0] if len(pieces) == 1 else torch.cat(pieces, dim=0)
                coeffs, ext_cols, commit_cols = _commit_pipeline(stacked, l, cl)
            self.stacked_coeffs[l] = coeffs
            self.stacked_ext[cl] = ext_cols
            if framing == "stwo":
                stacked_commit[cl] = commit_cols
            else:
                with observe.span("merkle", log=cl):
                    self.trees[cl] = merkle.MerkleTree(
                        commit_cols, defer_top=True, log_size=cl
                    )
        if framing == "stwo":
            self.stwo_tree = self._stwo_tree(stacked_commit, log_blowup)
            return
        # ONE device->host pull of every tree's upper levels (hashed on the
        # device; the host only mirrors them)
        logs = sorted(self.trees, reverse=True)
        if logs:
            with observe.span("tops", micro=("micro", "top pull + host mirror")):
                self._finish_tops(logs)

    def _finish_tops(self, logs):
        tops = torch.cat([self.trees[cl].top_dev for cl in logs], dim=1)
        if sharded.active_mesh() is not None:
            # every rank's tops, rank order: the split trees' subtree tops
            # are finished together, whole trees from rank 0's copy
            tops = sharded.all_gather(tops)
        tops = observe.pull(tops)
        off = 0
        for cl in logs:
            tree = self.trees[cl]
            m = int(tree.top_dev.shape[1])
            if tops.ndim == 2:
                tree.finish_host(tops[:, off : off + m])
            elif tree.share is None:
                tree.finish_host(tops[0, :, off : off + m])
            else:
                tree.finish_host_shared(tops[:, :, off : off + m])
            off += m

    def _stwo_tree(self, stacked_commit, log_blowup: int):
        """ONE device->host pull of every commit-order stack, then one
        mixed-degree host tree over the columns in phase column order."""
        logs = sorted(stacked_commit, reverse=True)
        # the host tree reads every column whole: under a row mesh the
        # ranks' commit-order blocks are gathered
        stacked_commit = {
            cl: sharded.whole_commit(st, cl) for cl, st in stacked_commit.items()
        }
        flat = torch.cat([stacked_commit[cl].reshape(-1) for cl in logs])
        # M31 values fit in int32: half the bytes of the int64 carrier
        flat = observe.pull(flat.to(torch.int32)).view(np.uint32)
        pulled, off = {}, 0
        for cl in logs:
            k = int(stacked_commit[cl].shape[0])
            pulled[cl] = flat[off : off + (k << cl)].reshape(k, 1 << cl)
            off += k << cl
        cols = []
        for ci in range(len(self.trace_logs)):
            l, pos = self.group_index[ci]
            cols.append(pulled[l + log_blowup][pos])
        with observe.phase("stwo_host_tree",
                           micro=("micro", "stwo mixed-degree tree (host)")):
            return stwo_merkle.StwoMerkleTree(cols)

    def roots(self):
        if self.framing == "stwo":
            return [(max(self.commit_logs), self.stwo_tree.root())]
        return [(cl, self.trees[cl].root()) for cl in sorted(self.trees, reverse=True)]

    def mix_roots(self, channel):
        """Mix all tree roots largest-first (stwo framing: the single
        mixed-degree root)."""
        for _, r in self.roots():
            channel.mix_root(r)

    def sample_dispatch(self, points_per_column):
        """Queue the point evaluations for this phase; returns an opaque
        (jobs, devs, n_cols) handle for `sample_finish`.  All columns of one
        log_size in a phase share the same point list (the protocol
        guarantees it): one stacked evaluation per (log, point)."""
        jobs = {}
        for ci, (l, pts) in enumerate(zip(self.trace_logs, points_per_column)):
            for pi_, z in enumerate(pts):
                jobs.setdefault((l, z), []).append((ci, pi_))
        devs = []
        for (l, z), lst in jobs.items():
            coeffs = self.stacked_coeffs[l]
            tws = fft.point_eval_twiddles_host(z, l)
            v = fft.eval_at_qpoint_folds(coeffs, l, tws)
            devs.append(torch.stack(v).reshape(-1))  # (4*k,)
        return jobs, devs, len(points_per_column)

    def sample_finish(self, handle, flat: np.ndarray, off: int):
        """Assemble sampled values from the (already pulled) flat array
        starting at ``off``; returns (values, new offset)."""
        jobs, devs, n_cols = handle
        sizes = {}
        for lst in jobs.values():
            for ci, pi_ in lst:
                sizes[ci] = max(sizes.get(ci, 0), pi_ + 1)
        out = [[None] * sizes.get(ci, 0) for ci in range(n_cols)]
        for (l, z), lst in jobs.items():
            k = int(self.stacked_coeffs[l].shape[0])
            vh = flat[off : off + 4 * k].reshape(4, k)
            off += 4 * k
            for ci, pi_ in lst:
                _, pos = self.group_index[ci]
                out[ci][pi_] = tuple(int(vh[j][pos]) for j in range(4))
        return out, off


def _dec_from_json(phase_obj):
    """Deserialize a per-phase decommitment: stwo opening (tagged with
    ``format: stwo``) or the native per-log_size MerkleDecommitment map."""
    if isinstance(phase_obj, dict) and phase_obj.get("format") == "stwo":
        return stwo_merkle.StwoPhaseOpening.from_json_obj(phase_obj)
    return {
        int(l): merkle.MerkleDecommitment.from_json_obj(d)
        for l, d in phase_obj.items()
    }


@dataclass
class PcsProof:
    phase_roots: list  # per phase: [(commit_log, root_bytes)]
    sampled_values: list  # per phase: [col][point] qm31 tuple
    # per phase: {commit_log: MerkleDecommitment} (native) or
    # StwoPhaseOpening (stwo)
    decommitments: list
    fri_proof: fri.FriProof
    pow_nonce: int

    def to_json_obj(self):
        return {
            "phase_roots": [
                [[l, r.hex()] for l, r in phase] for phase in self.phase_roots
            ],
            "sampled_values": [
                [[list(v) for v in col] for col in phase]
                for phase in self.sampled_values
            ],
            "decommitments": [
                phase.to_json_obj()
                if isinstance(phase, stwo_merkle.StwoPhaseOpening)
                else {str(l): d.to_json_obj() for l, d in phase.items()}
                for phase in self.decommitments
            ],
            "fri_proof": self.fri_proof.to_json_obj(),
            "pow_nonce": self.pow_nonce,
        }

    @staticmethod
    def from_json_obj(o):
        return PcsProof(
            [[(l, bytes.fromhex(r)) for l, r in phase] for phase in o["phase_roots"]],
            [
                [[tuple(v) for v in col] for col in phase]
                for phase in o["sampled_values"]
            ],
            [_dec_from_json(phase) for phase in o["decommitments"]],
            fri.FriProof.from_json_obj(o["fri_proof"]),
            o["pow_nonce"],
        )


class CommitmentSchemeProver:
    def __init__(self, channel, config: PcsConfig):
        self.channel = channel
        self.config = config
        self.phases: list[CommitmentPhase] = []

    def commit(self, columns_fft):
        """Commit a phase; mixes its roots into the channel."""
        phase = CommitmentPhase(
            columns_fft,
            self.config.fri_config.log_blowup_factor,
            framing=self.config.framing,
        )
        return self.commit_phase(phase)

    def commit_phase(self, phase: CommitmentPhase):
        """Commit an already-built phase (e.g. the cached preprocessed
        tables, whose columns are proof-independent)."""
        phase.mix_roots(self.channel)
        self.phases.append(phase)
        return len(self.phases) - 1

    def prove_values(self, sample_points) -> PcsProof:
        """sample_points: per phase, per column, list of QM31 circle points.
        One span a step (`observe`): ``sample``, ``alphas``, ``quotients``,
        ``fri``, ``pow_grind``, ``decommit``."""
        channel = self.channel
        for phase, pts in zip(self.phases, sample_points):
            assert len(pts) == len(phase.trace_logs), (
                "sample points don't cover every committed column "
                f"({len(pts)} vs {len(phase.trace_logs)})"
            )
        # 1. sample + mix — all phases' point evaluations queued first, then
        # ONE device->host pull for everything
        with observe.span("sample", label="sample"):
            with observe.span("evaluate"):
                handles = [
                    phase.sample_dispatch(pts)
                    for phase, pts in zip(self.phases, sample_points)
                ]
                all_devs = [d for h in handles for d in h[1]]
            flat = observe.pull(torch.cat(all_devs)) if all_devs else np.zeros(0)
            with observe.span("finish"):
                sampled = []
                off = 0
                for phase, h in zip(self.phases, handles):
                    vals, off = phase.sample_finish(h, flat, off)
                    sampled.append(vals)
        with observe.span("alphas"):
            channel.mix_felts(
                [v for phase_vals in sampled for col in phase_vals for v in col]
            )
            # 2. quotient alpha
            random_coeff = channel.draw_felt()
            # enumerate (phase, column, point) -> alpha^k; column handles
            # are ((phase, commit_log), row) pairs into the phases'
            # FFT-order extended stacks
            samples = []
            apow = (1, 0, 0, 0)
            for pi_, (phase, pts, vals) in enumerate(
                zip(self.phases, sample_points, sampled)
            ):
                for col_idx, (zs, vs) in enumerate(zip(pts, vals)):
                    cl = phase.commit_logs[col_idx]
                    _, pos = phase.group_index[col_idx]
                    for z, v in zip(zs, vs):
                        samples.append((cl, ((pi_, cl), pos), z, v, apow))
                        apow = fri.qscalar_mul(apow, random_coeff)
            grouped = quotients.group_samples(samples)
        with observe.span("quotients", label="quotients (dispatch)"):
            stacks = {
                (pi_, cl): phase.stacked_ext[cl]
                for pi_, phase in enumerate(self.phases)
                for cl in phase.stacked_ext
            }
            quotient_cols = [
                (l, quotients.quotient_column_device(l, batches, stacks))
                for l, batches in sorted(grouped.items(), reverse=True)
            ]
        # 3. FRI commit
        with observe.span("fri", label="fri commit"):
            fri_prover = fri.FriProver(
                channel, quotient_cols, self.config.fri_config,
                framing=self.config.framing,
            )
        # 4. PoW
        with observe.span("pow_grind", label="pow grind"):
            nonce = channel.grind(self.config.pow_bits)
            channel.mix_u64(nonce)
        stwo = self.config.framing == "stwo"
        with observe.span("decommit", label="decommit (stwo framing)" if stwo
                          else "decommit (phases + fri)"):
            # 5. queries (the channel's draw loops forever if it cannot
            # find n_queries distinct positions)
            max_log = fri_prover.max_log
            n_queries = self.config.fri_config.n_queries
            if n_queries > 1 << max_log:
                raise ValueError(
                    f"n_queries={n_queries} exceeds the 2^{max_log} query domain"
                )
            queries = channel.draw_queries(n_queries, max_log)
            if stwo:
                decommitments, fri_proof = self._stwo_decommit(
                    queries, max_log, fri_prover)
            else:
                decommitments, fri_proof = self._decommit(
                    queries, max_log, fri_prover)
        return PcsProof(
            [p.roots() for p in self.phases],
            sampled,
            decommitments,
            fri_proof,
            nonce,
        )

    def _stwo_decommit(self, queries, max_log, fri_prover):
        """6'. stwo decommit: one mixed-tree opening per phase + one per
        FRI layer (host trees)."""
        with observe.phase("stwo_host_tree"):
            decommitments = []
            for phase in self.phases:
                qpl = {
                    cl: fri.pair_positions(queries, max_log, cl)
                    for cl in set(phase.commit_logs)
                }
                queried, dec = phase.stwo_tree.decommit(qpl)
                decommitments.append(stwo_merkle.StwoPhaseOpening(queried, dec))
            fri_roots, fri_openings = fri_prover.stwo_decommit(queries)
        return decommitments, fri.FriProof(fri_roots, fri_openings,
                                           fri_prover.last_layer)

    def _decommit(self, queries, max_log, fri_prover):
        """6. decommit — all phase trees' AND FRI layer trees' openings in
        ONE device->host pull."""
        plan_keys = []
        plans = []
        with observe.span("plans", of="phases", label="decommit: phase plans"):
            for pi_, phase in enumerate(self.phases):
                for cl, tree in phase.trees.items():
                    pairs = fri.pair_positions(queries, max_log, cl)
                    plans.append(merkle.DecommitPlan(tree, pairs))
                    plan_keys.append((pi_, cl))
        with observe.span("plans", of="fri", label="decommit: fri plans"):
            fri_roots, fri_plans = fri_prover.decommit_plans(queries)
        with observe.span("openings", label="decommit: pull + finish"):
            decs = merkle.finish_plans(plans + fri_plans)
        decommitments = [{} for _ in self.phases]
        for (pi_, cl), dec in zip(plan_keys, decs[: len(plans)]):
            decommitments[pi_][cl] = dec
        return decommitments, fri.FriProof(
            fri_roots, decs[len(plans) :], fri_prover.last_layer
        )


class CommitmentSchemeVerifier:
    def __init__(self, channel, config: PcsConfig):
        self.channel = channel
        self.config = config
        self.phase_roots = []  # [(commit_log, root)] per phase
        self.phase_column_logs = []  # per phase: list of commit logs per column

    def commit(self, roots, column_trace_logs):
        """Replay a phase commitment: mix roots; record column structure."""
        blow = self.config.fri_config.log_blowup_factor
        commit_logs = [l + blow for l in column_trace_logs]
        expected = (
            [max(commit_logs)]
            if self.config.framing == "stwo"
            else sorted(set(commit_logs), reverse=True)
        )
        if [l for l, _ in roots] != expected:
            raise ValueError("PCS: phase roots don't match column sizes")
        for _, r in roots:
            self.channel.mix_root(r)
        self.phase_roots.append(list(roots))
        self.phase_column_logs.append(commit_logs)

    def verify_values(self, sample_points, proof: PcsProof) -> bool:
        channel = self.channel
        sampled = proof.sampled_values
        if len(sampled) != len(self.phase_column_logs):
            return False
        flat = [v for phase_vals in sampled for col in phase_vals for v in col]
        channel.mix_felts(flat)
        random_coeff = channel.draw_felt()
        # build sample records with opened-value handles filled in later
        samples = []
        apow = (1, 0, 0, 0)
        for phase_idx, (logs, pts, vals) in enumerate(
            zip(self.phase_column_logs, sample_points, sampled)
        ):
            if len(pts) != len(logs) or len(vals) != len(logs):
                return False
            for col_idx, (cl, zs, vs) in enumerate(zip(logs, pts, vals)):
                if len(zs) != len(vs):
                    return False
                for z, v in zip(zs, vs):
                    samples.append((cl, (phase_idx, col_idx), z, tuple(v), apow))
                    apow = fri.qscalar_mul(apow, random_coeff)
        grouped = quotients.group_samples(samples)
        fri_verifier = fri.FriVerifier(
            channel, self.config.fri_config, list(grouped.keys()),
            proof.fri_proof, framing=self.config.framing,
        )
        # PoW
        if not channel.verify_pow(proof.pow_nonce, self.config.pow_bits):
            return False
        channel.mix_u64(proof.pow_nonce)
        max_log = max(grouped)
        if self.config.fri_config.n_queries > 1 << max_log:
            return False
        queries = channel.draw_queries(self.config.fri_config.n_queries, max_log)
        # verify phase decommitments, collect opened values per (phase, col)
        opened = {}  # (phase_idx, col_idx) -> {pos: value}
        check = (
            self._open_stwo if self.config.framing == "stwo" else self._open_native
        )
        if not check(queries, max_log, proof.decommitments, opened):
            return False
        # compute quotient values at pair positions per log size
        col_values = {}
        for l, batches in grouped.items():
            pairs = fri.pair_positions(queries, max_log, l)
            resolved = []
            for b in batches:
                rb = quotients.ColumnSampleBatch(b.z)
                for handle, v, ap in b.entries:
                    vals = opened.get(handle)
                    if vals is None:
                        return False
                    rb.entries.append((vals, v, ap))
                resolved.append(rb)
            col_values[l] = [
                {
                    pos: quotients.quotient_value_host(l, resolved, pos)
                    for pos in pairs
                }
            ]
        return fri_verifier.verify_queries(queries, col_values)

    def _open_native(self, queries, max_log, decommitments, opened) -> bool:
        """Check every per-log_size tree opening; fill ``opened``."""
        for phase_idx, (logs, roots, decs) in enumerate(
            zip(self.phase_column_logs, self.phase_roots, decommitments)
        ):
            roots_d = dict(roots)
            for cl in sorted(set(logs), reverse=True):
                cols_here = [i for i, l in enumerate(logs) if l == cl]
                pairs = fri.pair_positions(queries, max_log, cl)
                dec = decs.get(cl) if isinstance(decs, dict) else None
                if dec is None:
                    return False
                if not merkle.verify_decommitment(
                    roots_d[cl], cl, len(cols_here), pairs, dec
                ):
                    return False
                for j, col_idx in enumerate(cols_here):
                    opened[(phase_idx, col_idx)] = dec.values[j]
        return True

    def _open_stwo(self, queries, max_log, decommitments, opened) -> bool:
        """Check every phase's mixed-degree tree opening; fill ``opened``."""
        for phase_idx, (logs, roots, opening) in enumerate(
            zip(self.phase_column_logs, self.phase_roots, decommitments)
        ):
            if not isinstance(opening, stwo_merkle.StwoPhaseOpening):
                return False
            qpl = {
                cl: fri.pair_positions(queries, max_log, cl) for cl in set(logs)
            }
            if not stwo_merkle.verify_decommitment(
                roots[0][1], logs, qpl, opening.queried, opening.dec
            ):
                return False
            for ci, cl in enumerate(logs):
                opened[(phase_idx, ci)] = dict(zip(qpl[cl], opening.queried[ci]))
        return True
