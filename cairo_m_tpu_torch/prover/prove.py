"""prove_cairo_m: the full proof transcript (reference prover.rs:23-147).

Counterpart of ``cairo_m_tpu.prover.prove`` on one torch device, which the
caller names: there is no automatic choice and no fallback.  Transcript
order (§2.6 of SURVEY.md, adapted to this framework's PCS):

 1. config.mix_into(channel)
 2. PublicData.mix_into(channel)
 3. commit phase 0: preprocessed columns (range check tables, bitwise)
 4. write all component traces; mix each log_size (claim); commit phase 1
 5. interaction PoW grind(INTERACTION_POW_BITS); mix nonce
 6. Relations.draw; build LogUp interaction traces; mix claimed sums;
    commit phase 2
 7. composition_coeff = draw; compute composition; commit phase 3
 8. OODS point z from draw_felt; sample points per column
    (interaction columns also at z - g of their component)
 9. pcs.prove_values: mix samples, quotients, FRI, PoW, queries, decommit
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..parallel.sharded import active_mesh, local_len, maybe_shard
from . import observe
from .components.registry import ComponentSet
from .config import REGULAR_96_BITS, SCALE
from .public_data import PublicData
from .relations import INTERACTION_POW_BITS, Relations
from .stark import domain, framework, pcs
from .stark.fri import qscalar_add, qscalar_inv, qscalar_mul, qscalar_sub

P = (1 << 31) - 1

# (device, scale key, blowup, framing, mesh key) -> CommitmentPhase of the
# preprocessed tables
_PRE_PHASE_CACHE: dict = {}
# (device, comp name, scale key, mesh key) -> row-order device stack of the
# component's preprocessed columns (rc enumerations, bitwise tables); FFT
# order, and this rank's share, under a row mesh
_PRE_STACK_CACHE: dict = {}


@dataclass
class Proof:
    log_sizes: list  # per component, registry order
    claimed_sums: list  # per component (QM31 tuples)
    public_data: PublicData
    interaction_pow_nonce: int
    pcs_proof: pcs.PcsProof

    def to_json_obj(self):
        return {
            "log_sizes": self.log_sizes,
            "claimed_sums": [list(c) for c in self.claimed_sums],
            "public_data": self.public_data.to_json_obj(),
            "interaction_pow_nonce": self.interaction_pow_nonce,
            "pcs_proof": self.pcs_proof.to_json_obj(),
        }

    @staticmethod
    def from_json_obj(o):
        return Proof(
            list(o["log_sizes"]),
            [tuple(c) for c in o["claimed_sums"]],
            PublicData.from_json_obj(o["public_data"]),
            o["interaction_pow_nonce"],
            pcs.PcsProof.from_json_obj(o["pcs_proof"]),
        )

    def program_id(self) -> int:
        """Poseidon2 Merkle root over just the program's public memory
        entries: a succinct program identity derivable from any proof
        (reference `Proof::program_id`, crates/prover/src/lib.rs:76-98:
        rebuild an addr->value map from public_data.program, hash it as an
        initial-type partial tree with no public addresses).  Computed on
        the host, under the active Poseidon2 instance
        (`hash.poseidon2_params.use_params`)."""
        from ..isa.program import PublicAddressRanges
        from .adapter.merkle import build_partial_merkle_tree

        mem = {
            addr: (tuple(val), 0, 0)
            for addr, val, _clock in self.public_data.program
        }
        _, root = build_partial_merkle_tree(
            mem, "initial", PublicAddressRanges()
        )
        return root


def upload_rows(rows, device) -> torch.Tensor:
    """List of (n,) uint32 NumPy rows (values < 2^31) -> (k, n) int64 stack
    on ``device``: uploaded as int32 (same bits), widened on the device."""
    st = np.ascontiguousarray(np.stack(rows).astype(np.uint32)).view(np.int32)
    return observe.push(st, device).long()


def upload_fft_share(rows, device) -> torch.Tensor:
    """Under a row mesh (parallel/sharded.py): row-order NumPy rows -> this
    rank's cyclic share of the FFT-order stack (the whole stack where the
    domain is too small to split), reordered and cut on the host so that
    only the share crosses to the device."""
    return upload_rows(maybe_shard(domain.to_fft_order(np.stack(rows))), device)


def _mesh_key():
    mesh = active_mesh()
    return None if mesh is None else mesh.key()


def preprocessed_phase(comps: ComponentSet, config, device):
    """The commitment phase of the preprocessed tables (proof-independent,
    so cached per (device, protocol scale, blowup, framing, row mesh))."""
    blowup = config.fri_config.log_blowup_factor
    key = (str(device), SCALE.key(), blowup, config.framing, _mesh_key())
    cached = _PRE_PHASE_CACHE.get(key)
    if cached is None:
        with observe.span("preprocessed"):
            pre_cols, _ = comps.preprocessed_columns()
            if active_mesh() is None:
                cols = [(l, domain.to_fft_order(upload_rows([c], device)))
                        for l, c in pre_cols]
            else:
                cols = [(l, upload_fft_share([c], device)) for l, c in pre_cols]
            cached = pcs.CommitmentPhase(cols, blowup, framing=config.framing)
        _PRE_PHASE_CACHE.clear()  # hold at most one scale's tables
        _PRE_PHASE_CACHE[key] = cached
    return cached


def oods_point_and_prevs(channel, log_sizes):
    """Draw t -> z; also z_prev per log size (z - trace step)."""
    t = channel.draw_felt()
    one = (1, 0, 0, 0)
    t2 = qscalar_mul(t, t)
    dinv = qscalar_inv(qscalar_add(one, t2))
    zx = qscalar_mul(qscalar_sub(one, t2), dinv)
    zy = qscalar_mul(qscalar_add(t, t), dinv)
    z = (zx, zy)
    prevs = {}
    for l in set(log_sizes):
        gx, gy = domain.point_neg(
            domain.point_at_index(domain.subgroup_gen_index(l))
        )
        # z + (-g) over QM31 with a base-field point
        px = qscalar_sub(qscalar_mul_m31_t(zx, gx), qscalar_mul_m31_t(zy, gy))
        py = qscalar_add(qscalar_mul_m31_t(zx, gy), qscalar_mul_m31_t(zy, gx))
        prevs[l] = (px, py)
    return z, prevs


def qscalar_mul_m31_t(a, s: int):
    return tuple((x * s) % P for x in a)


def build_sample_points(comps: ComponentSet, z, z_prevs, pre_owners):
    """Sample point lists for phases 0..3."""
    pre_points = []
    for comp, start, count in pre_owners:
        pre_points += [[z]] * count
    trace_points = []
    for comp in comps.all:
        trace_points += [[z]] * comp.n_trace_cols
    inter_points = []
    for comp in comps.all:
        n_limbs = 4 * comp.n_interaction_cols()
        inter_points += [[z_prevs[comp.log_size], z]] * n_limbs
    comp_points = [[z]] * 4
    return [pre_points, trace_points, inter_points, comp_points]


def _interaction_traces(comps, trace_stacks, device, mesh, observer):
    """-> (claimed sum of each component, the interaction phase's
    (log size, stacked limb columns) entries, row order, or under a mesh
    this rank's FFT-order share): one `dispatch` span a live component,
    one pull of every sum."""
    claimed_dev = []
    inter_entries = []
    zero_claims = set()
    for ci, (comp, st) in enumerate(zip(comps.all, trace_stacks)):
        n = 1 << comp.log_size
        if comp.zero_witness:
            # numerators are products with all-zero trace columns, so every
            # fraction, prefix column and the claimed sum are identically 0
            stacked = torch.zeros(
                (4 * comp.n_interaction_cols(), local_len(n)),
                dtype=torch.int64, device=device,
            )
            zero_claims.add(ci)
            inter_entries.append((comp.log_size, stacked))
            continue
        if comp.n_preprocessed_cols:
            ps_key = (str(device), comp.name, SCALE.key(), _mesh_key())
            pre_stack = _PRE_STACK_CACHE.get(ps_key)
            if pre_stack is None:
                if len(_PRE_STACK_CACHE) > 64:
                    _PRE_STACK_CACHE.clear()
                with observe.span("upload", component=comp.name):
                    if mesh is None:
                        pre_stack = upload_rows(comp.preprocessed_columns(), device)
                    else:
                        pre_stack = upload_fft_share(comp.preprocessed_columns(),
                                                     device)
                _PRE_STACK_CACHE[ps_key] = pre_stack
        else:
            pre_stack = torch.zeros((0, local_len(n)), dtype=torch.int64,
                                    device=device)
        if observer is not None:
            observer.begin("interaction", comp)
        with observe.span("dispatch", stage="interaction", component=comp.name):
            stacked, claimed = framework.gen_interaction_trace_device(
                comp, st, pre_stack
            )
        if observer is not None:
            observer.end("interaction", comp, stacked)
        claimed_dev.append(claimed)
        inter_entries.append((comp.log_size, stacked))
    # one batched device->host pull for every non-zero component's sum
    claimed_np = (
        observe.pull(torch.stack(claimed_dev))
        if claimed_dev
        else np.zeros((0, 4), np.int64)
    )
    claimed_sums = []
    it = iter(claimed_np)
    for ci in range(len(comps.all)):
        claimed_sums.append(
            (0, 0, 0, 0) if ci in zero_claims else tuple(int(x) for x in next(it))
        )
    return claimed_sums, inter_entries


def prove_cairo_m(prover_input, config=REGULAR_96_BITS, timing=None, *,
                  device=DEFAULT_DEVICE, observer=None):
    """Prove ``prover_input`` on ``device`` (a torch device or its name; the
    card unless the caller names another, and an error without one).

    Under ``prover_mesh`` (parallel/sharded.py) this rank proves on its
    share of every stack, on the mesh's device; every rank returns the
    same proof, byte-equal to the single-device proof.

    ``observer``: an object with ``begin(stage, comp)`` and ``end(stage,
    comp, out)``, called around each live component's interaction trace
    (``out`` its stacked limb columns, row order) and composition
    contribution (``out`` its weighted 4-limb evaluations): the per-
    component profile (`cairo_m_tpu_torch.profile components`).

    ``timing``: a dict this fills with the seconds of the phases' spans
    (``trace``, ``interaction``, ``composition``, ``pcs``, ``total``;
    ``poseidon2_witness``, inside ``trace``: the ``poseidon2`` component's
    columns made on the device; under the stwo framing ``host_trees``, its
    ``stwo_host_tree`` spans).  The
    spans go to the active recorder, if any (`observe`); the debug
    switches print from them."""
    device = resolve_device(device)
    mesh = active_mesh()
    if mesh is not None and device != mesh.device:
        raise ValueError(f"device {device}, but this rank's mesh runs on "
                         f"{mesh.device}")
    # under a mesh every stack is held in FFT order (this rank's share):
    # the row-order -> FFT-order steps below are the single device's
    to_fft = domain.to_fft_order if mesh is None else (lambda st: st)
    with observe.proving() as rec, observe.phase("prove") as root:
        with observe.phase("trace") as p_trace:
            with observe.span("public_data", label="public data"):
                channel = config.make_channel()
                config.mix_into(channel)
                public_data = PublicData.new(prover_input)
                public_data.mix_into(channel)
                relations = Relations()
                comps = ComponentSet(relations)
            # each component's rows go to the device the moment they
            # exist; table multiplicities are scatter-adds over those
            # uploaded stacks
            counter = framework.TableCounter(relations, *SCALE.key(), device)
            uploaded = {}

            def _upload(comp):
                dev = getattr(comp, "device_stack", None)
                if dev is not None:
                    # a table's multiplicities, or columns made on the device
                    uploaded[id(comp)] = dev
                    if comp is comps.poseidon2:
                        with observe.span("count", component=comp.name):
                            counter.add(comp, dev)
                    return
                if comp.trace_rows is None or comp.zero_witness:
                    return
                with observe.span("upload", component=comp.name):
                    if mesh is None:
                        st = upload_rows(comp.trace_rows, device)
                    else:
                        st = upload_fft_share(comp.trace_rows, device)
                uploaded[id(comp)] = st
                with observe.span("count", component=comp.name):
                    counter.add(comp, st)

            with observe.span("write_traces", label=(
                    "write_traces (host, uploads pipelined; upload "
                    "{upload:.2f}s count {count:.2f}s)")):
                comps.write_traces(
                    prover_input, on_component=_upload, table_counter=counter,
                    device=device,
                )
            scheme = pcs.CommitmentSchemeProver(channel, config)

            # phase 0: preprocessed (cached; only the root mixing runs per
            # proof)
            with observe.span("commit", phase=0, label="phase0 commit"):
                _, pre_owners = comps.preprocessed_columns()
                scheme.commit_phase(preprocessed_phase(comps, config, device))

            # claim: mix log sizes; phase 1: trace
            with observe.span("commit", phase=1, label="phase1 trace commit"):
                for comp in comps.all:
                    channel.mix_u64(comp.log_size)
                trace_stacks = [
                    torch.zeros(
                        (comp.n_trace_cols, local_len(1 << comp.log_size)),
                        dtype=torch.int64, device=device,
                    )
                    if comp.zero_witness
                    else uploaded[id(comp)]
                    for comp in comps.all
                ]
                # row order, taken to FFT order a group at a time
                scheme.commit(
                    [(comp.log_size, st) for comp, st in zip(comps.all, trace_stacks)],
                    prepare=to_fft,
                )

        with observe.phase("interaction") as p_inter:
            with observe.span("interaction_pow"):
                nonce = channel.grind(INTERACTION_POW_BITS)
                channel.mix_u64(nonce)
            # relations + interaction traces (device tape path; columns
            # stay stacked)
            relations.draw(channel)
            with observe.span("interaction_traces", label="interaction traces"):
                claimed_sums, inter_entries = _interaction_traces(
                    comps, trace_stacks, device, mesh, observer)
            # the row-order trace is read no more: the phases hold its LDE
            del trace_stacks, uploaded
            for comp in comps.all:
                comp.device_stack = None
            channel.mix_felts(claimed_sums)
            with observe.span("commit", phase=2, label="phase2 commit"):
                scheme.commit(inter_entries, prepare=to_fft)
            del inter_entries

        with observe.phase("composition") as p_comp:
            composition_coeff = channel.draw_felt()
            pre_owner_map = {id(c): (s, n) for c, s, n in pre_owners}
            with observe.span("compose", label="composition computed"):
                comp_evals, comp_elog = framework.compute_composition(
                    comps.all, relations,
                    scheme.phases[0], scheme.phases[1], scheme.phases[2],
                    pre_owner_map, claimed_sums, composition_coeff,
                    blowup=config.fri_config.log_blowup_factor,
                    observer=observer,
                )
            # composition is a "trace" of log comp_elog committed with
            # blowup
            with observe.span("commit", phase=3, label="phase3 commit"):
                scheme.commit([(comp_elog, torch.stack(comp_evals))])

        with observe.phase("pcs", label="pcs prove_values") as p_pcs:
            with observe.span("oods"):
                z, z_prevs = oods_point_and_prevs(channel, comps.log_sizes())
                sample_points = build_sample_points(comps, z, z_prevs,
                                                    pre_owners)
            pcs_proof = scheme.prove_values(sample_points)

    if timing is not None:
        timing.update(
            trace=p_trace.seconds, interaction=p_inter.seconds,
            composition=p_comp.seconds, pcs=p_pcs.seconds, total=root.seconds,
            poseidon2_witness=sum(
                s.seconds for s in rec.spans
                if s.name == "poseidon2_witness" and s.root == root.id),
        )
        if config.framing == "stwo":
            # inside the phases above: host stwo tree builds + decommit
            timing["host_trees"] = sum(
                s.seconds for s in rec.spans
                if s.name == "stwo_host_tree" and s.root == root.id)

    return Proof(
        log_sizes=comps.log_sizes(),
        claimed_sums=claimed_sums,
        public_data=public_data,
        interaction_pow_nonce=nonce,
        pcs_proof=pcs_proof,
    )
