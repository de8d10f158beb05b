"""verify_cairo_m: transcript replay + checks (reference verifier.rs:17-95).

Checks, in order:
- interaction PoW has >= INTERACTION_POW_BITS trailing zeros;
- global LogUp balance: PublicData.initial_logup_sum + sum(claimed) == 0;
- composition identity at the OODS point (constraints from sampled masks);
- PCS/FRI/Merkle/PoW query verification.

The preprocessed phase commitment is *recomputed* by the verifier (it is a
deterministic function of the protocol) and compared to the proof's roots;
that recomputation runs on the torch device the caller names.  Every other
check is host arithmetic.  Counterpart of ``cairo_m_tpu.prover.verify``.
"""

from __future__ import annotations

import torch

from .components.registry import ComponentSet
from .config import REGULAR_96_BITS
from .prove import Proof, build_sample_points, oods_point_and_prevs, preprocessed_phase
from .relations import INTERACTION_POW_BITS, Relations
from .stark import framework, pcs
from .stark.fri import QZERO, qscalar_add, qscalar_mul

P = (1 << 31) - 1


class VerificationError(Exception):
    pass


def verify_cairo_m(proof: Proof, config=REGULAR_96_BITS, *, device) -> bool:
    """Verify ``proof``; raises VerificationError on the first failed check.
    ``device`` (a torch device or its name) recomputes the preprocessed
    commitment."""
    channel = config.make_channel()
    config.mix_into(channel)
    proof.public_data.mix_into(channel)

    relations = Relations()
    comps = ComponentSet(relations)
    if len(proof.log_sizes) != len(comps.all):
        raise VerificationError("wrong number of components")
    for comp, l in zip(comps.all, proof.log_sizes):
        if comp.n_preprocessed_cols:
            if comp.log_size != l:
                raise VerificationError(f"{comp.name}: fixed log_size mismatch")
        comp.log_size = l

    scheme = pcs.CommitmentSchemeVerifier(channel, config)

    # phase 0: preprocessed (recomputed expectation)
    expected = preprocessed_phase(comps, config, torch.device(device)).roots()
    if proof.pcs_proof.phase_roots[0] != expected:
        raise VerificationError("preprocessed commitment mismatch")
    pre_cols_meta, pre_owners = comps.preprocessed_columns()
    scheme.commit(proof.pcs_proof.phase_roots[0], [l for l, _ in pre_cols_meta])

    # claim + phase 1
    for comp in comps.all:
        channel.mix_u64(comp.log_size)
    trace_logs = []
    for comp in comps.all:
        trace_logs += [comp.log_size] * comp.n_trace_cols
    scheme.commit(proof.pcs_proof.phase_roots[1], trace_logs)

    # interaction PoW
    if not channel.verify_pow(proof.interaction_pow_nonce, INTERACTION_POW_BITS):
        raise VerificationError("interaction PoW failed")
    channel.mix_u64(proof.interaction_pow_nonce)

    relations.draw(channel)

    # logup balance
    total = proof.public_data.initial_logup_sum(relations)
    for c in proof.claimed_sums:
        total = qscalar_add(total, tuple(c))
    if total != QZERO:
        raise VerificationError(f"LogUp sum does not balance: {total}")

    channel.mix_felts(proof.claimed_sums)
    inter_logs = []
    for comp in comps.all:
        inter_logs += [comp.log_size] * (4 * comp.n_interaction_cols())
    scheme.commit(proof.pcs_proof.phase_roots[2], inter_logs)

    composition_coeff = channel.draw_felt()
    comp_elog = max(c.log_size for c in comps.all) + config.fri_config.log_blowup_factor
    scheme.commit(proof.pcs_proof.phase_roots[3], [comp_elog] * 4)

    z, z_prevs = oods_point_and_prevs(channel, [c.log_size for c in comps.all])
    sample_points = build_sample_points(comps, z, z_prevs, pre_owners)

    # composition identity at z
    sampled = proof.pcs_proof.sampled_values
    # slice phase 1 (trace) and phase 2 (interaction) per component
    sampled_trace, sampled_inter, sampled_pre = [], [], []
    ti = 0
    for comp in comps.all:
        sampled_trace.append(sampled[1][ti : ti + comp.n_trace_cols])
        ti += comp.n_trace_cols
    ii = 0
    for comp in comps.all:
        n_limbs = 4 * comp.n_interaction_cols()
        sampled_inter.append(sampled[2][ii : ii + n_limbs])
        ii += n_limbs
    pre_owner_map = {id(c): (s, n) for c, s, n in pre_owners}
    for comp in comps.all:
        if comp.n_preprocessed_cols:
            s, n = pre_owner_map[id(comp)]
            sampled_pre.append(sampled[0][s : s + n])
        else:
            sampled_pre.append([])

    z_vanishing = [
        framework.vanishing_at_qpoint(comp.log_size, z) for comp in comps.all
    ]
    expected_comp = framework.evaluate_at_point(
        comps.all,
        sampled_trace,
        sampled_inter,
        proof.claimed_sums,
        composition_coeff,
        z_vanishing,
        sampled_pre,
    )
    basis = [(1, 0, 0, 0), (0, 1, 0, 0), (0, 0, 1, 0), (0, 0, 0, 1)]
    comp_at_z = QZERO
    for k in range(4):
        comp_at_z = qscalar_add(
            comp_at_z, qscalar_mul(tuple(sampled[3][k][0]), basis[k])
        )
    if comp_at_z != expected_comp:
        raise VerificationError("composition polynomial mismatch at OODS point")

    # PCS / FRI / queries
    if not scheme.verify_values(sample_points, proof.pcs_proof):
        raise VerificationError("PCS verification failed")
    return True
