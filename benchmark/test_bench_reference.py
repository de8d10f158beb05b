"""The plain reference: it accepts the port's proofs, recomputes the
preprocessed commitment the port commits, and rejects a proof changed in
any layer it judges."""

import copy
import hashlib

import numpy as np
import pytest

from benchmark.conftest import SMALL_SCALE, SMALL_SECURITY
from benchmark.reference import commit, verify as V
from benchmark.reference.scale import SecurityConfig, protocol_scale

CFG = SecurityConfig(**SMALL_SECURITY)
P = (1 << 31) - 1


def _verify(obj, cfg=CFG):
    with protocol_scale(**SMALL_SCALE):
        V.verify(obj, cfg)


def test_accepts_the_ports_proof(small_proof):
    _verify(small_proof[0])


def test_preprocessed_roots_equal_the_ports():
    import torch

    from cairo_m_tpu_torch.prover import config as pc
    from cairo_m_tpu_torch.prover.components.registry import ComponentSet
    from cairo_m_tpu_torch.prover.prove import preprocessed_phase
    from cairo_m_tpu_torch.prover.relations import Relations

    from benchmark.reference.components.registry import ComponentSet as RefSet
    from benchmark.reference.relations import Relations as RefRelations

    pc.set_test_scale(**SMALL_SCALE)
    try:
        want = preprocessed_phase(ComponentSet(Relations()), pc.test_config(), torch.device("cpu")).roots()
    finally:
        pc.set_production_scale()
    with protocol_scale(**SMALL_SCALE):
        pre, _ = RefSet(RefRelations()).preprocessed_columns()
        assert commit.commit_roots(pre, 1) == want


def test_one_block_blake2s_equals_hashlib():
    rng = np.random.default_rng(5)
    for n_bytes in (4, 16, 32, 64):
        words = [rng.integers(0, 2**32, 7, dtype=np.uint64).astype(np.uint32)
                 if w < n_bytes // 4 else np.zeros(7, np.uint32) for w in range(16)]
        got = commit.blake2s_one_block(words, n_bytes)
        for lane in range(7):
            msg = b"".join(int(words[w][lane]).to_bytes(4, "little") for w in range(n_bytes // 4))
            want = hashlib.blake2s(msg).digest()
            assert b"".join(int(g[lane]).to_bytes(4, "little") for g in got) == want


def _bump(x):
    return (int(x) + 1) % P


MUTATIONS = {
    "claimed_sum": lambda o: o["claimed_sums"][8].__setitem__(0, _bump(o["claimed_sums"][8][0])),
    "public_output": lambda o: o["public_data"]["output"][0][1].__setitem__(
        0, _bump(o["public_data"]["output"][0][1][0])),
    "trace_sample": lambda o: o["pcs_proof"]["sampled_values"][1][3][0].__setitem__(
        0, _bump(o["pcs_proof"]["sampled_values"][1][3][0][0])),
    "composition_sample": lambda o: o["pcs_proof"]["sampled_values"][3][0][0].__setitem__(
        1, _bump(o["pcs_proof"]["sampled_values"][3][0][0][1])),
    "trace_root": lambda o: o["pcs_proof"]["phase_roots"][1][0].__setitem__(1, "00" * 32),
    "preprocessed_root": lambda o: o["pcs_proof"]["phase_roots"][0][0].__setitem__(1, "11" * 32),
    "fri_last_layer": lambda o: o["pcs_proof"]["fri_proof"]["last_layer"][0].__setitem__(
        0, _bump(o["pcs_proof"]["fri_proof"]["last_layer"][0][0])),
    "fri_sibling": lambda o: o["pcs_proof"]["fri_proof"]["inner_decommitments"][0]["siblings"].__setitem__(
        0, "22" * 32),
    "pow_nonce": lambda o: o["pcs_proof"].__setitem__("pow_nonce", o["pcs_proof"]["pow_nonce"] + 1),
    "log_size": lambda o: o["log_sizes"].__setitem__(8, o["log_sizes"][8] + 1),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_rejects_a_changed_proof(small_proof, name):
    bad = copy.deepcopy(small_proof[0])
    MUTATIONS[name](bad)
    with pytest.raises(V.Rejected):
        _verify(bad)


def test_rejects_a_weaker_configuration(small_proof):
    with pytest.raises(V.Rejected):
        _verify(small_proof[0], SecurityConfig(**dict(SMALL_SECURITY, n_queries=9)))
