"""The Fiat-Shamir channels that cairo_m_tpu_torch keeps as its own copies
(native framing `Blake2sChannel`, stwo framing `StwoBlake2sChannel`) vs the
JAX package's originals: the same script of mixes and draws through both
gives equal felts, queries, bytes and proof-of-work nonce.  Exact equality:
the channels are hashlib and integers.
"""

import numpy as np
import pytest

from cairo_m_tpu.prover.stark.channel import Blake2sChannel as RNative
from cairo_m_tpu.prover.stark.stwo_channel import StwoBlake2sChannel as RStwo
from cairo_m_tpu_torch.prover.stark.channel import Blake2sChannel as TNative
from cairo_m_tpu_torch.prover.stark.stwo_channel import StwoBlake2sChannel as TStwo
from torch_port_helpers import P

PAIRS = {"native": (RNative, TNative), "stwo": (RStwo, TStwo)}


def _script(channel, seed):
    """A transcript the shape of a proof's: every mix and draw the prover
    uses, with values from ``seed``.  -> everything drawn."""
    rng = np.random.default_rng(seed)
    drawn = []
    channel.mix_u64(int(rng.integers(0, 1 << 62)))
    channel.mix_u32s([int(x) for x in rng.integers(0, 1 << 32, size=11)])
    channel.mix_root(bytes(rng.integers(0, 256, size=32, dtype=np.uint8)))
    drawn.append(channel.draw_felt())
    channel.mix_felts([tuple(int(x) for x in rng.integers(0, P, size=4))
                       for _ in range(5)])
    drawn.append(channel.draw_felts(7))
    channel.mix_bytes(bytes(rng.integers(0, 256, size=45, dtype=np.uint8)))
    drawn.append(channel.draw_bytes())
    nonce = channel.grind(6)
    drawn.append(("nonce", nonce, channel.verify_pow(nonce, 6)))
    channel.mix_u64(nonce)
    drawn.append(channel.trailing_zeros())
    drawn.append(channel.draw_queries(8, 9))
    drawn.append(channel.draw_queries(3, 30))
    drawn.append(channel.draw_felt())
    return drawn


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("framing", sorted(PAIRS))
def test_channels_equal(framing, seed):
    reference, port = PAIRS[framing]
    want = _script(reference(), seed)
    assert _script(port(), seed) == want
    queries = want[5]
    assert queries == sorted(set(queries)) and len(queries) == 8
    assert want[3][2] is True


@pytest.mark.parametrize("framing", sorted(PAIRS))
def test_fresh_channels_draw_the_same(framing):
    reference, port = PAIRS[framing]
    assert port().draw_felts(3) == reference().draw_felts(3)
    assert port().draw_bytes() == reference().draw_bytes()


@pytest.mark.parametrize("framing", sorted(PAIRS))
def test_pow_nonce_is_bound_to_the_state(framing):
    _, port = PAIRS[framing]
    a, b = port(), port()
    b.mix_u64(1)
    nonce = a.grind(8)
    assert a.verify_pow(nonce, 8)
    assert a.trailing_zeros() == port().trailing_zeros()  # grind leaves the state
    assert not all(b.verify_pow(n, 8) for n in range(nonce, nonce + 4))
