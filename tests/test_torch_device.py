"""The device rule of cairo_m_tpu_torch (device.py), on the CPU: a card
that is not there raises by name, before anything is allocated, and
`use_device` makes a card current and names its index.  Availability and
the card count are patched, so no card is needed."""

import pytest
import torch

from cairo_m_tpu_torch.device import resolve_device, use_device


@pytest.fixture
def cards(monkeypatch):
    """A machine with ``n`` cards: -> set_cards(n); the cards made current
    are recorded in ``set_cards.current``."""

    def set_cards(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: n > 0)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)

    set_cards.current = []
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: set_cards.current.append(torch.device(d)))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    return set_cards


@pytest.mark.parametrize("name, count", [("cuda:4", 4), ("cuda:1", 1),
                                         ("cuda:2", 2)])
def test_a_card_beyond_the_count_raises_by_name(cards, name, count):
    cards(count)
    with pytest.raises(RuntimeError, match=f"device {name}: this machine has "
                       f"{count} CUDA card"):
        resolve_device(name)
    with pytest.raises(RuntimeError, match=f"device {name}"):
        use_device(name)
    assert cards.current == []


def test_no_card_raises_and_the_cpu_stays_the_cpu(cards):
    cards(0)
    for name in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="no CUDA device is available"):
            resolve_device(name)
    assert resolve_device("cpu") == torch.device("cpu")
    assert use_device("cpu") == torch.device("cpu")
    assert cards.current == []


def test_use_device_makes_the_card_current(cards):
    cards(4)
    assert resolve_device("cuda:3") == torch.device("cuda:3")
    assert use_device("cuda:3") == torch.device("cuda:3")
    # an unnumbered card is the current one, named
    assert use_device("cuda") == torch.device("cuda:1")
    assert cards.current == [torch.device("cuda:3"), torch.device("cuda:1")]
