"""The device rule of the package's entry points.

Every entry point (``prove_cairo_m``, ``verify_cairo_m``, the segment
workers, the command line) runs on the card unless the caller names another
device, and asking for the card where there is none is an error: nothing
moves to the CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (a torch device or its name) as a torch.device; raises
    when it names a CUDA device and none is available, or a card index
    (``cuda:k``) beyond the machine's cards."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (pass "
            "device='cpu' to run the plain versions on the CPU)"
        )
    if device.type == "cuda" and device.index is not None:
        count = torch.cuda.device_count()
        if device.index >= count:
            raise RuntimeError(
                f"device {device}: this machine has {count} CUDA "
                f"card{'s' if count != 1 else ''} (cuda:0 .. cuda:{count - 1})"
            )
    return device


def use_device(device=DEFAULT_DEVICE) -> torch.device:
    """`resolve_device`, and where that is a card, make it the process's
    current card and name its index.  A process that runs on ``cuda:k``
    calls this before it allocates anything, so that nothing it does (a
    stream, an event, a synchronisation) makes a context on another card."""
    device = resolve_device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    return device
