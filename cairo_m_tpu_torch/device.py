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
    when it names a CUDA device and none is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device}: no CUDA device is available (pass "
            "device='cpu' to run the plain versions on the CPU)"
        )
    return device
