"""The prover's debug switches, counterparts of the JAX package's.

- ``CM_DEBUG_PHASES``: one labelled line a prover phase
  (``[prove +S.SSs] label``, seconds since the prove began) from
  `prove.prove_cairo_m`, and one a step of the polynomial commitment
  (``  [pcs +S.SSs] label``, seconds since the previous step) from
  `pcs.CommitmentSchemeProver.prove_values`.  Wall seconds with no device
  sync: a step that only queues device work reads short and the next step
  pays for it.
- ``CM_DEBUG_MICRO``: per-piece wall seconds after a device sync
  (``torch.cuda.synchronize`` on a card; the CPU needs none) of each
  commit's LDE and Merkle tree (leaves, pyramid, the host mirror of the
  tops), the stwo host tree, and FRI's first fold and each layer.  The
  syncs serialise the pipeline, so the totals under this switch exceed the
  prover's wall time: use it to attribute time, not to measure it.

Both are read when the prover runs, not when a module is imported, so a
caller (or a test) can set them for one proof.  Neither changes a byte of
the proof.
"""

from __future__ import annotations

import os
import time

import torch


def phases_on() -> bool:
    return bool(os.environ.get("CM_DEBUG_PHASES"))


def micro_on() -> bool:
    return bool(os.environ.get("CM_DEBUG_MICRO"))


def sync(device):
    """Wait for the work queued on ``device`` (a card); the CPU runs
    eagerly and needs no wait."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Micro:
    """``CM_DEBUG_MICRO`` lines of one stage: `mark(label)` syncs the
    device and prints the seconds since the previous mark (or since the
    stage began: the device is synced there too, so that work queued
    before the stage is not charged to its first piece) as
    ``    [tag +S.SSSs] label``.  Does nothing, and syncs nothing, when the
    switch is off."""

    def __init__(self, tag: str, device):
        self.on = micro_on()
        self.tag = tag
        self.device = device
        if self.on:
            sync(device)
        self.t = time.time()

    def mark(self, label: str):
        if not self.on:
            return
        sync(self.device)
        now = time.time()
        print(f"    [{self.tag} +{now - self.t:6.3f}s] {label}", flush=True)
        self.t = now
