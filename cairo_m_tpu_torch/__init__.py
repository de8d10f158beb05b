"""cairo_m_tpu_torch — the Cairo-M prover on PyTorch and CUDA (H100).

Counterpart of ``cairo_m_tpu`` (JAX/XLA/Pallas), which stays the reference:
the same input gives a byte-identical ``Proof.to_json_obj()`` in both
packages.  Module paths mirror the reference (``prover/stark/fft.py`` here
is the counterpart of ``cairo_m_tpu/prover/stark/fft.py``).  The package
stands alone: it imports nothing of ``cairo_m_tpu`` and nothing of JAX, and
keeps its own copies of the host-only modules (compiler, ISA, VM, native VM
core, Fiat-Shamir channels, wasm lowering, tooling) under the same names.

Data types: every field value and hash word on a device is an ``int64``
tensor (M31 values in ``[0, 2^31 - 1)``, BLAKE2s words in ``[0, 2^32)``).
torch has no unsigned 32-bit arithmetic on the CPU, and int64 holds the
product of two M31 values exactly, so the plain torch code needs no limb
tricks.  The CUDA kernels (``csrc/``) read and write int64 and compute in
native unsigned 32/64-bit integers.

The entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, and raise when there is no card: a tensor on the card runs the
CUDA kernels, a tensor on the CPU runs their plain torch versions, and
nothing falls back from one to the other.
"""

__version__ = "0.1.0"
