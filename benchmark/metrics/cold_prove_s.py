"""Seconds of the set-up's cold proof, from ``prove_cairo_m`` to the
device sync (plan recording, preprocessed commitment, twiddles)."""


def read(rec):
    return rec["cold_prove_s"]
