"""Mean seconds of the prover's ``pcs`` phase a window job (the program's
``timing``: out-of-domain samples, quotients, FRI, decommitment)."""


def read(rec):
    return sum(j["phases"]["pcs"] for j in rec["jobs"]) / len(rec["jobs"])
