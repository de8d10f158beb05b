"""Mean seconds of the prover's ``trace`` phase a window job (the
program's ``timing``: host witness, upload, trace commitment)."""


def read(rec):
    return sum(j["phases"]["trace"] for j in rec["jobs"]) / len(rec["jobs"])
