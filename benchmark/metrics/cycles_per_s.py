"""VM cycles of every job in the window over the window's seconds (the
window runs from its start to the end of its last job)."""


def read(rec):
    return sum(j["cycles"] for j in rec["jobs"]) / rec["window_s"]
