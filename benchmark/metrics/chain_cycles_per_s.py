"""VM cycles of the window's chains over the window's seconds: the
chain cell's rate, kept per layer since one chain fills the window and
its runs spread wider than any bound allows (PERF.md section 2).  In a
traced run the workers' traces slow the chain, and the rate reads
lower than untraced."""


def read(rec):
    jobs = [j for j in rec.get("jobs", []) if "segments" in j]
    if not jobs:
        return None
    return sum(j["cycles"] for j in jobs) / rec["window_s"]
