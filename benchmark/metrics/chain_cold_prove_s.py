"""Seconds a fresh segment worker's first proof costs beyond its later
ones (plans, host inverses, the preprocessed commitment): for each worker
of each window chain, its first ``prove_s`` less the mean of its later
full segments' (the short last segment left out), averaged over the
workers that have a later full segment."""

from benchmark.chain import by_worker


def read(rec):
    cold = []
    for j in rec.get("jobs", []):
        if "segments" not in j:
            continue
        full = max(s["n_steps"] for s in j["segments"])
        for first, *later in by_worker(j).values():
            later = [s["prove_s"] for s in later if s["n_steps"] == full]
            if later:
                cold.append(first["prove_s"] - sum(later) / len(later))
    return sum(cold) / len(cold) if cold else None
