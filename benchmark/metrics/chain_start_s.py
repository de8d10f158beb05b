"""Mean seconds a window chain spends outside its busiest worker's proofs
and verifications: the chain's wall time less the largest per-worker sum
of ``prove_s + verify_s`` (process start, CUDA context, the program
compiled, the VM and inputs of the whole chain, the proofs written and
collected, the root check).  In a traced run what opening and flushing
the workers' traces cost (``trace_overhead_s``, the most any worker
paid) is left out too."""

from benchmark.chain import by_worker


def _start(job):
    busiest = max(sum(s["prove_s"] + s["verify_s"] for s in segs)
                  for segs in by_worker(job).values())
    return job["wall_s"] - job.get("trace_overhead_s", 0.0) - busiest


def read(rec):
    jobs = [j for j in rec.get("jobs", []) if "segments" in j]
    if not jobs:
        return None
    return sum(map(_start, jobs)) / len(jobs)
