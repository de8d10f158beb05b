"""Share, in %, of the window's segment work that the workers spend
verifying their own proofs: the sum of ``verify_s`` over the sum of
``prove_s + verify_s``, over every segment of the window's chains."""


def read(rec):
    segs = [s for j in rec.get("jobs", []) for s in j.get("segments", [])]
    if not segs:
        return None
    return 100.0 * sum(s["verify_s"] for s in segs) / sum(s["prove_s"] + s["verify_s"] for s in segs)
