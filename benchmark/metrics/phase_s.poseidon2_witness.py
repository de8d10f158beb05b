"""Mean seconds a window job's proof spends making the ``poseidon2``
component's witness on the card (the program's ``timing``:
``poseidon2_witness``, inside the ``trace`` phase, the device synced at
its end).  Nothing to read where the program's ``timing`` has no such
entry."""


def read(rec):
    jobs = rec.get("jobs") or []
    if not jobs or any("poseidon2_witness" not in j["phases"] for j in jobs):
        return None
    return sum(j["phases"]["poseidon2_witness"] for j in jobs) / len(jobs)
