"""Mean seconds a window job spends in the native VM and the adapter
(the harness's span around ``native_prover_input``)."""


def read(rec):
    return sum(j["vm_adapter_s"] for j in rec["jobs"]) / len(rec["jobs"])
