"""Device kernels a train step in the traced calls."""


def read(run):
    t = run.trace_summary
    if not t or not t.get("steps"):
        return None
    return t["n_kernels"] / t["steps"]
