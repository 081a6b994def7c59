"""Device kernels the traced step launched, as the profiler counts them."""


def read(run):
    tr = run.get("trace")
    if run.get("kind") != "train" or tr is None or not tr.kernels:
        return None
    return tr.kernels / tr.units
