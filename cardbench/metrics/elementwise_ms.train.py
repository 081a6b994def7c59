"""Device ms a traced step in elementwise, copy and reduction kernels,
classed by kernel name (``bounds.KINDS``)."""

from cardbench import readers


def read(run):
    if not readers.is_kind(run, "train"):
        return None
    return readers.kind_ms_per_unit(
        run, ("elementwise and copies", "reductions"))
