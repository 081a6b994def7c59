"""1 - the union of device intervals over the traced step's length, in %."""

from cardbench import readers


def read(run):
    return readers.idle_share(run) if readers.is_kind(run, "train") \
        else None
