"""The Mamba scan calls' least time over the device time under
``repro_torch::mamba_scan`` in the traced cycle, in %."""

from cardbench import readers


def read(run):
    if not readers.is_kind(run, "prefill"):
        return None
    return readers.scan_roofline(run, {"repro_torch::mamba_scan": "forward"})
