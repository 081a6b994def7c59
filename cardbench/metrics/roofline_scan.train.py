"""The Mamba scan calls' least time over the device time under
``repro_torch::mamba_scan_train`` and ``mamba_scan_backward`` in the
traced step, in %."""

from cardbench import readers


def read(run):
    if not readers.is_kind(run, "train"):
        return None
    return readers.scan_roofline(
        run, {"repro_torch::mamba_scan_train": "train",
              "repro_torch::mamba_scan_backward": "backward"})
