"""The flash-attention calls' least time over the device time under
``repro_torch::flash_attention_train`` and ``flash_attention_backward``
in the traced step, in %."""

from cardbench import readers


def read(run):
    if not readers.is_kind(run, "train"):
        return None
    return readers.attention_roofline(
        run, {"repro_torch::flash_attention_train": "train",
              "repro_torch::flash_attention_backward": "backward"})
