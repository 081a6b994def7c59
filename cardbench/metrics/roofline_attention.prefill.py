"""The flash-attention calls' least time over the device time under
``repro_torch::flash_attention`` in the traced cycle, in %."""

from cardbench import readers


def read(run):
    if not readers.is_kind(run, "prefill"):
        return None
    return readers.attention_roofline(
        run, {"repro_torch::flash_attention": "forward"})
