from .transformer import (decode_step, init_decode_cache, init_params,
                          lm_head_weight, prefill)

__all__ = ["decode_step", "init_decode_cache", "init_params",
           "lm_head_weight", "prefill"]
