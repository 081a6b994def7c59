from .transformer import (decode_step, forward_train, hidden_states,
                          init_decode_cache, init_params, lm_head_weight,
                          prefill)

__all__ = ["decode_step", "forward_train", "hidden_states",
           "init_decode_cache", "init_params", "lm_head_weight", "prefill"]
