from repro_torch.models.model import (
    decode_step,
    forward,
    init_cache,
    init_params,
    param_count,
    prefill,
)

__all__ = ["decode_step", "forward", "init_cache", "init_params",
           "param_count", "prefill"]
