from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref

__all__ = ["attention_ref", "flash_attention_fwd"]
