from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.ref import attention_ref, ssd_chunk_ref
from repro_torch.kernels.ssd_scan import ssd_chunk_fwd

__all__ = ["attention_ref", "flash_attention_fwd", "ssd_chunk_fwd",
           "ssd_chunk_ref"]
