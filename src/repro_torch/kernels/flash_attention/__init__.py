"""Flash attention (kernel K5): online-softmax attention, causal and
sliding-window masks, tanh softcap, grouped KV heads; its backward kernel
gives the gradient on CUDA."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    FlashAttentionFn, bwd_head_split, bwd_smem_bytes, flash_attention,
    flash_attention_bound, flash_attention_bwd, flash_attention_plain,
    flash_attention_with_lse, takes_wgmma, takes_wgmma_bwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_bwd_plain, flash_attention_bwd_tolerance,
    flash_attention_lse_plain, flash_attention_lse_tolerance,
    flash_attention_ref, flash_attention_tolerance)

__all__ = ["FlashAttentionFn", "bwd_head_split", "bwd_smem_bytes",
           "flash_attention", "flash_attention_bound",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_bwd_tolerance", "flash_attention_lse_plain",
           "flash_attention_lse_tolerance", "flash_attention_plain",
           "flash_attention_ref", "flash_attention_tolerance",
           "flash_attention_with_lse", "takes_wgmma", "takes_wgmma_bwd"]
