"""Flash attention (kernel K5): online-softmax attention, causal and
sliding-window masks, tanh softcap, grouped KV heads."""
from repro_torch.kernels.flash_attention.ops import (  # noqa: F401
    flash_attention, flash_attention_bound, flash_attention_plain,
    takes_wgmma)
from repro_torch.kernels.flash_attention.ref import (  # noqa: F401
    flash_attention_ref, flash_attention_tolerance)

__all__ = ["flash_attention", "flash_attention_bound", "flash_attention_plain",
           "flash_attention_ref", "flash_attention_tolerance", "takes_wgmma"]
