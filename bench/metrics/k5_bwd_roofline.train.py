"""K5's backward (kernels/flash_attention, csrc/flash_attention_bwd.cu)
against its roofline in the traced training steps: the least time of each
layer's backward (bench.yardstick.kernels.k5_backward_bound_s: the five
products, each tensor moved once) over the device time of the backward's
kernels."""
import re

UNIT, MOVES, KIND = "%", "train_tok_s", "train"
KERNELS = (r"\bdelta_kernel\b", r"\bdkdv_kernel\b", r"\bdq_kernel\b",
           r"\bdkdv_wgmma2?_kernel\b", r"\bdq_wgmma2?_kernel\b",
           r"\bsum_split_kernel\b")
_RX = re.compile("|".join(KERNELS))


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != KIND or tr is None or "k5_bwd_bound_s" not in obs:
        return None
    t = tr.kernel_s(lambda name: _RX.search(name) is not None)
    return 100.0 * obs["k5_bwd_bound_s"] / t if t else None
