"""K5's forward (kernels/flash_attention) against its roofline in the
traced prefill requests: the least time of every causal attention layer at
MLA's shape, v counted at its own head_dim (bench.yardstick.kernels.
k5_forward_bound_s), over the device time of K5's forward kernels."""
import re

UNIT, MOVES, KIND = "%", "prefill_tok_s", "prefill"
KERNELS = (r"\bflash_kernel\b", r"\bflash_wgmma_kernel\b")
_RX = re.compile("|".join(KERNELS))


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != KIND or tr is None or "k5_bound_s" not in obs:
        return None
    t = tr.kernel_s(lambda name: _RX.search(name) is not None)
    return 100.0 * obs["k5_bound_s"] / t if t else None
