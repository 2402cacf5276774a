"""K2 (kernels/quant_matmul) against its roofline in the traced decode
steps: the least time of every K2 product of the steps (bench.yardstick.
kernels.k2_step_bound_s: x, int8 payload, scales and y moved once, 2MKN
operations) over the device time of K2's kernels."""
import re

UNIT, MOVES, KIND = "%", "decode_tok_s", "decode"
KERNELS = (r"\bqmm_kernel\b", r"\bqmm_wide_kernel\b")
_RX = re.compile("|".join(KERNELS))


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != KIND or tr is None or "k2_bound_s" not in obs:
        return None
    t = tr.kernel_s(lambda name: _RX.search(name) is not None)
    return 100.0 * obs["k2_bound_s"] / t if t else None
