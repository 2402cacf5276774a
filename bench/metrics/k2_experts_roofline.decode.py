"""K2's expert body (kernels/quant_matmul, `quant_matmul_experts`) against
its roofline in the traced decode steps: the least time of its launches
(bench.yardstick.kernels.k2_experts_step_bound_s: each int8 stack and its
scales read once, x and y moved once at the step's capacity C, 2ECKN
operations) over the device time of its kernel."""
import re

UNIT, MOVES, KIND = "%", "decode_tok_s", "decode"
KERNELS = (r"\bqmm_experts_kernel\b",)
_RX = re.compile("|".join(KERNELS))


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != KIND or tr is None \
            or "k2_experts_bound_s" not in obs:
        return None
    t = tr.kernel_s(lambda name: _RX.search(name) is not None)
    return 100.0 * obs["k2_experts_bound_s"] / t if t else None
