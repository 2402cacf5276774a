"""Kernels launched a decode step: the profiler's device kernels (copies and
fills left out) over the traced steps."""
UNIT, MOVES, KIND = "count", "decode_tok_s", "decode"
NOT_KERNELS = ("Memcpy", "Memset")


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != KIND or tr is None or not obs.get("traced_steps"):
        return None
    n = tr.kernel_count(lambda name: not name.startswith(NOT_KERNELS))
    return n / obs["traced_steps"] if n else None
