"""The share of the traced stretch in which no kernel, copy or fill ran on
the card: one less the union of the profiler's device intervals over the
stretch's wall time."""
UNIT, MOVES, KIND = "%", "decode_tok_s", "decode"


def read(obs):
    tr = obs.get("trace")
    if obs.get("kind") != KIND or tr is None or not tr.window_s \
            or not tr.kernel_count():
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
