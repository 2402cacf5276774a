"""The decode window's share of the card's memory bandwidth: the bytes each
step must read (bench.yardstick.work.decode_bytes: int8 payloads and
scales, the other leaves, the cache up to the step's position) over the
window's seconds."""
from bench.yardstick.peaks import HBM_BYTES_PER_S

UNIT, MOVES, KIND = "%", "decode_tok_s", "decode"


def read(obs):
    if obs.get("kind") != KIND or not obs.get("window_s"):
        return None
    return 100.0 * obs["model_bytes"] / (obs["window_s"] * HBM_BYTES_PER_S)
