"""The decode window's share of the card's bf16 peak: the model's work
(bench.yardstick.work.decode_flops: every weight product of each served
token, MLA's absorbed attention over the cache) over the window's seconds."""
from bench.yardstick.peaks import BF16_FLOPS

UNIT, MOVES, KIND = "%", "decode_tok_s", "decode"


def read(obs):
    if obs.get("kind") != KIND or not obs.get("window_s"):
        return None
    return 100.0 * obs["model_flops"] / (obs["window_s"] * BF16_FLOPS)
