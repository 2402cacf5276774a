"""The training window's share of the card's bf16 peak: three times the
forward's model work of every step (bench.yardstick.work.train_flops; the
remat's second forward not counted) over the window's seconds."""
from bench.yardstick.peaks import BF16_FLOPS

UNIT, MOVES, KIND = "%", "train_tok_s", "train"


def read(obs):
    if obs.get("kind") != KIND or not obs.get("window_s"):
        return None
    return 100.0 * obs["model_flops"] / (obs["window_s"] * BF16_FLOPS)
