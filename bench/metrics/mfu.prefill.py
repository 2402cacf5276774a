"""The prefill window's share of the card's bf16 peak: the model's work of
each prompt (bench.yardstick.work.prefill_flops: causal attention, the LM
head at the last position only) over the window's seconds."""
from bench.yardstick.peaks import BF16_FLOPS

UNIT, MOVES, KIND = "%", "prefill_tok_s", "prefill"


def read(obs):
    if obs.get("kind") != KIND or not obs.get("window_s"):
        return None
    return 100.0 * obs["model_flops"] / (obs["window_s"] * BF16_FLOPS)
