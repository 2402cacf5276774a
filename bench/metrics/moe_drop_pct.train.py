"""The share of routed (token, choice) pairs the MoE drops for want of
capacity in the traced training steps: one less the port's counter
``moe.pairs_kept`` over ``moe.pairs`` (the forward and remat's recompute
both count, alike)."""
from bench.harness import layers

UNIT, MOVES, KIND = "%", "train_tok_s", "train"


def read(obs):
    c = layers.counted(obs, KIND, "moe.pairs", "moe.pairs_kept")
    return None if c is None else 100.0 * (c[0] - c[1]) / c[0]
