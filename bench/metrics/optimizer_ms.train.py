"""Device time a training step spends in the optimizer: the port's span
``train.optimizer`` (`train.train_state`: `adamw_update_` over every
parameter), over the traced steps."""
from bench.harness import layers

UNIT, MOVES, KIND = "ms", "train_tok_s", "train"
SPAN = "train.optimizer"


def read(obs):
    return layers.span_ms(obs, KIND, SPAN)
