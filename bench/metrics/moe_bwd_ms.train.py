"""Device time a training step spends in the MoE layers' backward pass:
the self time of the port's span ``lm.moe.backward``, from the gradient
reaching a layer's output to its reaching the layer's input, less the
block that remat runs again inside it, over the traced steps."""
from bench.harness import layers

UNIT, MOVES, KIND = "ms", "train_tok_s", "train"
SPAN = "lm.moe.backward"


def read(obs):
    return layers.span_ms(obs, KIND, SPAN, own=True)
