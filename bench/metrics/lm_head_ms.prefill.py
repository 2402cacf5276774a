"""Device time a prefill request spends in the LM head: the port's span
``lm.head`` (`nn.transformer._lm_head`: the head's product over every
position, its float32 cast and the softcap), over the traced requests."""
from bench.harness import layers

UNIT, MOVES, KIND = "ms", "prefill_tok_s", "prefill"
SPAN = "lm.head"


def read(obs):
    return layers.span_ms(obs, KIND, SPAN)
