"""Device time a decode step spends dequantizing weights: the port's span
``lm.dequant`` (`nn.layers.real` on a quantized leaf: the expert stacks
and MLA's w_uk and w_uv, int8 -> float32, times the scales, -> bf16),
timed on the device by the port, over the traced steps."""
from bench.harness import layers

UNIT, MOVES, KIND = "ms", "decode_tok_s", "decode"
SPAN = "lm.dequant"


def read(obs):
    return layers.span_ms(obs, KIND, SPAN)
