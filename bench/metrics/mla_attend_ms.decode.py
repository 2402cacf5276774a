"""Device time a decode step spends in MLA's attention core: the port's
span ``lm.mla.attend`` (`nn.attention.mla_apply` after w_uk and w_uv are
read: the compressed cache's write, its float32 copies, the absorbed
einsums, the softmax and o), over the traced steps."""
from bench.harness import layers

UNIT, MOVES, KIND = "ms", "decode_tok_s", "decode"
SPAN = "lm.mla.attend"


def read(obs):
    return layers.span_ms(obs, KIND, SPAN)
