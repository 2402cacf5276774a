"""The share of the MoE's capacity rows that hold a token in the traced
prefill requests: the port's counters ``moe.pairs_kept`` (the (token,
choice) pairs that found room) over ``moe.slots`` (E x C rows a call,
every one of which the expert products run over)."""
from bench.harness import layers

UNIT, MOVES, KIND = "%", "prefill_tok_s", "prefill"


def read(obs):
    c = layers.counted(obs, KIND, "moe.pairs_kept", "moe.slots")
    return None if c is None else 100.0 * c[0] / c[1]
