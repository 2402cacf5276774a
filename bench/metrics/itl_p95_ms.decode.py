"""The 95th percentile (nearest rank) of every decode step of the window,
host clock around each step and its tokens' read-back: the time between
two tokens of a request."""
from bench.harness.common import nearest_rank

UNIT, MOVES, KIND = "ms", "decode_tok_s", "decode"


def read(obs):
    if obs.get("kind") != KIND or not obs.get("step_times"):
        return None
    return 1e3 * nearest_rank(obs["step_times"], 0.95)
