"""A model family defined outside the benchmark's own files, as a later
configuration's would be, to show that one plugs in through the family
lookup alone (`bench.reference.spec.FAMILIES`, where the tests register
it): the tiny grouped-query MoE model of `tiny`, routed by sigmoid scores
(the port's ``MoEConfig.router_softmax`` False), with one more float32
leaf a MoE layer, a selection bias over the experts, which its reference
reads and which moves nothing. It holds the parts of every layer in one
module: the parser and the reference, the leaves drawn and the port's
``ArchConfig``."""
import dataclasses

import torch

from bench.harness import program, weights
from bench.reference import model as R
from bench.reference.spec import ModelSpec
from bench.tests import tiny

MODEL_TYPE = "bench_tests_sigmoid"
BIAS = "moe.e_bias"


@dataclasses.dataclass(frozen=True)
class SigmoidSpec(ModelSpec):
    scoring_func: str = "sigmoid"


CONFIG = {"model_type": MODEL_TYPE, "scoring_func": "sigmoid"}


def spec(cfg: dict, name: str) -> SigmoidSpec:
    base = tiny.GQA_MOE
    if cfg["scoring_func"] != "sigmoid":
        raise ValueError(cfg["scoring_func"])
    kw = {f.name: getattr(base, f.name) for f in dataclasses.fields(base)}
    return SigmoidSpec(**dict(kw, name=name),
                       scoring_func=cfg["scoring_func"])


class Model(R.Model):
    def route(self, logits, r, C, swap=None):
        bias = self.fetch(BIAS, r)
        # the bias is read and adds nothing: the scores pick and weigh
        scores = torch.sigmoid(logits) + 0.0 * bias
        return R.pick(scores, self.s.moe.top_k, C, swap)


ROUTER_STD = 4.0


def add_bias(s):
    """The benchmark's leaves and the bias, in a stream of its own."""
    return weights.leaves.default(s) + [
        weights.Leaf(BIAS, (s.n_moe, s.moe.num_experts), 0.02, True,
                     "bias")]


def leaves(s):
    """`add_bias`, the router drawn at ``ROUTER_STD`` times the benchmark's
    deviation: its logits spread wide, so a softmax weighs a token's two
    experts far otherwise than the sigmoid does."""
    return [leaf._replace(std=ROUTER_STD * leaf.std)
            if leaf.name == "moe.router" else leaf for leaf in add_bias(s)]


def arch(s):
    cfg = program.arch.default(s)
    return dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, router_softmax=False))
