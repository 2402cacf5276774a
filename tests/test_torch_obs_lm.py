"""The port's LM path under its tracing (`repro_torch.obs.trace`,
`repro_torch.obs.metrics`), on the CPU at tiny sizes.

* Under a CPU `torch.profiler`, a deepseek-v2-shaped decode (MLA, MoE, w8
  expert stacks) and a phi3.5-moe-shaped training step (GQA, MoE, remat)
  emit every span of the model layer and the optimizer, nested as
  designed (``lm.dequant`` inside ``lm.moe.experts`` inside ``lm.block``
  where the capacity reaches K2's `wgmma_min_m` and the stacks are
  dequantized; below it they are read as stored and no ``lm.dequant``
  opens), as plain ranges, never user annotations (which Kineto would
  copy onto the device's timeline). Remat's recompute opens each block's
  spans a second time, inside ``lm.moe.backward``.
* `SpanClock` folds nested spans into per-name time and self time.
* ``moe.pairs_kept`` is `route_tokens`' ``keep.sum()`` summed over its
  calls, held on the device and read with one ``.item()``; a tensor
  increment snapshots and restores as an int.
* Outputs and gradients are bit-identical with tracing on and off, and
  the profiler alone leaves `prof.profiling` False.
"""
import collections
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ARCHS
from repro_torch.nn import moe as M
from repro_torch.nn import transformer as T
from repro_torch.obs import metrics as MT
from repro_torch.obs import prof as PF
from repro_torch.obs import trace as TR
from repro_torch.serve import quantized as QS
from repro_torch.train import losses
from repro_torch.train.optimizer import (AdamWConfig, tree_leaves,
                                         tree_unflatten)
from repro_torch.train.train_state import init_state, make_train_step

MODEL_SPANS = {"lm.block", "lm.mla.attend", "lm.moe.route", "lm.moe.dispatch",
               "lm.moe.experts", "lm.moe.combine", "lm.moe.shared",
               "lm.dequant", "lm.head"}
TRAIN_SPANS = {"lm.block", "lm.attn.attend", "lm.moe.route",
               "lm.moe.dispatch", "lm.moe.experts", "lm.moe.combine",
               "lm.head", "lm.moe.backward", "lm.block.backward",
               "lm.head.backward", "train.optimizer"}


@contextlib.contextmanager
def _fresh():
    """No JSONL tracer, and the span clock and the registry emptied."""
    prev, TR._tracer = TR._tracer, None
    TR.SPANS.reset()
    MT.REGISTRY.reset()
    try:
        yield
    finally:
        TR._tracer = prev
        TR.SPANS.reset()
        MT.REGISTRY.reset()


# the capacity factor at which `_decode`'s 16 tokens give each of the 4
# experts C = 256 rows, K2's `wgmma_min_m` for int8: the stacks are
# dequantized (the default 1.25 gives C = 10, K2's expert body)
PAST_THRESHOLD = 32.0


def _deepseek(capacity_factor=None):
    """deepseek-v2 reduced (a dense MLA layer, then 2 MoE layers of 4
    experts, top 2, shared experts), d_model 128 so the expert stacks
    quantize, at w8; ``capacity_factor`` replaces the config's."""
    cfg = ARCHS["deepseek-v2-236b"].reduced(d_model=128)
    if capacity_factor is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity_factor))
    params = T.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    return cfg, QS.quantize_params(params, 8)


def _decode(cfg, q):
    state = T.init_decode_state(cfg, 2, 16, cfg.dtype, device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    logits, _ = T.decode_step(q, state, tok, cfg)
    return logits


def _phimoe():
    cfg = ARCHS["phi3.5-moe-42b-a6.6b"].reduced()
    state = init_state(torch.Generator().manual_seed(0), cfg, AdamWConfig(),
                       device="cpu")
    tok = torch.randint(0, cfg.vocab_size, (2, 16),
                        generator=torch.Generator().manual_seed(2))
    return cfg, state, {"tokens": tok}


def _program_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.name().startswith(("lm.", "train."))]


def _inside(a, b) -> bool:
    return b.start_ns() <= a.start_ns() and \
        a.start_ns() + a.duration_ns() <= b.start_ns() + b.duration_ns()


def test_decode_emits_every_model_span_nested():
    cfg, q = _deepseek(PAST_THRESHOLD)
    with _fresh():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _decode(cfg, q)
        times = TR.SPANS.totals()
        counters = MT.snapshot()["counters"]
    ev = _program_events(prof)
    names = collections.Counter(e.name() for e in ev)
    assert set(names) == MODEL_SPANS
    assert names["lm.block"] == 3 and names["lm.head"] == 1
    assert names["lm.moe.experts"] == 2 and names["lm.dequant"] == 6
    assert not any(e.is_user_annotation() for e in ev)
    by = collections.defaultdict(list)
    for e in ev:
        by[e.name()].append(e)
    for e in by["lm.dequant"]:
        (outer,) = [x for x in by["lm.moe.experts"] if _inside(e, x)]
        assert any(_inside(outer, b) for b in by["lm.block"])
    for name in MODEL_SPANS - {"lm.head", "lm.block"}:
        assert all(any(_inside(e, b) for b in by["lm.block"])
                   for e in by[name]), name
    assert set(times) == MODEL_SPANS
    assert times["lm.block"]["calls"] == 3
    assert times["lm.dequant"]["self_s"] == times["lm.dequant"]["s"] > 0
    # a block's self time leaves out its children's
    kids = sum(times[n]["s"] for n in MODEL_SPANS
               if n not in ("lm.block", "lm.head", "lm.dequant"))
    assert times["lm.block"]["self_s"] == pytest.approx(
        times["lm.block"]["s"] - kids, rel=1e-9, abs=1e-9)
    assert counters["moe.pairs"] == 2 * 16 * 2
    assert counters["moe.slots"] == 2 * 4 * 256
    assert 0 < counters["moe.pairs_kept"] <= counters["moe.pairs"]


def test_decode_below_the_threshold_opens_no_dequant_span(monkeypatch):
    """At the decode's C = 10 the w8 stacks go through K2's expert body,
    three calls a MoE layer: every model span but ``lm.dequant``."""
    cfg, q = _deepseek()
    calls = []
    real = M.quant_matmul_experts
    monkeypatch.setattr(M, "quant_matmul_experts",
                        lambda x, w, s: calls.append(x.shape) or real(x, w,
                                                                      s))
    with _fresh():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _decode(cfg, q)
        times = TR.SPANS.totals()
    names = collections.Counter(e.name() for e in _program_events(prof))
    assert set(names) == set(times) == MODEL_SPANS - {"lm.dequant"}
    assert names["lm.moe.experts"] == 2 and len(calls) == 2 * 3
    assert {tuple(c[:2]) for c in calls} == {(4, 10)}


def test_training_step_spans_and_remat_recompute():
    cfg, state, batch = _phimoe()
    step = make_train_step(cfg, AdamWConfig(), remat=True)
    with _fresh():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            step(state, batch)
        times = TR.SPANS.totals()
    ev = _program_events(prof)
    names = collections.Counter(e.name() for e in ev)
    n_blocks = sum(s.repeats * len(s.pattern) for s in cfg.segments)
    assert set(names) == TRAIN_SPANS
    # the forward's blocks, then remat's recompute of each
    assert names["lm.block"] == 2 * n_blocks
    assert names["lm.moe.route"] == 2 * n_blocks
    assert names["lm.moe.backward"] == names["lm.block.backward"] == n_blocks
    assert names["train.optimizer"] == names["lm.head.backward"] == 1
    bwd = [e for e in ev if e.name() == "lm.moe.backward"]
    recomputed = [b for b in ev if b.name() == "lm.block"
                  and any(_inside(b, w) for w in bwd)]
    assert len(recomputed) == n_blocks
    for w in bwd:
        assert any(_inside(w, b) for b in ev
                   if b.name() == "lm.block.backward")
    t = times["lm.moe.backward"]
    assert t["calls"] == n_blocks and 0 < t["self_s"] < t["s"]
    assert t["root_s"] == 0.0 and times["lm.block.backward"]["root_s"] > 0
    # the block's backward holds the MoE's, which holds the recompute
    b = times["lm.block.backward"]
    assert b["self_s"] == pytest.approx(b["s"] - t["s"], abs=1e-9)


def test_span_clock_self_time():
    clock = TR.SpanClock()
    a = clock.open("a")
    b = clock.open("b")
    clock.close(b)
    c = clock.open("c")
    clock.close(c)
    clock.close(a)
    t = clock.totals()
    assert {k: v["calls"] for k, v in t.items()} == {"a": 1, "b": 1, "c": 1}
    assert t["a"]["self_s"] == pytest.approx(
        t["a"]["s"] - t["b"]["s"] - t["c"]["s"], abs=1e-12)
    assert t["b"]["self_s"] == t["b"]["s"]
    clock.reset()
    assert clock.totals() == {}


def test_pairs_kept_is_keep_summed_with_one_item(monkeypatch):
    cfg, q = _deepseek()
    p = T._unbind(q["segments"][1][0])[0]["moe"]
    gen = torch.Generator().manual_seed(3)
    xs = [torch.randn(12, cfg.d_model, generator=gen) for _ in range(2)]
    with _fresh():
        with profile(activities=[ProfilerActivity.CPU]):
            rs = [M.route_tokens(p, x, cfg) for x in xs]
        items = []
        real_item = torch.Tensor.item
        monkeypatch.setattr(torch.Tensor, "item",
                            lambda self: items.append(1) or real_item(self))
        kept = MT.counter("moe.pairs_kept").value
        assert len(items) == 1
        assert MT.counter("moe.pairs_kept").value == kept
        assert len(items) == 1
        monkeypatch.undo()
    assert kept == sum(int(r["keep"].sum()) for r in rs)


def test_counter_tensor_increments_snapshot_and_restore():
    reg = MT.MetricsRegistry()
    c = reg.counter("n")
    c.inc(2)
    c.inc(torch.tensor(5))
    c.inc(torch.tensor(True).sum())
    snap = reg.snapshot()
    assert snap["counters"] == {"n": 8}
    c.inc(torch.tensor(4))
    other = MT.MetricsRegistry()
    other.restore(snap)
    assert other.snapshot() == snap and c.value == 12
    for _ in range(MT.PENDING_MAX + 3):         # folded on the device
        c.inc(torch.tensor(1))
    assert len(c._pending) < MT.PENDING_MAX
    assert c.value == 12 + MT.PENDING_MAX + 3


def test_outputs_and_gradients_bit_identical_traced(tmp_path):
    cfg, q = _deepseek()
    with _fresh():
        off = _decode(cfg, q)
        with profile(activities=[ProfilerActivity.CPU]):
            on = _decode(cfg, q)
        with TR.capture(tmp_path / "t.jsonl"):
            jsonl = _decode(cfg, q)
    assert torch.equal(off, on) and torch.equal(off, jsonl)

    cfg, state, batch = _phimoe()

    def grads():
        ls = [t.detach().requires_grad_(True)
              for t in tree_leaves(state.params)]
        logits, aux = T.forward(tree_unflatten(state.params, ls), batch, cfg,
                                remat=True)
        loss = losses.next_token_loss(logits, batch["tokens"], aux=aux)
        return [loss] + list(torch.autograd.grad(loss, ls))

    with _fresh():
        base = grads()
        with profile(activities=[ProfilerActivity.CPU]):
            traced = grads()
    assert all(torch.equal(a, b) for a, b in zip(base, traced))


def test_profiler_alone_leaves_profiling_off():
    with _fresh():
        assert not TR.recording() and not PF.profiling()
        with profile(activities=[ProfilerActivity.CPU]):
            assert TR.recording() and not PF.profiling()
            assert not TR.active()
        assert not TR.recording()
