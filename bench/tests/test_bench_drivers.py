"""Each driver end to end on the CPU at a tiny size: set-up, window, trace
and check, with the harness's look for a card skipped. A sound run passes
its cell's limits; the control reads higher than the program; and every
fault the cell can have, planted under the timed path, turns ``correct``
false."""
import importlib

import pytest

from bench.harness import common as C
from bench.tests import tiny

CELL = {"decode": "deepseek-v2-l4.decode-w8",
        "prefill": "deepseek-v2-l4.prefill-long",
        "train": "phi3.5-moe-l2.train-4x4096"}
FAULTS = {"decode": ["altered"], "prefill": ["altered"],
          "train": ["unchanged", "half_batch"]}
E2E = {"decode": {"decode_tok_s", "setup_s"},
       "prefill": {"prefill_tok_s", "ttft_p95_ms", "setup_s"},
       "train": {"train_tok_s", "setup_s"}}


def run(kind, **kw):
    drv = importlib.import_module(f"bench.drivers.{kind}")
    return drv.run(tiny.context(kind, **kw))


@pytest.mark.parametrize("kind", sorted(CELL))
def test_sound_run_is_correct_and_reports_its_metrics(kind):
    out = run(kind, trace=True, control=True)
    assert set(out.e2e) == E2E[kind]
    assert all(v > 0 for v in out.e2e.values())
    lim = C.limits(CELL[kind])
    assert C.judge(out.checks, lim), (out.checks, lim)
    assert out.attempted > 0 and out.failed == 0
    # the control reads above the program on every number compared
    assert any(out.control[k] > 10 * max(out.checks[k], 1e-6)
               for k in out.checks), (out.checks, out.control)
    man = C.manifest()
    for m in man["per_layer"]:
        if C.applies(m, CELL[kind]):
            v = C.reader(m["name"]).read(out.obs)
            # the CPU has no device trace: those readers stay silent
            if m["source"] == "device_trace":
                assert v is None
            else:
                assert v is not None and v >= 0


@pytest.mark.parametrize("kind,fault", [(k, f) for k in sorted(FAULTS)
                                        for f in FAULTS[k]])
def test_planted_fault_is_not_correct(kind, fault):
    out = run(kind, faults=[fault])
    assert not C.judge(out.checks, C.limits(CELL[kind])), out.checks


def test_same_seed_same_inputs():
    import torch
    from bench.drivers import train
    from bench.harness import weights as WT
    s = tiny.MLA_MOE
    seed = 2 ** 33 + 7
    a, b = WT.make(s, seed, "cpu"), WT.make(s, seed, "cpu")
    c = WT.make(s, seed + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head"], c["lm_head"])
    assert sum(t.numel() for t in a.values()) == WT.param_count(s)
    ctx = tiny.context("train", seed=seed)
    f1, f2 = train.batches(ctx), train.batches(ctx)
    for _ in range(3):
        assert torch.equal(next(f1), next(f2))
