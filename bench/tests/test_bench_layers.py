"""The readers of the port's own spans and counters (`bench.harness.layers`)
on a canned trace: each reads its known value in its cell and nothing
elsewhere or from a port without spans; the program's host ranges leave
every device-trace reader where it was; idle gaps are laid at the
innermost program span. Then the port itself under the harness's profiler
on the CPU: its spans are host ranges only, and the readers read them."""
import pytest
import torch

from bench.harness import layers
from bench.harness import trace as TRACE
from bench.harness.common import reader
from bench.harness.trace import Summary
from bench.tests.test_bench_metrics import MS, canned
from bench.tests.test_bench_metrics import obs as decode_obs

SPANS = {"lm.dequant": {"calls": 24, "s": 0.012, "self_s": 0.012},
         "lm.mla.attend": {"calls": 8, "s": 0.004, "self_s": 0.004},
         "lm.head": {"calls": 2, "s": 0.030, "self_s": 0.030},
         "train.optimizer": {"calls": 2, "s": 0.100, "self_s": 0.100},
         "lm.moe.backward": {"calls": 4, "s": 0.300, "self_s": 0.180}}
COUNTERS = {"moe.pairs": 1000, "moe.pairs_kept": 950, "moe.slots": 1250}
PROGRAM_HOST = [("lm.block", 0, 8 * MS), ("lm.dequant", 1 * MS, 3 * MS),
                ("lm.block", 9 * MS, 19 * MS), ("lm.head", 12 * MS, 18 * MS)]


@pytest.fixture
def port(monkeypatch):
    monkeypatch.setattr(layers, "span_times", lambda: dict(SPANS))
    monkeypatch.setattr(layers, "counters", lambda: dict(COUNTERS))


def with_program(kind):
    """The canned trace with the port's ranges on the host, and the
    drivers' step ranges named for ``kind``."""
    tr = canned()
    host = [(layers.STEP[kind] if n == "bench.decode_step" else n, a, b)
            for n, a, b in tr.host] + PROGRAM_HOST
    o = decode_obs(kind)
    o["trace"] = Summary(tr.device, host, tr.window_s)
    return o


NEW = {"dequant_ms.decode": ("decode", 6.0),
       "mla_attend_ms.decode": ("decode", 2.0),
       "lm_head_ms.prefill": ("prefill", 15.0),
       "moe_fill_pct.prefill": ("prefill", 76.0),
       "optimizer_ms.train": ("train", 50.0),
       "moe_bwd_ms.train": ("train", 90.0),
       "moe_drop_pct.train": ("train", 5.0)}


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers_read_their_cell_only(port, name):
    kind, want = NEW[name]
    mod = reader(name)
    assert mod.KIND == kind
    assert mod.read(with_program(kind)) == pytest.approx(want)
    for other in {"decode", "prefill", "train"} - {kind}:
        assert mod.read(with_program(other)) is None
    assert mod.read({"kind": kind}) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_new_readers_silent_without_the_ports_spans(monkeypatch, name):
    monkeypatch.setattr(layers, "span_times", lambda: None)
    monkeypatch.setattr(layers, "counters", lambda: {})
    kind = NEW[name][0]
    assert reader(name).read(with_program(kind)) is None


def test_program_ranges_leave_the_device_readers_unmoved():
    plain, ranged = decode_obs(), with_program("decode")
    for name in ("k2_roofline.decode", "launches_per_step.decode",
                 "device_idle.decode", "mfu.decode", "mbu.decode",
                 "itl_p95_ms.decode"):
        assert reader(name).read(ranged) == reader(name).read(plain), name
    assert ranged["trace"].busy_s == plain["trace"].busy_s
    assert ranged["trace"].device_ops() == plain["trace"].device_ops()


def test_idle_gaps_by_innermost_program_span():
    tr = with_program("decode")["trace"]
    # busy 0-7 and 10-17 ms: one gap, 7-10 ms, its middle 8.5 ms between
    # the two blocks
    assert layers.idle_by_span(tr) == {
        "host: outside any span": pytest.approx(3e-3)}
    host = tr.host + [("lm.moe.combine", 8 * MS, 9 * MS)]
    inner = Summary(tr.device, host, tr.window_s)
    assert layers.idle_by_span(inner) == {
        "lm.moe.combine": pytest.approx(3e-3)}


def test_busy_time_in_no_span():
    tr = with_program("decode")["trace"]
    times = {"lm.block": {"s": 10e-3, "self_s": 4e-3, "root_s": 10e-3},
             "lm.head": {"s": 2e-3, "self_s": 2e-3, "root_s": 2e-3}}
    # busy 14 ms; the outermost spans 12 ms, no idle inside them
    assert layers.outside_s(tr, times, {"host: outside any span": 3e-3}) \
        == pytest.approx(2e-3)
    # 1 ms of the spans' time was the card waiting inside lm.block
    assert layers.outside_s(tr, times, {"lm.block": 1e-3}) == \
        pytest.approx(3e-3)


def test_the_ports_spans_under_the_harness_profiler():
    """A tiny deepseek-v2-shaped w8 decode of the port under
    `bench.harness.trace.traced` on the CPU: its spans reach the host list
    and not the device list, and the readers read them."""
    from repro_torch.configs import ARCHS
    from repro_torch.nn import transformer as T
    from repro_torch.obs import metrics as MT
    from repro_torch.obs import trace as TR
    from repro_torch.serve import quantized as QS
    cfg = ARCHS["deepseek-v2-236b"].reduced(d_model=128)
    q = QS.quantize_params(T.init(torch.Generator().manual_seed(0), cfg,
                                  device="cpu"), 8)
    state = T.init_decode_state(cfg, 2, 16, cfg.dtype, device="cpu")
    tok = torch.zeros((2, 1), dtype=torch.long)
    TR.SPANS.reset()
    MT.REGISTRY.reset()
    out: list = []
    try:
        with TRACE.traced(torch.device("cpu"), out):
            for i in range(2):
                with TRACE.step_range("decode_step"):
                    T.decode_step(q, dict(state, kv_len=i), tok, cfg)
        tr = out[0]
        o = {"kind": "decode", "trace": tr, "traced_steps": 2}
        assert tr.device == []
        names = {n for n, _, _ in tr.host}
        assert {"lm.block", "lm.dequant", "lm.mla.attend", "lm.head",
                "bench.decode_step"} <= names
        assert layers.steps(tr, "decode") == 2
        assert reader("dequant_ms.decode").read(o) > 0
        assert reader("mla_attend_ms.decode").read(o) > 0
        assert layers.counters()["moe.pairs"] == 2 * 2 * 2 * 2
    finally:
        TR.SPANS.reset()
        MT.REGISTRY.reset()
