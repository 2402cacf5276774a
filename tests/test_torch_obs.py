"""The port's observability: `repro_torch.obs.{ring,report,prof,xprof}` and
the instrumentation the ported paths carry under the reference's names.

* `RingLog` bounds, counts, spills and restores as the reference's does.
* The port's report renders the two committed traces byte-equal to their
  golden reports, and its CLI writes the CSVs.
* Off path: with tracing off, no tracer is constructed and the executable
  registry is never touched, and a deepseek-v2-shaped forward and decode
  (MLA, MoE, w8 stacks) open no span or profiler range and touch no
  counter.
* `run_nsga2` under tracing emits the reference's ``ga.*`` records, equal
  once ``ts`` and ``dur`` are dropped, and the same ``ga.generations``.
* `evaluate_population` on ``seeds``, with the reference's pretrained
  weights injected into both packages and run through an `EvalCache`
  twice, counts the same specs, cache hits and misses, K1 launches,
  candidates and pack hits as the reference; the ``*.pad.*`` counters are
  the port's own (no population bucket; K1's lanes and rows).
* A `PF.dispatch` snapshot is JSON-able, sorted and drops transient keys;
  a kernel build is a compile of the first profiled dispatch of its
  library and never a recompile; profiled results are bit-identical.
"""
import collections
import contextlib
import dataclasses
import json
from pathlib import Path

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs.printed_mlp import PRINTED_MLPS  # noqa: E402
from repro.core import batch_eval as RBE  # noqa: E402
from repro.core import ga as RGA  # noqa: E402
from repro.core import minimize as RMZ  # noqa: E402
from repro.core.compression_spec import ModelMin as RM  # noqa: E402
from repro.obs import metrics as RMT  # noqa: E402
from repro.obs import trace as RTR  # noqa: E402
from repro_torch.configs import ARCHS as T_ARCHS  # noqa: E402
from repro_torch.configs.printed_mlp import \
    PRINTED_MLPS as T_PRINTED_MLPS  # noqa: E402
from repro_torch.core import batch_eval as TBE  # noqa: E402
from repro_torch.core import ga as TGA  # noqa: E402
from repro_torch.core import minimize as TMZ  # noqa: E402
from repro_torch.core.compression_spec import ModelMin as TM  # noqa: E402
from repro_torch.nn import mlp as TMLP  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.obs import RingLog  # noqa: E402
from repro_torch.obs import metrics as MT  # noqa: E402
from repro_torch.obs import prof as PF  # noqa: E402
from repro_torch.obs import report  # noqa: E402
from repro_torch.obs import trace as TR  # noqa: E402
from repro_torch.obs import xprof  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402

DATA = Path(__file__).resolve().parent / "data"
EPOCHS = 3


@contextlib.contextmanager
def _tracing_off():
    """Detach any ambient tracer of either package (a run under
    REPRO_TRACE=1 installs one); the off-path contracts need tracing off."""
    prev, prev_r = TR._tracer, RTR._tracer
    TR._tracer = RTR._tracer = None
    try:
        yield
    finally:
        TR._tracer, RTR._tracer = prev, prev_r


# ---------------------------------------------------------------------------
# ring log
# ---------------------------------------------------------------------------


def test_ringlog_bounds_and_counts():
    r = RingLog(cap=3)
    for i in range(7):
        r.append(i)
    assert list(r) == [4, 5, 6]
    assert len(r) == 3 and r.total == 7 and r.dropped == 4
    assert r[0] == 4 and r[-1] == 6 and r[1:] == [5, 6]


def test_ringlog_spills_every_append():
    spilled = []
    r = RingLog(cap=2, spill=spilled.append)
    r.extend([{"event": "a"}, {"event": "b"}, {"event": "c"}])
    assert list(r) == [{"event": "b"}, {"event": "c"}]   # ring keeps a tail
    assert spilled == [{"event": "a"}, {"event": "b"}, {"event": "c"}]


def test_ringlog_full_slice_restore_bypasses_spill():
    spilled = []
    r = RingLog(cap=4, spill=spilled.append)
    r.extend([1, 2, 3])
    r[:] = [8, 9]                          # checkpoint-restore idiom
    assert list(r) == [8, 9] and r.total == 2 and r.dropped == 0
    assert spilled == [1, 2, 3]            # restore did not re-spill
    with pytest.raises(TypeError):
        r[0] = 5                           # only full-slice assignment
    with pytest.raises(ValueError):
        RingLog(cap=0)


# ---------------------------------------------------------------------------
# report: the committed traces render to their goldens
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["2island", "profiled"])
def test_report_renders_committed_traces_to_goldens(name):
    recs, damaged = TR.read_trace(DATA / f"obs_trace_{name}.jsonl")
    assert damaged == 0
    txt = report.render(recs, 0, f"obs_trace_{name}.jsonl")
    assert txt == (DATA / f"obs_report_{name}.txt").read_text()


def test_report_cli_and_csv(tmp_path, capsys):
    prefix = tmp_path / "run"
    rc = report.main([str(DATA / "obs_trace_profiled.jsonl"),
                      "--csv", str(prefix)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "wall-clock by span" in out and "executables (observatory)" in out
    for section in ("spans", "generations", "cache", "ledger",
                    "executables", "padding"):
        f = Path(f"{prefix}.{section}.csv")
        assert f.exists() and f.read_text().strip()


def test_report_device_column_only_where_traced():
    """Dispatch spans carrying ``device_ms`` add the ``dev_ms`` column;
    the committed traces carry none and keep the reference's layout."""
    recs = [{"kind": "span", "name": "kernels.netlist_sim.smem", "ts": 0.0,
             "dur": 0.01, "depth": 0,
             "attrs": {"key": "k", "first": True, "device_ms": 0.25}},
            {"kind": "span", "name": "kernels.netlist_sim.smem", "ts": 0.1,
             "dur": 0.01, "depth": 0,
             "attrs": {"key": "k", "first": False, "device_ms": 0.5}}]
    (e,) = report.executables(recs)
    assert e["device_ms"] == 0.75 and e["dispatches"] == 2
    assert "dev_ms" in report.render(recs)
    recs, _ = TR.read_trace(DATA / "obs_trace_profiled.jsonl")
    assert "dev_ms" not in report.render(recs)


# ---------------------------------------------------------------------------
# off path
# ---------------------------------------------------------------------------


def _seeds_specs(ModelMin):
    cfg = PRINTED_MLPS["seeds"]
    n = len(cfg.layer_dims) - 1
    return [ModelMin.uniform(n, bits=b, sparsity=s,
                             input_bits=cfg.input_bits)
            for b, s in ((4, 0.0), (3, 0.2), (5, 0.4))]


def _mla_moe_forward():
    """A deepseek-v2-shaped forward (MLA, MoE with shared experts, w8
    expert stacks) and decode step at tiny widths."""
    cfg = T_ARCHS["deepseek-v2-236b"].reduced(d_model=128)
    params = TT.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    q = TQ.quantize_params(params, 8)
    tok = torch.randint(0, cfg.vocab_size, (2, 8),
                        generator=torch.Generator().manual_seed(1))
    TT.forward(params, {"tokens": tok}, cfg, remat=False)
    state = TT.init_decode_state(cfg, 2, 16, cfg.dtype, device="cpu")
    TT.decode_step(q, state, tok, cfg)


def test_off_path_touches_neither_tracer_nor_registry(monkeypatch):
    constructed, calls = [], []
    init = TR.Tracer.__init__

    def counting(self, path):
        constructed.append(str(path))
        init(self, path)

    real_dispatch = PF.dispatch
    monkeypatch.setattr(TR.Tracer, "__init__", counting)
    monkeypatch.setattr(PF, "dispatch", lambda *a, **k: calls.append(a)
                        or real_dispatch(*a, **k))
    monkeypatch.setattr(xprof, "capture_executable",
                        lambda *a, **k: calls.append("capture") or {})
    PF.reset()
    with _tracing_off():
        TBE.evaluate_population(T_PRINTED_MLPS["seeds"], _seeds_specs(TM),
                                epochs=1, device="cpu")
        TGA.run_nsga2(2, _synthetic, TGA.GAConfig(population=4,
                                                  generations=2, seed=1))
        # the LM path: no span, profiler range, device mark or counter
        lm = []
        monkeypatch.setattr(TR, "_Span", lambda *a: lm.append(a))
        monkeypatch.setattr(TR, "_Range", lambda *a: lm.append(a))
        monkeypatch.setattr(TR.SPANS, "open", lambda *a: lm.append(a))
        monkeypatch.setattr(MT, "counter", lambda *a: lm.append(a))
        _mla_moe_forward()
    assert constructed == [] and calls == [] and lm == []
    assert PF.REGISTRY.executables == {}
    assert PF.REGISTRY.compiles == 0 and PF.REGISTRY.aot_compiles == 0


# ---------------------------------------------------------------------------
# run_nsga2 under tracing: the reference's ga.* records
# ---------------------------------------------------------------------------


def _synthetic(spec):
    bits = sum(l.bits for l in spec.layers)
    sp = sum(l.sparsity for l in spec.layers)
    return (bits / 16.0, sp)


def _ga_records(path):
    recs, damaged = TR.read_trace(path)
    assert damaged == 0
    return [{k: v for k, v in r.items() if k not in ("ts", "dur")}
            for r in recs if r.get("name", "").startswith("ga.")]


def test_run_nsga2_traces_the_reference_records(tmp_path):
    RMT.REGISTRY.reset()
    MT.REGISTRY.reset()
    with _tracing_off():
        with RTR.capture(tmp_path / "r.jsonl"):
            rres = RGA.run_nsga2(2, _synthetic, RGA.GAConfig(
                population=6, generations=4, seed=3))
        with TR.capture(tmp_path / "t.jsonl"):
            tres = TGA.run_nsga2(2, _synthetic, TGA.GAConfig(
                population=6, generations=4, seed=3))
    ref = _ga_records(tmp_path / "r.jsonl")
    got = _ga_records(tmp_path / "t.jsonl")
    assert [r["name"] for r in got].count("ga.generation") == 4
    assert [r["name"] for r in got].count("ga.front") == 4
    assert got == ref
    assert tres.history == rres.history
    assert MT.snapshot()["counters"]["ga.generations"] == \
        RMT.snapshot()["counters"]["ga.generations"] == 4


# ---------------------------------------------------------------------------
# evaluate_population: counters that are functions of the evaluated specs
# ---------------------------------------------------------------------------

SAME = ("eval.specs_requested", "eval.specs_cached", "eval.specs_evaluated",
        "cache.hit", "cache.miss", "cache.flushes", "netlist_sim.launches",
        "netlist_sim.candidates", "netlist_sim.pack_hits")


@contextlib.contextmanager
def _reference_weights():
    """The port's pretrain returns the reference's pretrained weights."""
    cfg = PRINTED_MLPS["seeds"]
    p0, data = RMZ.pretrain(cfg, seed=0)
    p0 = jax.tree_util.tree_map(np.asarray, p0)
    real = TMZ.pretrain

    def fake(cfg, *, epochs=600, lr=5e-3, seed=0, device=None):
        assert cfg.name == "seeds" and seed == 0
        return TMLP.params_from_numpy(p0, device), data

    TMZ.pretrain = fake
    try:
        yield
    finally:
        TMZ.pretrain = real


def _three_passes(BE, cfg, specs, path, **kw):
    """Evaluate through a fresh cache, again through that cache (all hits),
    then without a cache (the netlists' packed tables hit)."""
    out = [BE.evaluate_population(cfg, specs, epochs=EPOCHS,
                                  cache=BE.EvalCache(path), **kw)]
    out.append(BE.evaluate_population(cfg, specs, epochs=EPOCHS,
                                      cache=BE.EvalCache(path), **kw))
    out.append(BE.evaluate_population(cfg, specs, epochs=EPOCHS, **kw))
    return out


def test_evaluation_counters_equal_the_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(RBE, "_PACK_CACHE", collections.OrderedDict())
    monkeypatch.setattr(TBE, "_PACK_CACHE", collections.OrderedDict())
    specs_r, specs_t = _seeds_specs(RM), _seeds_specs(TM)
    specs_r, specs_t = specs_r + specs_r[:1], specs_t + specs_t[:1]
    RMT.REGISTRY.reset()
    MT.REGISTRY.reset()
    with _tracing_off():
        ref = _three_passes(RBE, PRINTED_MLPS["seeds"], specs_r,
                            tmp_path / "r.json")
        with _reference_weights():
            got = _three_passes(TBE, T_PRINTED_MLPS["seeds"], specs_t,
                                tmp_path / "t.json", device="cpu")
    for a, b in zip(ref, got):
        assert [r.spec.to_json() for r in a] == [r.spec.to_json() for r in b]
        assert [(r.area_mm2, r.n_multipliers) for r in a] == \
            [(r.area_mm2, r.n_multipliers) for r in b]
    rc, tc = RMT.snapshot()["counters"], MT.snapshot()["counters"]
    assert {k: rc.get(k, 0) for k in SAME} == {k: tc.get(k, 0) for k in SAME}
    assert tc["eval.specs_evaluated"] == 6 and tc["cache.hit"] == 3
    assert tc["netlist_sim.launches"] == 2 and tc["netlist_sim.pack_hits"] == 3
    # the port's own padding: no population bucket, exact specs trained;
    # K1's plain version on the CPU runs B rows in waves of 256 lanes
    assert tc["eval.pad.specs_real"] == tc["eval.pad.specs_total"] == 6
    assert rc["eval.pad.specs_total"] == 8          # the reference's bucket
    n_test = len(TMZ.dataset_for(T_PRINTED_MLPS["seeds"])[3])
    assert tc["netlist_sim.pad.rows_real"] == \
        tc["netlist_sim.pad.rows_total"] == 2 * n_test
    assert tc["netlist_sim.pad.cand_real"] == \
        tc["netlist_sim.pad.cand_total"] == 6
    assert 0 < tc["netlist_sim.pad.lanes_used"] <= \
        tc["netlist_sim.pad.lanes_total"]
    assert tc["netlist_sim.pad.lanes_total"] % 256 == 0


def test_profiled_population_eval_bit_identical(tmp_path):
    """Profiling (tracing on) leaves the results byte-equal; the traced
    run dispatches the finetune through the observatory with FLOPs from
    ``FlopCounterMode``, and records the ported spans and events."""
    cfg = T_PRINTED_MLPS["seeds"]
    with _tracing_off():
        base = TBE.evaluate_population(cfg, _seeds_specs(TM), epochs=2,
                                       device="cpu")
    PF.reset()
    with TR.capture(tmp_path / "t.jsonl"):
        prof = TBE.evaluate_population(cfg, _seeds_specs(TM), epochs=2,
                                       device="cpu")
    assert [dataclasses.asdict(r) for r in base] == \
        [dataclasses.asdict(r) for r in prof]
    (rec,) = PF.REGISTRY.executables.values()
    assert rec["site"] == "eval.finetune" and rec["dispatches"] == 1
    assert rec["flops"] > 0 and rec["compiles"] == 0
    assert rec["argument_size_in_bytes"] > 0 and \
        rec["output_size_in_bytes"] > 0
    recs, _ = TR.read_trace(tmp_path / "t.jsonl")
    names = {r.get("name") for r in recs}
    assert {"eval.finetune", "eval.compile_price", "kernels.netlist_sim",
            "eval.padding", "netlist_sim.padding",
            "prof.executable"} <= names
    assert [e["site"] for e in report.executables(recs)] == \
        ["eval.finetune"]
    pad = {(p["site"], p["dim"]) for p in report.padding_table(recs)}
    assert pad == {("eval.finetune[seeds]", "specs"),
                   ("netlist_sim.levels", "lanes"),
                   ("netlist_sim.levels", "rows")}


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_snapshot_is_jsonable_sorted_and_drops_transients():
    PF.reset()
    rec = PF.REGISTRY.record("site.b", "kb")
    rec["_key"] = "kb"                      # in-flight transient
    PF.REGISTRY.record("site.a", "ka")
    PF.REGISTRY.on_compile(rec, 0.25, False)
    PF.REGISTRY.on_compile(None, 1.5, True)  # unattributed AOT compile
    snap = PF.snapshot()
    assert list(snap["executables"]) == ["ka", "kb"]
    assert "_key" not in snap["executables"]["kb"]
    assert snap["executables"]["kb"]["compiles"] == 1
    assert snap["totals"] == {"aot_compile_s": 1.5, "aot_compiles": 1,
                              "compile_s": 0.25, "compiles": 1}
    assert json.dumps(snap, sort_keys=True)  # checkpoint-serializable
    restored = PF.ExecutableRegistry()
    restored.restore(snap)
    assert restored.snapshot() == snap
    PF.reset()


def test_a_build_is_one_compile_and_never_a_recompile(tmp_path):
    """`kernels.build.build_many` reports each library it builds to
    `xprof.on_build`: `count_compiles` sees it with tracing off, and the
    first profiled dispatch of a site running that library records it as
    that key's compile; later dispatches of any key record none."""
    with _tracing_off():
        with xprof.count_compiles() as cc:
            xprof.on_build("netlist_sim", 2.5)
    assert (cc.compiles, cc.compile_s, cc.aot_compiles) == (1, 2.5, 0)
    PF.reset()
    with TR.capture(tmp_path / "t.jsonl"):
        for key in ("k1", "k1", "k2"):
            with PF.dispatch("kernels.netlist_sim.smem", key,
                             library="netlist_sim", flops=10.0,
                             bytes_accessed=20.0) as call:
                call.outputs = np.zeros(4, np.int32)
    ex = PF.REGISTRY.executables
    assert (ex["k1"]["compiles"], ex["k1"]["compile_s"]) == (1, 2.5)
    assert ex["k1"]["dispatches"] == 2 and ex["k2"]["compiles"] == 0
    assert ex["k1"]["flops"] == 10.0 and ex["k1"]["bytes_accessed"] == 20.0
    assert ex["k1"]["output_size_in_bytes"] == 16
    assert xprof.take_builds("netlist_sim") == []
    recs, _ = TR.read_trace(tmp_path / "t.jsonl")
    (e1, e2) = report.executables(recs)
    assert (e1["key"], e1["compiles"], e2["compiles"]) == ("k1", 1, 0)
    assert "0 key(s) recompiled" in report.render(recs)
    PF.reset()
