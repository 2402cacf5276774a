"""The port's population evaluator, GA and paper driver.

* On the six-spec fixture of ``tests/test_batch_eval.py`` the port's
  batched evaluation equals its serial one exactly (accuracy, area, power,
  multipliers, delay).
* Against the reference, with the reference's pretrained weights injected
  into both, accuracy agrees within 1e-3 (the reference's own
  serial-vs-batched gate, ``tests/test_batch_eval.py``) and the integer
  pricing (area, multipliers, delay) is equal: training is a float stage
  whose drift stays far below a quantization step on this fixture.
* Given the same fitness function, the GA is `repro.core.ga` byte for byte.
* Specs with approximation genes are scored as the reference scores them
  (the approximated netlist simulated, structural pricing) in the batched
  and the serial path, cached in the netlist keyspace under the
  reference's keys, and quarantined like any other spec; the Fig. 1 sweeps
  give the reference's points under the same tolerance.
* Entry points run on CUDA unless asked for the CPU, and raise without a
  card.
"""
import contextlib
import zlib

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
from repro.core.compression_spec import LayerMin as RL  # noqa: E402
from repro.core.compression_spec import ModelMin as RM  # noqa: E402
from repro_torch import paper  # noqa: E402
from repro_torch.configs.printed_mlp import \
    PRINTED_MLPS as T_PRINTED_MLPS  # noqa: E402
from repro_torch.core import batch_eval as TBE  # noqa: E402
from repro_torch.core import ga as TGA  # noqa: E402
from repro_torch.core import minimize as TMZ  # noqa: E402
from repro_torch.core.compression_spec import LayerMin as TL  # noqa: E402
from repro_torch.core.compression_spec import ModelMin as TM  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import netlist_sim as TNS  # noqa: E402
from repro_torch.nn import mlp as TMLP  # noqa: E402
from repro_torch.obs import metrics as MT  # noqa: E402
from repro_torch.obs import trace as TR  # noqa: E402

EPOCHS = 30
ACC_TOL = 1e-3


def _specs(ModelMin, LayerMin):
    n = 2
    return [
        ModelMin.uniform(n, bits=8),
        ModelMin.uniform(n, bits=3),
        ModelMin.uniform(n, bits=6, sparsity=0.4),
        ModelMin.uniform(n, bits=4, sparsity=0.3, clusters=4),
        ModelMin((LayerMin(2, 0.5, 2), LayerMin(8, 0.0, 16)), 8),
        ModelMin((LayerMin(5, 0.0, 3), LayerMin(4, 0.2, None)), 8),
    ]


R_SPECS, T_SPECS = _specs(RM, RL), _specs(TM, TL)
CFG, TCFG = PRINTED_MLPS["seeds"], T_PRINTED_MLPS["seeds"]


@contextlib.contextmanager
def reference_pretrain():
    """The port's pretrain returns the reference's pretrained weights."""
    p0, data = RMZ.pretrain(CFG, seed=0)
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


@pytest.fixture(scope="module")
def injected():
    """Both packages start from the reference's pretrained weights."""
    with reference_pretrain():
        serial = [TMZ.evaluate_spec(TCFG, s, epochs=EPOCHS, device="cpu")
                  for s in T_SPECS]
        batched = TBE.evaluate_population(TCFG, T_SPECS, epochs=EPOCHS,
                                          device="cpu")
    return serial, batched


def _tuple(r):
    return (r.spec.to_json(), r.accuracy, r.area_mm2, r.power_mw,
            r.n_multipliers, r.delay_levels)


def test_port_batched_equals_port_serial(injected):
    serial, batched = injected
    assert [_tuple(a) for a in batched] == [_tuple(a) for a in serial]


def test_port_matches_reference_population(injected):
    _, batched = injected
    ref = RBE.evaluate_population(CFG, R_SPECS, epochs=EPOCHS)
    for r, t in zip(ref, batched):
        assert r.spec.to_json() == t.spec.to_json()
        assert abs(r.accuracy - t.accuracy) <= ACC_TOL, r.spec
        assert (r.area_mm2, r.n_multipliers, r.delay_levels) == \
            (t.area_mm2, t.n_multipliers, t.delay_levels), r.spec


def test_population_finetune_matches_serial_weights():
    """The batched train loop gives each candidate exactly the weights of
    its own serial finetune."""
    params0, (xtr, ytr, _, _) = TMZ.pretrain(TCFG, epochs=40, device="cpu")
    specs = T_SPECS[2:5]
    bits, ks = TBE.stack_specs(specs)
    stacked, serial_masks = TBE.stack_masks(params0, specs)
    pop = TBE._population_finetune(
        params0, torch.from_numpy(bits), torch.from_numpy(ks),
        [torch.from_numpy(m) for m in stacked],
        *TMZ._tensors(xtr, ytr, "cpu"), epochs=6, lr=2e-3)
    for p, s in enumerate(specs):
        one = TMZ.qat_finetune(params0, s, serial_masks[p], xtr, ytr,
                               epochs=6, lr=2e-3, device="cpu")
        for a, b in zip(pop["layers"], one["layers"]):
            for k in "wb":
                np.testing.assert_array_equal(a[k][p].numpy(), b[k].numpy())


def test_dedup_order_cache_and_torch_cache_file(injected, tmp_path,
                                                monkeypatch):
    _, batched = injected
    cache = TBE.EvalCache(tmp_path / "seeds_torch_evals.json")
    for r in batched:
        cache.put("seeds", 0, EPOCHS, r, netlist=True)
    cache.flush()
    # keys are the reference's, byte for byte
    s = T_SPECS[3]
    assert TBE.EvalCache.key("seeds", 0, EPOCHS, s, True) == \
        RBE.EvalCache.key("seeds", 0, EPOCHS, R_SPECS[3], True)
    assert paper.cache_path("c", "seeds") == "c/seeds_torch_evals.json"

    def boom(*a, **k):
        raise AssertionError("finetune ran on a fully-cached population")
    monkeypatch.setattr(TBE, "_population_finetune", boom)
    dup = [T_SPECS[1], T_SPECS[0], T_SPECS[1]]
    out = TBE.evaluate_population(TCFG, dup, epochs=EPOCHS, device="cpu",
                                  cache=TBE.EvalCache(cache.path))
    assert [r.spec for r in out] == dup
    assert _tuple(out[0]) == _tuple(out[2]) == _tuple(batched[1])


def test_batched_sim_fault_falls_back_then_quarantines(monkeypatch):
    specs = [TM.uniform(2, bits=8), TM.uniform(2, bits=3, sparsity=0.3)]
    expected = TBE.evaluate_population(TCFG, specs, epochs=8, device="cpu")

    def boom(*a, **k):
        raise RuntimeError("injected batched-sim fault")

    monkeypatch.setattr(TBE, "_packed_netlist_for", boom)
    got = TBE.evaluate_population(TCFG, specs, epochs=8, device="cpu")
    assert [_tuple(r) for r in got] == [_tuple(r) for r in expected]

    from repro_torch import circuit
    monkeypatch.setattr(circuit, "netlist_accuracy", boom)
    recs = []
    rs = TBE.evaluate_population(TCFG, specs[:1], epochs=8, device="cpu",
                                 quarantine=recs)
    assert len(recs) == 1 and recs[0].stage == "score"
    assert recs[0].attempts == 2 and recs[0].error == "RuntimeError"
    assert rs[0].accuracy == 0.0
    assert rs[0].area_mm2 == TBE.QUARANTINE_AREA_MM2


def test_compile_fault_retried_once_then_quarantined():
    calls = []

    def hook(spec, attempt):
        calls.append(attempt)
        raise ValueError("injected compile fault")

    prev = TBE.set_eval_fault_hook(hook)
    try:
        recs = []
        rs = TBE.evaluate_population(TCFG, [TM.uniform(2, bits=5)], epochs=4,
                                     device="cpu", quarantine=recs)
    finally:
        TBE.set_eval_fault_hook(prev)
    assert calls == [1, 2]
    assert recs[0].stage == "compile" and rs[0].area_mm2 == 1e9


def _fitness(spec_json):
    h = zlib.crc32(spec_json.encode())
    return (h % 1000) / 1000.0, float((h >> 10) % 5000), float(h % 17)


@pytest.mark.parametrize("three", [False, True])
def test_ga_trajectory_identical_given_same_fitness(three):
    def make(ModelMin):
        def batch(specs):
            return [_fitness(s.to_json())[:3 if three else 2]
                    for s in specs]
        seeds = [ModelMin.uniform(2, bits=4),
                 ModelMin.uniform(2, bits=3, sparsity=0.3)]
        return batch, seeds

    rb, rs = make(RM)
    tb, ts = make(TM)
    rres = RGA.run_nsga2(2, None, RGA.GAConfig(population=10, generations=6,
                                               seed=3),
                         seed_specs=rs, batch_evaluate=rb)
    tres = TGA.run_nsga2(2, None, TGA.GAConfig(population=10, generations=6,
                                               seed=3),
                         seed_specs=ts, batch_evaluate=tb)
    assert [s.to_json() for s in tres.population] == \
        [s.to_json() for s in rres.population]
    assert tres.objectives.tobytes() == rres.objectives.tobytes()
    assert tres.history == rres.history
    assert tres.evaluations == rres.evaluations


def test_paper_run_end_to_end_on_cpu():
    reset_launches()
    res = paper.run("seeds", population=4, generations=2, epochs=8,
                    device="cpu")
    assert res["device"] == "cpu"
    assert LAUNCHES["netlist_sim"] == 0
    assert res["pareto_front"] and res["n_evaluations"] >= 4
    assert 0.0 < res["baseline_acc"] <= 1.0
    assert np.isfinite(res["combined_gain_at_5pct"])
    assert len(res["history"]) == 2
    spec = TM.from_json(paper.chosen_point(res))
    from repro_torch import circuit
    net, c = circuit.compile_spec(TCFG, spec, epochs=8, device="cpu")
    _, _, xte, yte = TMZ.dataset_for(TCFG)
    _, cls = TMZ.integer_forward(c, TMZ.quantize_inputs(c, xte))
    assert circuit.netlist_accuracy(net, c, xte, yte, device="cpu") == \
        float(np.mean(cls == yte))
    assert circuit.cross_validate(net, c)["ok"]


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TMZ.pretrain(TCFG),
                 lambda: TMZ.evaluate_spec(TCFG, T_SPECS[0], epochs=1),
                 lambda: TBE.evaluate_population(TCFG, T_SPECS[:1],
                                                 epochs=1),
                 lambda: paper.run("seeds", population=2, generations=1,
                                   epochs=1),
                 lambda: TNS.simulate_population(
                     _tiny_pop(), np.zeros((2, 3), np.int64))):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def _tiny_pop():
    from repro_torch.circuit import ir
    net = ir.Netlist(in_bits=4, w_bits=[4])
    a, b, c = net.input(0), net.input(1), net.input(2)
    s = net.add(a, b)
    net.layer_pre_ids = [[s, c]]
    net.output_ids = [s, c]
    net.argmax([s, c])
    return TNS.pack_population([net])


def _approx_specs(ModelMin, LayerMin):
    """Approximated genomes, with one exact spec in the same population."""
    n = 2
    return [
        ModelMin.uniform(n, bits=4, sparsity=0.4, clusters=8, csd_drop=1,
                         lsb=2),
        ModelMin.uniform(n, bits=6, csd_drop=2, argmax_lsb=4),
        ModelMin((LayerMin(5, 0.2, None, csd_drop=3),
                  LayerMin(8, 0.0, 4, lsb=4)), 8, 2),
        ModelMin.uniform(n, bits=4, sparsity=0.3),
        ModelMin.uniform(n, bits=3, argmax_lsb=8),
    ]


RA_SPECS, TA_SPECS = _approx_specs(RM, RL), _approx_specs(TM, TL)


@pytest.fixture(scope="module")
def injected_approx():
    with reference_pretrain():
        serial = [TMZ.evaluate_spec(TCFG, s, epochs=EPOCHS, device="cpu")
                  for s in TA_SPECS]
        batched = TBE.evaluate_population(TCFG, TA_SPECS, epochs=EPOCHS,
                                          device="cpu")
    return serial, batched


def test_approx_specs_batched_equal_serial(injected_approx):
    serial, batched = injected_approx
    assert [_tuple(a) for a in batched] == [_tuple(a) for a in serial]


def test_approx_specs_match_reference_population(injected_approx):
    """Approximated specs reach the evaluator and are scored as the
    reference scores them: accuracy within ACC_TOL, the structural pricing
    and the delay equal."""
    _, batched = injected_approx
    ref = RBE.evaluate_population(CFG, RA_SPECS, epochs=EPOCHS)
    assert [s.has_approx for s in TA_SPECS] == \
        [True, True, True, False, True]
    for r, t in zip(ref, batched):
        assert r.spec.to_json() == t.spec.to_json()
        assert abs(r.accuracy - t.accuracy) <= ACC_TOL, r.spec
        assert (r.area_mm2, r.power_mw, r.n_multipliers, r.delay_levels) == \
            (t.area_mm2, t.power_mw, t.n_multipliers, t.delay_levels), r.spec


def test_approx_specs_cache_in_the_netlist_keyspace(tmp_path, monkeypatch):
    for t, r in zip(TA_SPECS, RA_SPECS):
        for netlist in (True, False):
            assert TBE.EvalCache.key("seeds", 0, EPOCHS, t, netlist) == \
                RBE.EvalCache.key("seeds", 0, EPOCHS, r, netlist)
    exact, ax = TA_SPECS[3], TA_SPECS[0]
    cache = TBE.EvalCache(tmp_path / "seeds_torch_evals.json")
    # the float opt-out: the approximated spec is still scored on its
    # simulated netlist and lands in the netlist keyspace; its exact twin
    # takes the float path
    rs = TBE.evaluate_population(TCFG, [exact, ax], epochs=4, cache=cache,
                                 netlist=False, device="cpu")
    assert rs[1].area_mm2 < rs[0].area_mm2 and rs[1].delay_levels > 0
    assert cache.get("seeds", 0, 4, ax, netlist=True) is not None
    assert cache.get("seeds", 0, 4, exact, netlist=True) is None
    assert cache.get("seeds", 0, 4, exact) is not None

    def boom(*a, **k):
        raise AssertionError("finetune ran on a fully-cached population")
    monkeypatch.setattr(TBE, "_population_finetune", boom)
    again = TBE.evaluate_population(TCFG, [exact, ax], epochs=4,
                                    cache=TBE.EvalCache(cache.path),
                                    netlist=False, device="cpu")
    assert [_tuple(r) for r in again] == [_tuple(r) for r in rs]


def test_approx_scoring_fault_quarantined_and_counted(monkeypatch,
                                                      tmp_path):
    from repro_torch import approx

    def boom(*a, **k):
        raise RuntimeError("injected approximated-netlist fault")

    monkeypatch.setattr(approx, "evaluate_netlist", boom)
    specs = [TA_SPECS[3], TA_SPECS[1]]
    before = MT.counter("eval.quarantine.score").value
    recs = []
    with TR.capture(tmp_path / "t.jsonl"):
        rs = TBE.evaluate_population(TCFG, specs, epochs=4, device="cpu",
                                     quarantine=recs)
    assert MT.counter("eval.quarantine.score").value == before + 1
    assert len(recs) == 1 and recs[0].spec_json == specs[1].to_json()
    assert (recs[0].stage, recs[0].error, recs[0].attempts) == \
        ("score", "RuntimeError", 2)
    assert rs[1].area_mm2 == TBE.QUARANTINE_AREA_MM2
    assert 0.0 < rs[0].accuracy <= 1.0 and rs[0].area_mm2 < 1e9
    events, _ = TR.read_trace(tmp_path / "t.jsonl")
    q = [e for e in events if e.get("name") == "eval.quarantine"]
    assert [e["attrs"]["stage"] for e in q] == ["score"]
    batch = [e for e in events if e.get("name") == "eval.batch"]
    assert batch[0]["attrs"]["requested"] == 2


def test_fig1_sweeps_match_reference():
    """Each sweep point is one serial `evaluate_spec`, as in the
    reference: with the reference's pretrained weights, accuracy within
    ACC_TOL and the integer pricing equal."""
    kw = dict(epochs=EPOCHS)
    ref = (RMZ.quant_sweep(CFG, (3, 5), **kw)
           + RMZ.prune_sweep(CFG, (0.3, 0.5), **kw)
           + RMZ.cluster_sweep(CFG, (3, 6), **kw))
    with reference_pretrain():
        got = (TMZ.quant_sweep(TCFG, (3, 5), device="cpu", **kw)
               + TMZ.prune_sweep(TCFG, (0.3, 0.5), device="cpu", **kw)
               + TMZ.cluster_sweep(TCFG, (3, 6), device="cpu", **kw))
        batched = TMZ.evaluate_specs(TCFG, [r.spec for r in got],
                                     device="cpu", **kw)
    assert [_tuple(r) for r in batched] == [_tuple(r) for r in got]
    for r, t in zip(ref, got):
        assert r.spec.to_json() == t.spec.to_json()
        assert abs(r.accuracy - t.accuracy) <= ACC_TOL, r.spec
        assert (r.area_mm2, r.n_multipliers, r.delay_levels) == \
            (t.area_mm2, t.n_multipliers, t.delay_levels), r.spec


def test_paper_run_with_approximation_and_fig1_on_cpu():
    reset_launches()
    res = paper.run("seeds", population=4, generations=2, epochs=8,
                    approx=True, device="cpu")
    assert res["device"] == "cpu" and LAUNCHES["netlist_sim"] == 0
    assert res["pareto_front"] and np.isfinite(res["combined_gain_at_5pct"])
    assert any(TM.from_json(k).has_approx for k in res["evaluations"])
    fig = paper.fig1(["seeds"], epochs=4, device="cpu")
    tech = fig["seeds"]["techniques"]
    assert [len(tech[t]["points"]) for t in
            ("quantization", "pruning", "clustering")] == [6, 5, 5]
    assert all(np.isfinite(tech[t]["gain_at_5pct"]) for t in tech)
    assert LAUNCHES["netlist_sim"] == 0


def test_paper_main_approximates_the_chosen_point_on_cpu(tmp_path, capsys):
    paper.main(["--dataset", "seeds", "--approx", "--device", "cpu",
                "--cache-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "structural cost == analytic hw_model: True" in out
    assert "logit-error budget (proven bound:" in out


def test_approximation_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: TMZ.evaluate_spec(TCFG, TA_SPECS[0], epochs=1),
                 lambda: TBE.evaluate_population(TCFG, TA_SPECS[:1],
                                                 epochs=1),
                 lambda: TMZ.evaluate_specs(TCFG, TA_SPECS[:1], epochs=1),
                 lambda: TMZ.quant_sweep(TCFG, (4,), epochs=1),
                 lambda: paper.run("seeds", population=2, generations=1,
                                   epochs=1, approx=True),
                 lambda: paper.fig1(["seeds"], epochs=1)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
