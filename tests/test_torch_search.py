"""The port's fault-tolerant island search (`repro_torch.search`) and its
fault-tolerance helpers (`repro_torch.dist.fault_tolerance`).

* The cases of ``tests/test_fault_tolerance.py``, each one test
  parametrised over both packages.
* Under one synthetic evaluator and one `FaultHarness` plan (a straggler
  past the deadline, a migration, a kill), the port's `IslandFleet` and
  `SearchRuntime` equal the reference's: populations, histories,
  evaluations, events, fronts and metric snapshots.
* A checkpoint written by the reference's runtime, preempted after round
  2, resumes in the port and ends on the reference's uninterrupted front.
* The port's own fault runs, mirroring ``tests/test_search_faults.py``
  with the real batch evaluator on the CPU (``seeds``, 2 epochs,
  population 4, 2 islands, 4 rounds): preemption after rounds 1 and 3
  resumes byte-equal with zero re-evaluations; deterministic and
  transient eval faults are quarantined and absorbed by the retry; a NaN
  accuracy is quarantined; a torn `EvalCache` is salvaged and the search
  recovers; island kills lose no evaluation.
* `make_batch_evaluator` raises without a card unless asked for the CPU.
"""
import shutil

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import repro.search as RS  # noqa: E402
import repro.search.faults as RSF  # noqa: E402
import repro_torch.search as TS  # noqa: E402
from repro.core import ga as RGA  # noqa: E402
from repro.dist import fault_tolerance as RFT  # noqa: E402
from repro.obs import metrics as RMT  # noqa: E402
from repro.obs import prof as RPF  # noqa: E402
from repro_torch.configs.printed_mlp import PRINTED_MLPS  # noqa: E402
from repro_torch.core import batch_eval as BE  # noqa: E402
from repro_torch.core import ga as TGA  # noqa: E402
from repro_torch.core import minimize as MZ  # noqa: E402
from repro_torch.core.compression_spec import ModelMin  # noqa: E402
from repro_torch.core.ga import GAConfig  # noqa: E402
from repro_torch.dist import fault_tolerance as TFT  # noqa: E402
from repro_torch.obs import metrics as MT  # noqa: E402
from repro_torch.obs import prof as PF  # noqa: E402
from repro_torch.search import (EvalFault, FaultHarness, FaultPlan,  # noqa
                                IslandConfig, PreemptedError, SearchConfig,
                                SearchRuntime, inject_eval_faults)

FTS = pytest.mark.parametrize("FT", [RFT, TFT], ids=["repro", "repro_torch"])


# ---------------------------------------------------------------------------
# fault_tolerance, both packages
# ---------------------------------------------------------------------------


@FTS
def test_deadline_barrier_basic(FT):
    assert FT.deadline_barrier([0.1, 2.0, 0.5], 1.0) == [True, False, True]
    # boundary is inclusive: arriving exactly at the deadline participates
    assert FT.deadline_barrier([1.0], 1.0) == [True]


@FTS
def test_deadline_barrier_infinite_deadline_admits_all_but_inf(FT):
    inf = float("inf")
    # inf <= inf: callers (the island fleet) must mask dead hosts themselves
    assert FT.deadline_barrier([0.0, inf], inf) == [True, True]


@FTS
def test_redistribute_all_hosts_straggle_raises(FT):
    with pytest.raises(RuntimeError):
        FT.redistribute_batch(128, [False, False, False])
    with pytest.raises(RuntimeError):
        FT.redistribute_batch(0, [])


@FTS
def test_redistribute_single_survivor_takes_everything(FT):
    deal = FT.redistribute_batch(100, [False, True, False, False])
    assert deal == {0: 0, 1: 100, 2: 0, 3: 0}


@FTS
def test_redistribute_zero_batch(FT):
    deal = FT.redistribute_batch(0, [True, True, True])
    assert deal == {0: 0, 1: 0, 2: 0}


@FTS
@pytest.mark.parametrize("batch,alive", [
    (7, [True, True, True]),          # odd over 3
    (10, [True, False, True, True]),  # odd share over 3 survivors
    (1, [True, True]),                # fewer examples than hosts
    (97, [True] * 8),
])
def test_redistribute_sums_exact_and_balanced(FT, batch, alive):
    deal = FT.redistribute_batch(batch, alive)
    assert sum(deal.values()) == batch
    shares = [deal[i] for i, ok in enumerate(alive) if ok]
    dead = [deal[i] for i, ok in enumerate(alive) if not ok]
    assert all(d == 0 for d in dead)
    assert max(shares) - min(shares) <= 1
    assert deal == RFT.redistribute_batch(batch, alive)


@FTS
def test_should_checkpoint_now_cadence(FT):
    hits = [s for s in range(1, 11)
            if FT.should_checkpoint_now(s, every=3,
                                        preemption_requested=False)]
    assert hits == [3, 6, 9]


@FTS
def test_should_checkpoint_now_preemption_overrides(FT):
    assert FT.should_checkpoint_now(7, every=3, preemption_requested=True)
    assert FT.should_checkpoint_now(7, every=0, preemption_requested=True)
    assert not FT.should_checkpoint_now(7, every=0,
                                        preemption_requested=False)


# ---------------------------------------------------------------------------
# the fleet against the reference, one synthetic evaluator, one plan
# ---------------------------------------------------------------------------


def _synthetic(spec):
    bits = sum(l.bits for l in spec.layers)
    sp = sum(l.sparsity for l in spec.layers)
    return (bits / 16.0, sp)


def _cfg(pkg, rounds=6, islands=3, **kw):
    """A SearchConfig of package ``pkg`` (`repro.search` or
    `repro_torch.search`) with a 1-second straggler deadline."""
    GA = RGA if pkg is RS else TGA
    return pkg.SearchConfig(
        n_layers=2, rounds=rounds, ga=GA.GAConfig(population=6, seed=3),
        islands=pkg.IslandConfig(n_islands=islands, migration_every=2,
                                 migrants=1, deadline_s=1.0), **kw)


# island 2 arrives past the deadline in round 1 (ejected, its offspring
# dealt to the others), island 1 dies mid-round 3, migrations every 2
PLAN = dict(straggle={(1, 2): 5.0}, kill_island={1: 3})


def _run(pkg, faults, ckpt_root=None):
    harness = faults.FaultHarness(faults.FaultPlan(**PLAN))
    (RMT if pkg is RS else MT).REGISTRY.reset()
    res = pkg.SearchRuntime(_cfg(pkg, checkpoint_every=2),
                            evaluate=_synthetic, harness=harness,
                            ckpt_root=ckpt_root).run()
    return res, harness.log, (RMT if pkg is RS else MT).snapshot()


def _state(res):
    return ([[s.to_json() for s in st.population] for st in res.islands],
            [st.history for st in res.islands],
            [st.rng_state for st in res.islands],
            [st.generation for st in res.islands])


def test_fleet_equals_the_reference_under_one_fault_plan():
    ref, ref_log, ref_mt = _run(RS, RSF)
    got, log, mt = _run(TS, TS.faults)
    assert _state(got) == _state(ref)
    assert got.evaluations == ref.evaluations
    assert got.events == ref.events
    assert [s.to_json() for s in got.front_specs] == \
        [s.to_json() for s in ref.front_specs]
    assert got.front_objectives.tobytes() == ref.front_objectives.tobytes()
    assert log == ref_log == [("kill", 1, 3)]
    assert mt == ref_mt
    kinds = [e["event"] for e in got.events]
    assert {"straggler_ejected", "killed", "migration"} <= set(kinds)
    assert mt["counters"]["island.ejections"] == 1
    assert mt["counters"]["island.kills"] == 1
    assert [st.generation for st in got.islands] == [6, 3, 5]


def test_checkpoints_carry_the_reference_contents(tmp_path):
    """Both runtimes checkpoint the same leaves and meta for the same run
    (the metrics and profile snapshots are each package's own)."""
    RPF.reset()
    PF.reset()
    _run(RS, RSF, ckpt_root=tmp_path / "r")
    _run(TS, TS.faults, ckpt_root=tmp_path / "t")
    for step in (2, 4, 6):
        r, rmeta = RS.runtime.CheckpointManager(tmp_path / "r").restore(
            step, like={"rng": 0, "generation": 0})
        t, tmeta = TS.runtime.CheckpointManager(tmp_path / "t").restore(
            step, like={"rng": 0, "generation": 0})
        for k in ("rng", "generation"):
            assert np.asarray(t[k]).tobytes() == np.asarray(r[k]).tobytes()
        # wall-clock fields (durations, the write-time histograms) aside
        clock = ("last_duration_s", "metrics")
        assert {k: v for k, v in tmeta.items() if k not in clock} \
            == {k: v for k, v in rmeta.items() if k not in clock}
        assert tmeta["metrics"]["counters"] == rmeta["metrics"]["counters"]


# ---------------------------------------------------------------------------
# a reference checkpoint resumes in the port
# ---------------------------------------------------------------------------


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    plain = dict(straggle={}, kill_island={})
    base = RS.SearchRuntime(_cfg(RS), evaluate=_synthetic).run()
    RMT.REGISTRY.reset()
    rt = RS.SearchRuntime(_cfg(RS), evaluate=_synthetic, ckpt_root=tmp_path,
                          harness=RSF.FaultHarness(RSF.FaultPlan(
                              preempt_at=2, **plain)))
    with pytest.raises(RS.PreemptedError):
        rt.run()
    MT.REGISTRY.reset()
    PF.reset()
    rt2 = SearchRuntime.resume(_cfg(TS), tmp_path, evaluate=_synthetic)
    assert rt2.fleet.round == 3
    assert MT.snapshot()["counters"]["fleet.rounds"] == 3
    res = rt2.run()
    assert [s.to_json() for s in res.front_specs] == \
        [s.to_json() for s in base.front_specs]
    assert res.front_objectives.tobytes() == base.front_objectives.tobytes()
    assert res.evaluations == base.evaluations
    assert _state(res) == _state(base)


# ---------------------------------------------------------------------------
# island kills (synthetic evaluator)
# ---------------------------------------------------------------------------


def _synthetic_cfg(rounds=4, islands=3):
    return SearchConfig(
        n_layers=2, rounds=rounds, ga=GAConfig(population=6, seed=3),
        islands=IslandConfig(n_islands=islands, migration_every=2,
                             migrants=1))


def _assert_same_front(res, base):
    assert [s.to_json() for s in res.front_specs] == \
        [s.to_json() for s in base.front_specs]
    np.testing.assert_array_equal(res.front_objectives,
                                  base.front_objectives)
    assert res.evaluations == base.evaluations


def test_island_kill_loses_no_completed_evaluation():
    harness = FaultHarness(FaultPlan(kill_island={1: 1}))
    res = SearchRuntime(_synthetic_cfg(), evaluate=_synthetic,
                        harness=harness).run()
    assert [st.generation for st in res.islands] == [4, 1, 4]
    kill_events = [e for e in res.events if e["event"] == "killed"]
    assert len(kill_events) == 1 and kill_events[0]["island"] == 1
    assert harness.log == [("kill", 1, 1)]
    for spec in res.islands[1].population:
        assert spec.to_json() in res.evaluations


def test_all_islands_killed_raises():
    harness = FaultHarness(FaultPlan(kill_island={0: 0, 1: 0, 2: 0}))
    with pytest.raises(RuntimeError, match="every island is dead"):
        SearchRuntime(_synthetic_cfg(), evaluate=_synthetic,
                      harness=harness).run()


def test_kill_then_preempt_then_resume_keeps_dead_island_dead(tmp_path):
    plan = FaultPlan(kill_island={1: 1}, preempt_at=2)
    rt = SearchRuntime(_synthetic_cfg(), evaluate=_synthetic,
                       ckpt_root=tmp_path, harness=FaultHarness(plan))
    with pytest.raises(PreemptedError):
        rt.run()
    res = SearchRuntime.resume(_synthetic_cfg(), tmp_path,
                               evaluate=_synthetic).run()
    assert [st.generation for st in res.islands] == [4, 1, 4]
    ref = SearchRuntime(_synthetic_cfg(), evaluate=_synthetic,
                        harness=FaultHarness(
                            FaultPlan(kill_island={1: 1}))).run()
    _assert_same_front(res, ref)


def test_resume_without_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        SearchRuntime.resume(_synthetic_cfg(), tmp_path / "empty",
                             evaluate=_synthetic)


# ---------------------------------------------------------------------------
# the port's own fault runs with the real batch evaluator, on the CPU
# ---------------------------------------------------------------------------

EPOCHS = 2
SEED = 0
DS = "seeds"


def _search_cfg(rounds: int = 4) -> SearchConfig:
    cfg = PRINTED_MLPS[DS]
    return SearchConfig(
        n_layers=len(cfg.layer_dims) - 1, rounds=rounds,
        ga=GAConfig(population=4, seed=5, input_bits=cfg.input_bits),
        islands=IslandConfig(n_islands=2, migration_every=2, migrants=1))


def _evaluator(cache_dir, quarantine=None):
    cache = BE.EvalCache(cache_dir / f"{DS}_torch_evals.json")
    return BE.make_batch_evaluator(PRINTED_MLPS[DS], epochs=EPOCHS,
                                   seed=SEED, cache=cache,
                                   quarantine=quarantine,
                                   device="cpu"), cache


@pytest.fixture(scope="module")
def cache_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("eval_caches")


@pytest.fixture(scope="module")
def baseline(cache_dir):
    """The uninterrupted search: the ground truth every faulted or resumed
    run must reproduce byte for byte."""
    be, cache = _evaluator(cache_dir)
    return SearchRuntime(_search_cfg(), batch_evaluate=be,
                         eval_cache=cache).run()


def _count_real_evals(monkeypatch):
    """Every spec reaching `_compile_and_price` paid a real QAT finetune;
    cache hits never get there."""
    evaluated = []
    orig = BE._compile_and_price

    def counting(params_pop, specs, *a, **kw):
        evaluated.extend(s.to_json() for s in specs)
        return orig(params_pop, specs, *a, **kw)

    monkeypatch.setattr(BE, "_compile_and_price", counting)
    return evaluated


@pytest.mark.parametrize("kill_round", [1, 3])
def test_preempt_resume_bit_identical(kill_round, cache_dir, baseline,
                                      tmp_path, monkeypatch):
    be, cache = _evaluator(cache_dir)
    rt = SearchRuntime(_search_cfg(), batch_evaluate=be, ckpt_root=tmp_path,
                       harness=FaultHarness(FaultPlan(preempt_at=kill_round)),
                       eval_cache=cache)
    with pytest.raises(PreemptedError):
        rt.run()
    assert rt.mgr.latest_step() == kill_round + 1   # preemption flushed
    # "new process": fresh evaluator and cache handle over the same disk
    evaluated = _count_real_evals(monkeypatch)
    be2, cache2 = _evaluator(cache_dir)
    res = SearchRuntime.resume(_search_cfg(), tmp_path, batch_evaluate=be2,
                               eval_cache=cache2).run()
    _assert_same_front(res, baseline)
    assert evaluated == []


QSPECS = [ModelMin.uniform(2, bits=8), ModelMin.uniform(2, bits=3),
          ModelMin.uniform(2, bits=5, sparsity=0.3)]


@pytest.fixture(scope="module")
def clean_results():
    return BE.evaluate_population(PRINTED_MLPS[DS], QSPECS, epochs=EPOCHS,
                                  seed=SEED, device="cpu")


def test_deterministic_eval_fault_quarantined(clean_results):
    bad = QSPECS[1].to_json()
    q = []
    with inject_eval_faults([EvalFault(spec_json=bad, fail_attempts=2)]):
        rs = BE.evaluate_population(PRINTED_MLPS[DS], QSPECS, epochs=EPOCHS,
                                    seed=SEED, quarantine=q, device="cpu")
    assert rs[1].accuracy == 0.0
    assert rs[1].area_mm2 == BE.QUARANTINE_AREA_MM2
    assert rs[1].delay_levels == BE.QUARANTINE_DELAY_LEVELS
    (rec,) = q
    assert (rec.spec_json, rec.error, rec.attempts) == \
        (bad, "OverflowError", 2)
    assert "netlist sim budget" in rec.message
    for i in (0, 2):
        assert rs[i] == clean_results[i]


def test_transient_eval_fault_absorbed_by_retry(clean_results):
    bad = QSPECS[0].to_json()
    q = []
    with inject_eval_faults([EvalFault(spec_json=bad,
                                       fail_attempts=1)]) as hook:
        rs = BE.evaluate_population(PRINTED_MLPS[DS], QSPECS, epochs=EPOCHS,
                                    seed=SEED, quarantine=q, device="cpu")
    assert hook.triggered == [(bad, 1)]
    assert q == []
    assert rs[0] == clean_results[0]


def test_nan_accuracy_quarantined(monkeypatch):
    monkeypatch.setattr(MZ, "compiled_accuracy",
                        lambda c, x, y: float("nan"))
    q = []
    rs = BE.evaluate_population(PRINTED_MLPS[DS], [QSPECS[0]],
                                epochs=EPOCHS, seed=SEED, quarantine=q,
                                netlist=False, device="cpu")
    assert rs[0].accuracy == 0.0
    (rec,) = q
    assert (rec.stage, rec.error) == ("score", "FloatingPointError")
    assert "NaN accuracy" in rec.message


def test_quarantine_surfaces_on_the_search_result():
    """A fleet whose spec fails deterministically still finishes, with the
    record on the result and the spec off the front."""
    cfg = _search_cfg(rounds=2)
    bad = TGA.init_ga_state(cfg.n_layers, cfg.ga).population[0]
    q = []
    be = BE.make_batch_evaluator(PRINTED_MLPS[DS], epochs=EPOCHS, seed=SEED,
                                 quarantine=q, device="cpu")
    with inject_eval_faults([EvalFault(spec_json=bad.to_json(),
                                       fail_attempts=2)]):
        res = SearchRuntime(cfg, batch_evaluate=be, quarantine=q).run()
    assert [r.spec_json for r in res.quarantined] == [bad.to_json()]
    assert bad.to_json() not in {s.to_json() for s in res.front_specs}
    assert res.evaluations[bad.to_json()][1] == BE.QUARANTINE_AREA_MM2


def test_torn_cache_salvaged_and_search_recovers(cache_dir, baseline,
                                                 tmp_path, monkeypatch):
    be, cache = _evaluator(cache_dir)
    ref = SearchRuntime(_search_cfg(rounds=3), batch_evaluate=be,
                        eval_cache=cache).run()
    torn_path = tmp_path / "torn.json"
    shutil.copy(cache_dir / f"{DS}_torch_evals.json", torn_path)
    evaluated = _count_real_evals(monkeypatch)
    # a fully warm replay batches its recency-only flushes; force them
    # eager so the first flush after the tear re-reads (and salvages) disk
    monkeypatch.setattr(BE.EvalCache, "TOUCH_FLUSH_EVERY", 1)
    MT.REGISTRY.reset()
    cache2 = BE.EvalCache(torn_path)
    be2 = BE.make_batch_evaluator(PRINTED_MLPS[DS], epochs=EPOCHS,
                                  seed=SEED, cache=cache2, device="cpu")
    harness = FaultHarness(FaultPlan(tear_cache_at=2), cache_path=torn_path)
    with pytest.warns(UserWarning, match="corrupt"):
        res = SearchRuntime(_search_cfg(rounds=3), batch_evaluate=be2,
                            harness=harness, eval_cache=cache2).run()
    assert any(ev[0] == "tear_cache" for ev in harness.log)
    _assert_same_front(res, ref)
    assert evaluated == []
    assert MT.snapshot()["counters"]["cache.salvages"] == 1
    assert torn_path.with_suffix(".json.corrupt").exists()
    assert len(BE.EvalCache(torn_path)) == len(cache2)


def test_make_batch_evaluator_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BE.make_batch_evaluator(PRINTED_MLPS[DS], epochs=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        BE.make_batch_evaluator(PRINTED_MLPS[DS], epochs=1, device="cuda")
    assert callable(BE.make_batch_evaluator(PRINTED_MLPS[DS], epochs=1,
                                            device="cpu"))
