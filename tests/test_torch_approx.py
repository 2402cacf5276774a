"""The port's approximation subsystem (`repro_torch.approx`) against
`repro.approx`, from the same integer compiled parameters:

* every pass, alone and composed, gives node-equal netlists in both
  packages (op, args, shift, value, lo/hi, width, err_lo/err_hi, roles,
  tags, the product-root flag, the classifier bookkeeping);
* the proven bounds (`logit_error_bound`, `decision_error_bound`, the
  per-node error intervals) and `structural_cost` are equal;
* `fit_budget` takes the same steps to the same knobs;
* on all four datasets' architectures and test inputs the measured max
  logit error (the port's `Simulator`) is <= the proven bound and equals
  the reference's;
* `evaluate_netlist` scores as the reference does, and K1's plain version
  equals the reference's `population_accuracy` on a population mixing
  exact and approximated netlists;
* the PassManager's three paths (plain, traced, verified) agree.

Everything compared here is integer: equal or wrong. With REPRO_VERIFY on
(``tests/conftest.py``) every pass also runs the verifier and the
differential checks, so the nets stay narrow.
"""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import ast  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import approx as RAX  # noqa: E402
from repro import circuit as RCIRC  # noqa: E402
from repro.core import hw_model as RHW  # noqa: E402
from repro.core.compression_spec import ModelMin as RM  # noqa: E402
from repro.kernels import netlist_sim as RNS  # noqa: E402
from repro_torch import approx as TAX  # noqa: E402
from repro_torch import circuit as TCIRC  # noqa: E402
from repro_torch.circuit import ir as TIR  # noqa: E402
from repro_torch.configs.printed_mlp import PRINTED_MLPS  # noqa: E402
from repro_torch.core import minimize as TMZ  # noqa: E402
from repro_torch.core.compression_spec import ModelMin as TM  # noqa: E402
from repro_torch.data.uci import dataset_for  # noqa: E402
from repro_torch.kernels import netlist_sim as TNS  # noqa: E402
from repro_torch.obs import metrics as MT  # noqa: E402
from repro_torch.obs import trace as TR  # noqa: E402
from test_torch_netlist_sim import synth  # noqa: E402

REPO = Path(__file__).resolve().parents[1]

NETS = {  # name: (dims, bits, synth kwargs)
    "small": ((7, 8, 3), 8, dict(seed=1)),
    "sparse": ((11, 10, 7), 6, dict(sparsity=0.5, seed=2)),
    "clustered": ((11, 10, 7), 4, dict(clusters=4, seed=3)),
    "deep": ((5, 6, 6, 4), 7, dict(sparsity=0.2, seed=4)),
}

KNOBS = {  # name: (csd_drop per layer, lsb per layer, argmax_lsb)
    "identity": (0, 0, 0),
    "csd1": (1, 0, 0),
    "csd6": (6, 0, 0),
    "lsb3": (0, 3, 0),
    "lsb_clamp": (0, 16, 0),
    "argmax4": (0, 0, 4),
    "all": (2, 2, 3),
    "heavy": (6, 10, 8),
}


def _params(AX, L, knob):
    c, t, a = KNOBS[knob]
    return AX.ApproxParams((c,) * L, (t,) * L, a)


def assert_same_netlist(r, t):
    assert len(r.nodes) == len(t.nodes)
    for a, b in zip(r.nodes, t.nodes):
        assert (int(a.op), a.args, a.shift, a.value, a.lo, a.hi, a.width,
                a.err_lo, a.err_hi, a.role, a.layer, a.unit,
                a.product_root) == \
            (int(b.op), b.args, b.shift, b.value, b.lo, b.hi, b.width,
             b.err_lo, b.err_hi, b.role, b.layer, b.unit, b.product_root)
    assert r.layer_pre_ids == t.layer_pre_ids
    assert r.output_ids == t.output_ids
    assert r.input_ids == t.input_ids
    assert r.argmax_id == t.argmax_id
    assert (r.in_bits, list(r.w_bits)) == (t.in_bits, list(t.w_bits))


def assert_same_bounds_and_cost(r, t):
    assert TAX.propagate_errors(t) == RAX.propagate_errors(r)
    assert TAX.logit_error_bound(t) == RAX.logit_error_bound(r)
    assert TAX.decision_error_bound(t) == RAX.decision_error_bound(r)
    sr, st = RCIRC.structural_cost(r), TCIRC.structural_cost(t)
    assert (st.total_fa, st.area_mm2, st.power_mw, st.n_multipliers,
            st.argmax_fa) == (sr.total_fa, sr.area_mm2, sr.power_mw,
                              sr.n_multipliers, sr.argmax_fa)
    assert t.critical_path_levels() == r.critical_path_levels()


@pytest.mark.parametrize("knob", sorted(KNOBS))
@pytest.mark.parametrize("net", sorted(NETS))
def test_pipeline_node_equal_bounds_and_cost(net, knob):
    dims, bits, kw = NETS[net]
    rnet, tnet, _ = synth(dims, bits, **kw)
    L = tnet.n_layers
    r = RAX.approximate(rnet, _params(RAX, L, knob))
    t = TAX.approximate(tnet, _params(TAX, L, knob))
    assert_same_netlist(r, t)
    assert_same_bounds_and_cost(r, t)
    if knob == "lsb_clamp":
        # every product truncated at its word width - 1
        assert any(n.op == TIR.Op.TRUNC
                   and n.shift == t.nodes[n.args[0]].width - 1
                   for n in t.nodes)


@pytest.mark.parametrize("which", ["csd", "trunc", "acts"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_each_pass_alone_node_equal(net, which):
    dims, bits, kw = NETS[net]
    rnet, tnet, _ = synth(dims, bits, **kw)
    L = tnet.n_layers

    def make(AX):
        return {"csd": AX.RoundCoeffsCSD([2] * L),
                "trunc": AX.TruncateAccum([3] * L),
                "acts": AX.SimplifyActs(5)}[which]

    r = RAX.PassManager([make(RAX)]).run(rnet)
    t = TAX.PassManager([make(TAX)]).run(tnet)
    assert_same_netlist(r, t)
    assert_same_bounds_and_cost(r, t)
    # the rebuild walk alone (no DCE) too
    assert_same_netlist(make(RAX).run(rnet), make(TAX).run(tnet))


def test_truncate_csd_and_product_info_equal():
    for c in list(range(-300, 301)) + [2 ** 17 - 3, -(2 ** 20) + 5]:
        if c == 0:
            continue
        digits = RHW.csd_digits(c)
        for drop in range(len(digits) + 2):
            assert TAX.truncate_csd(c, drop) == RAX.truncate_csd(c, drop)
    rnet, tnet, _ = synth((7, 8, 3), 8, seed=9)
    roots = [n.id for n in tnet.nodes
             if n.product_root and n.role == TIR.ROLE_MULT]
    assert roots
    for i in roots:
        assert TAX.product_info(tnet, i) == RAX.product_info(rnet, i)


@pytest.mark.parametrize("net", ["small", "clustered"])
def test_fit_budget_same_steps_and_params(net):
    dims, bits, kw = NETS[net]
    rnet, tnet, c = synth(dims, bits, **kw)
    assert TAX.logit_budget(tnet, 0.01) == RAX.logit_budget(rnet, 0.01)
    budget = TAX.logit_budget(tnet, 0.01)
    caps = dict(max_csd_drop=3, max_lsb=5, max_argmax_lsb=4)
    rp, rb, rrep = RAX.fit_budget(rnet, budget, **caps)
    tp, tb, trep = TAX.fit_budget(tnet, budget, **caps)
    assert (tp.csd_drop, tp.lsb, tp.argmax_lsb) == \
        (rp.csd_drop, rp.lsb, rp.argmax_lsb)
    assert trep.steps == rrep.steps and trep.steps
    assert (trep.bound, trep.logit_bound, trep.exact_fa, trep.approx_fa,
            trep.budget) == (rrep.bound, rrep.logit_bound, rrep.exact_fa,
                             rrep.approx_fa, rrep.budget)
    assert trep.bound <= budget and trep.area_gain > 1.0
    assert_same_netlist(rb, tb)
    # a zero budget keeps the identity knobs
    p0, _, rep0 = TAX.fit_budget(tnet, 0, **caps)
    assert p0.is_identity and rep0.bound == 0


@pytest.mark.parametrize("dataset", sorted(PRINTED_MLPS))
def test_measured_error_sound_and_equal_on_dataset(dataset):
    """Each dataset's architecture and test inputs: the measured max logit
    error of three knob vectors is <= the proven bound, and the port's
    Simulator measures exactly what the reference's does."""
    cfg = PRINTED_MLPS[dataset]
    rnet, tnet, c = synth(cfg.layer_dims, 4, sparsity=0.4, clusters=8,
                          seed=len(dataset))
    _, _, xte, _ = dataset_for(cfg)
    xte = xte[:400]
    L = tnet.n_layers
    for knobs in (((1,) * L, (0,) * L, 0), ((0,) * L, (3,) * L, 0),
                  ((1,) * L, (2,) * L, 3)):
        r = RAX.approximate(rnet, RAX.ApproxParams(*knobs))
        t = TAX.approximate(tnet, TAX.ApproxParams(*knobs))
        measured = TAX.measured_max_logit_error(t, c, xte, device="cpu")
        assert measured <= TAX.logit_error_bound(t)
        assert measured == RAX.measured_max_logit_error(r, c, xte)


def test_evaluate_netlist_scores_as_the_reference():
    cfg = PRINTED_MLPS["seeds"]
    rnet, tnet, c = synth(cfg.layer_dims, 5, sparsity=0.2, seed=21)
    _, _, xte, yte = dataset_for(cfg)
    for kw in (dict(csd_drop=1, lsb=2), dict(argmax_lsb=6),
               dict(csd_drop=3, lsb=4, argmax_lsb=2)):
        rs = RM.uniform(2, bits=5, sparsity=0.2, **kw)
        ts = TM.uniform(2, bits=5, sparsity=0.2, **kw)
        r = RAX.evaluate_netlist(rnet, c, rs, xte, yte)
        t = TAX.evaluate_netlist(tnet, c, ts, xte, yte, device="cpu")
        assert t.spec.to_json() == r.spec.to_json()
        assert (t.accuracy, t.area_mm2, t.power_mw, t.n_multipliers,
                t.delay_levels) == (r.accuracy, r.area_mm2, r.power_mw,
                                    r.n_multipliers, r.delay_levels)


def test_k1_plain_version_on_a_mixed_population_equals_reference():
    """Exact and approximated netlists in one packed population (TRUNC
    slots, comparator operands that are not the logits): the port's plain
    version and oracle equal the reference's population accuracy."""
    cfg = PRINTED_MLPS["whitewine"]
    _, _, xte, yte = dataset_for(cfg)
    rnets, tnets, cs = [], [], []
    for i, (bits, knobs) in enumerate(((8, None), (6, ((1, 1), (2, 2), 0)),
                                       (4, ((6, 6), (16, 16), 8)),
                                       (5, None), (8, ((0, 0), (0, 0), 24)))):
        rnet, tnet, c = synth(cfg.layer_dims, bits, sparsity=0.3, seed=i)
        if knobs is not None:
            rnet = RAX.approximate(rnet, RAX.ApproxParams(*knobs))
            tnet = TAX.approximate(tnet, TAX.ApproxParams(*knobs))
        rnets.append(rnet)
        tnets.append(tnet)
        cs.append(c)
    xq = np.stack([TMZ.quantize_inputs(c, xte) for c in cs])
    rpop, tpop = RNS.pack_population(rnets), TNS.pack_population(tnets)
    assert (tpop.op == int(TIR.Op.TRUNC)).any()
    for f in ("op", "arg_a", "arg_b", "shift", "val", "level_ptr",
              "input_pos", "argmax_pos", "n_nodes"):
        np.testing.assert_array_equal(getattr(tpop, f), getattr(rpop, f))
    ref = RNS.population_accuracy(rpop, xq, yte)
    got = TNS.population_accuracy(tpop, xq, yte, device="cpu")
    np.testing.assert_array_equal(got, ref)
    oracle = TNS.simulate_population(tpop, xq, engine="ref")
    plain = TNS.simulate_population(tpop, xq, engine="levels", device="cpu")
    np.testing.assert_array_equal(plain["amx"], oracle["amx"])
    np.testing.assert_array_equal(plain["argmax"], oracle["argmax"])
    amx = oracle["amx"]
    ties = (amx == amx.max(axis=-1, keepdims=True)).sum(axis=-1) > 1
    assert ties.any()


def test_pass_manager_paths_agree_and_trace(tmp_path):
    """Plain, traced and verified pipelines give the same netlist; the
    traced one writes one ``approx.pass`` span per pass and counts it."""
    rnet, tnet, _ = synth((11, 10, 7), 6, sparsity=0.3, seed=5)
    passes = TAX.build_passes(TAX.ApproxParams((1, 2), (2, 1), 3))
    assert [p.name for p in passes] == \
        [p.name for p in RAX.build_passes(RAX.ApproxParams((1, 2), (2, 1),
                                                           3))]
    plain = TAX.PassManager(passes, verify=False).run(tnet)
    verified = TAX.PassManager(passes, verify=True).run(tnet)
    before = MT.counter("approx.passes").value
    with TR.capture(tmp_path / "t.jsonl"):
        traced = TAX.PassManager(passes, verify=False).run(tnet)
    assert MT.counter("approx.passes").value == before + len(passes)
    assert_same_netlist(plain, verified)
    assert_same_netlist(plain, traced)
    recs, damaged = TR.read_trace(tmp_path / "t.jsonl")
    spans = [r for r in recs if r.get("name") == "approx.pass"]
    assert damaged == 0
    assert [s["attrs"]["pass_name"] for s in spans] == \
        [p.name for p in passes]
    assert all(s["attrs"]["cost_delta"] <= 0 for s in spans)


def test_empty_pipeline_is_identity():
    _, tnet, c = synth((16, 20, 10), 8, sparsity=0.3, clusters=8, seed=11)
    out = TAX.PassManager([]).run(tnet)
    assert_same_netlist(tnet, out)
    assert TCIRC.cross_validate(out, c)["ok"]
    x = np.random.default_rng(3).random((13, 16)).astype(np.float32)
    xq = TMZ.quantize_inputs(c, x)
    pres, cls = TMZ.integer_forward(c, xq)
    got = TCIRC.Simulator(out, device="cpu").run(xq)
    np.testing.assert_array_equal(got["argmax"], cls)
    assert TAX.logit_error_bound(out) == TAX.decision_error_bound(out) == 0


def test_analyze_is_pure_python_ints():
    """The proofs must not depend on float semantics: `approx.analyze`
    imports neither numpy nor torch."""
    tree = ast.parse((REPO / "src/repro_torch/approx/analyze.py")
                     .read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module.split(".")[0])
    assert mods <= {"__future__", "typing", "repro_torch"}
    assert not mods & {"numpy", "torch"}
