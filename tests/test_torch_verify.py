"""The port's verification layer (`repro_torch.verify`) against
`repro.verify`: the netlist verifier is clean on the port's sanctioned
producers (compiler, pass pipeline, budget fitter) on all four datasets'
architectures and catches every one of the 18 seeded corruptions with the
reference's rules; the PassManager's differential checks catch a pass that
breaks its declared invariants; the spec linter gives the reference's
diagnostics on the GA's gene lattice and on illegal genomes, its self-test
passes, and `evaluate_population` lints before any QAT under
REPRO_VERIFY."""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import itertools  # noqa: E402
import random  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from repro import approx as RAX  # noqa: E402
from repro import verify as RV  # noqa: E402
from repro.configs.printed_mlp import PRINTED_MLPS as R_MLPS  # noqa: E402
from repro.core import ga as RGA  # noqa: E402
from repro.core.compression_spec import LayerMin as RL  # noqa: E402
from repro.core.compression_spec import ModelMin as RM  # noqa: E402
from repro_torch import approx as TAX  # noqa: E402
from repro_torch import verify as TV  # noqa: E402
from repro_torch.circuit import ir as TIR  # noqa: E402
from repro_torch.configs.printed_mlp import PRINTED_MLPS  # noqa: E402
from repro_torch.core import batch_eval as TBE  # noqa: E402
from repro_torch.core import ga as TGA  # noqa: E402
from repro_torch.core.compression_spec import LayerMin as TL  # noqa: E402
from repro_torch.core.compression_spec import ModelMin as TM  # noqa: E402
from repro_torch.verify import spec as TSPEC  # noqa: E402
from test_torch_netlist_sim import synth  # noqa: E402

DATASET_PARAMS = {
    # modest synthetic stand-ins with each dataset's real layer dims, as
    # the reference's verifier tests use
    "whitewine": dict(sparsity=0.4, clusters=4, seed=11),
    "redwine": dict(sparsity=0.3, clusters=None, seed=12),
    "pendigits": dict(sparsity=0.6, clusters=8, seed=13),
    "seeds": dict(sparsity=0.0, clusters=4, seed=14),
}


def _nets(name):
    return synth(PRINTED_MLPS[name].layer_dims, 4, **DATASET_PARAMS[name])


@pytest.mark.parametrize("name", sorted(PRINTED_MLPS))
def test_verifier_clean_on_compiled_and_budgeted(name):
    _, net, _ = _nets(name)
    assert TV.verify_netlist(net, expect_exact=True, expect_dce=True) == []
    L = net.n_layers
    anet = TAX.approximate(net, TAX.ApproxParams((1,) * L, (2,) * L, 2))
    assert TV.verify_netlist(anet, expect_dce=True) == []
    _, bnet, rep = TAX.fit_budget(net, TAX.logit_budget(net, 0.03),
                                  max_csd_drop=2, max_lsb=4,
                                  max_argmax_lsb=3)
    assert TV.verify_netlist(bnet, expect_dce=True) == []
    assert rep.bound <= rep.budget


@pytest.fixture(scope="module")
def victims():
    rnet, tnet, _ = _nets("whitewine")
    knobs = ((1, 2), (2, 1), 3)
    return ((rnet, RAX.approximate(rnet, RAX.ApproxParams(*knobs))),
            (tnet, TAX.approximate(tnet, TAX.ApproxParams(*knobs))))


def test_catalog_matches_reference():
    assert len(TV.CATALOG) == len(RV.CATALOG) == 18
    for t, r in zip(TV.CATALOG, RV.CATALOG):
        assert (t.name, t.rules, t.strict_only, t.needs_dce) == \
            (r.name, r.rules, r.strict_only, r.needs_dce)


@pytest.mark.parametrize("i", range(len(TV.CATALOG)),
                         ids=[m.name for m in TV.CATALOG])
def test_mutation_detected_as_the_reference_detects_it(victims, i):
    (rnet, ranet), (tnet, tanet) = victims
    tm, rm = TV.CATALOG[i], RV.CATALOG[i]
    tbad = TV.apply_mutation(tanet, tm) or TV.apply_mutation(tnet, tm)
    rbad = RV.apply_mutation(ranet, rm) or RV.apply_mutation(rnet, rm)
    assert tbad is not None, f"{tm.name} inapplicable to both victims"
    diags = TV.verify_netlist(tbad, expect_dce=tm.needs_dce)
    fatal = {d.rule for d in diags
             if d.severity == TV.ERROR or tm.strict_only}
    assert fatal & tm.rules, (
        f"{tm.name}: expected one of {sorted(tm.rules)}, got "
        f"{sorted((d.severity, d.rule) for d in diags)}")
    rdiags = RV.verify_netlist(rbad, expect_dce=rm.needs_dce)
    assert [(d.severity, d.rule, d.message) for d in diags] == \
        [(d.severity, d.rule, d.message) for d in rdiags]
    with pytest.raises((TV.VerificationError, OverflowError)):
        TV.check_netlist(tbad, strict=True, expect_dce=tm.needs_dce)


def test_pass_manager_catches_a_cost_increase():
    from repro_torch.approx.rewrite import Pass, PassManager, rebuild

    class Inflate(Pass):
        """Claims monotone cost, then grows every multiplier."""
        name = "inflate"
        monotone_cost = True

        def run(self, net):
            def rw(new, old, n, m):
                if n.op != TIR.Op.SHL or n.role != TIR.ROLE_MULT:
                    return None
                # x<<s -> (x<<s - x<<0) + x<<0: same value, two extra
                # mult-tagged SHL wires — cost strictly up
                tags = dict(role=n.role, layer=n.layer, unit=n.unit)
                x = m[n.args[0]]
                a = new.shl(x, n.shift, **tags)
                out = new.add(new.sub(a, new.shl(x, 0, **tags), **tags),
                              new.shl(x, 0, **tags), **tags)
                new.nodes[out].product_root = n.product_root
                return out
            return rebuild(net, rw)

    _, net, _ = _nets("seeds")
    PassManager([Inflate()], verify=False).run(net)    # unverified: quiet
    with pytest.raises(TV.VerificationError) as e:
        PassManager([Inflate()], verify=True).run(net)
    assert any(d.rule == "pass-cost" for d in e.value.diagnostics)


def test_pass_manager_catches_a_bound_loss():
    from repro_torch.approx.rewrite import Pass, PassManager, rebuild

    class DropErr(Pass):
        """Erases an upstream pass's declared error annotations."""
        name = "drop-err"
        monotone_bound = True

        def run(self, net):
            out = rebuild(net, lambda new, old, n, m: None)
            for n in out.nodes:
                n.err_lo = n.err_hi = 0
            return out

    _, net, _ = _nets("seeds")
    anet = TAX.approximate(net, TAX.ApproxParams((2, 2), (0, 0), 0))
    assert TAX.logit_error_bound(anet) > 0
    with pytest.raises(TV.VerificationError) as e:
        PassManager([DropErr()], verify=True).run(anet)
    assert any(d.rule == "pass-bound" for d in e.value.diagnostics)


def _lattice(ModelMin, LayerMin, ga, cfg):
    """The self-test's genomes: every single-axis choice plus 60 seeded
    random combined genomes."""
    rng = random.Random(0)
    L = len(cfg.layer_dims) - 1
    out = [ModelMin.uniform(L, csd_drop=c, lsb=t, argmax_lsb=a)
           for c, t, a in itertools.product(
               ga.CSD_DROP_CHOICES, ga.LSB_CHOICES, ga.ARGMAX_LSB_CHOICES)]
    for axis, choices in (("bits", ga.BITS_CHOICES),
                          ("sparsity", ga.SPARSITY_CHOICES),
                          ("clusters", ga.CLUSTER_CHOICES)):
        out += [ModelMin.uniform(L, **{axis: c}) for c in choices]
    out += [ModelMin(tuple(LayerMin(rng.choice(ga.BITS_CHOICES),
                                    rng.choice(ga.SPARSITY_CHOICES),
                                    rng.choice(ga.CLUSTER_CHOICES),
                                    rng.choice(ga.CSD_DROP_CHOICES),
                                    rng.choice(ga.LSB_CHOICES))
                           for _ in range(L)),
                     8, rng.choice(ga.ARGMAX_LSB_CHOICES))
            for _ in range(60)]
    return out


def _diags(ds):
    return [(d.severity, d.rule, d.message) for d in ds]


@pytest.mark.parametrize("name", sorted(PRINTED_MLPS))
def test_lint_spec_matches_reference_on_the_gene_lattice(name):
    tcfg, rcfg = PRINTED_MLPS[name], R_MLPS[name]
    tspecs = _lattice(TM, TL, TGA, tcfg)
    rspecs = _lattice(RM, RL, RGA, rcfg)
    assert [s.to_json() for s in tspecs] == [s.to_json() for s in rspecs]
    n_warn = 0
    for t, r in zip(tspecs, rspecs):
        got = TV.lint_spec(t, tcfg)
        assert _diags(got) == _diags(RV.lint_spec(r, rcfg))
        assert TV.errors(got) == []
        n_warn += len(got)
    # the lattice's 12- and 16-cluster genes outnumber small layers'
    # outputs: degenerate, reported as warnings
    assert n_warn > 0


def _illegal(ModelMin, LayerMin):
    return [
        ModelMin((LayerMin(bits=1),), input_bits=8),
        ModelMin((LayerMin(bits=9), LayerMin(bits=4, sparsity=0.95))),
        ModelMin((LayerMin(bits=4, clusters=100),)),
        ModelMin((LayerMin(bits=4, csd_drop=9), LayerMin(bits=4, lsb=17))),
        ModelMin((LayerMin(bits=4),), argmax_lsb=17),
        ModelMin((LayerMin(bits=4),), input_bits=0),
        ModelMin((LayerMin(bits=np.int64(4)),)),
        ModelMin((LayerMin(bits=4, sparsity=np.float32(0.5)),)),
        ModelMin(()),
        ModelMin.uniform(3, bits=4),                # wrong layer count
        ModelMin.uniform(2, bits=4, clusters=16),   # degenerate: WARN
    ]


def test_lint_spec_matches_reference_on_illegal_genomes():
    tcfg, rcfg = PRINTED_MLPS["seeds"], R_MLPS["seeds"]
    tspecs, rspecs = _illegal(TM, TL), _illegal(RM, RL)
    for t, r in zip(tspecs, rspecs):
        got = TV.lint_spec(t, tcfg)
        assert got, t
        assert _diags(got) == _diags(RV.lint_spec(r, rcfg))
    assert _diags(TV.lint_specs(tspecs, tcfg)) == \
        _diags(RV.lint_specs(rspecs, rcfg))
    assert _diags(TV.lint_spec("not a spec")) == \
        _diags(RV.lint_spec("not a spec"))
    with pytest.raises(TV.VerificationError):
        TV.check_specs(tspecs, tcfg)
    TV.check_specs([TM.uniform(2, bits=b) for b in (2, 4, 8)], tcfg)


def test_spec_selftest_passes(capsys):
    assert TSPEC._selftest() == 0
    assert "0 error(s)" in capsys.readouterr().out


def test_evaluate_population_lints_before_any_qat(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("finetune ran on an illegal population")

    monkeypatch.setattr(TBE, "_population_finetune", boom)
    cfg = PRINTED_MLPS["seeds"]
    bad = [TM.uniform(2, bits=4), TM.uniform(2, bits=4, lsb=40)]
    monkeypatch.setenv("REPRO_VERIFY", "1")
    with pytest.raises(TV.VerificationError) as e:
        TBE.evaluate_population(cfg, bad, epochs=1, device="cpu")
    assert any(d.rule == "range" for d in e.value.diagnostics)
    # off, the linter is skipped and the population reaches the finetune
    monkeypatch.setenv("REPRO_VERIFY", "0")
    with pytest.raises(AssertionError, match="finetune ran"):
        TBE.evaluate_population(cfg, bad, epochs=1, device="cpu")
