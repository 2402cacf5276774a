"""The port's `circuit.simulate.Simulator` (torch integer ops) against
`repro.circuit.simulate.Simulator` (XLA), bit for bit: the schedule, the
per-layer pre-activations, the logits and the argmax class, on exact and
approximated netlists, in int32 and int64 lanes, with ties at the
comparator (first maximum wins in both) and TRUNC shifts at the clamp
(31 in int32 lanes, 61 in int64 lanes). Everything is integer: bit-exact
or wrong. The card-side Simulator is held against the CPU one by
``tests/test_torch_cuda.py``."""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import approx as RAX  # noqa: E402
from repro import circuit as RCIRC  # noqa: E402
from repro.circuit import ir as RIR  # noqa: E402
from repro.circuit.simulate import build_plan as r_build_plan  # noqa: E402
from repro_torch import approx as TAX  # noqa: E402
from repro_torch import circuit as TCIRC  # noqa: E402
from repro_torch.circuit import ir as TIR  # noqa: E402
from repro_torch.circuit.simulate import \
    build_plan as t_build_plan  # noqa: E402
from repro_torch.core import minimize as TMZ  # noqa: E402
from repro_torch.kernels import netlist_sim as TNS  # noqa: E402
from test_torch_cuda import clamp_net  # noqa: E402
from test_torch_netlist_sim import synth  # noqa: E402


def _approx_pair(dims, bits, params, **kw):
    rnet, tnet, c = synth(dims, bits, **kw)
    return (RAX.approximate(rnet, RAX.ApproxParams(*params)),
            TAX.approximate(tnet, TAX.ApproxParams(*params)), c)


def _cases():
    """name -> (reference net, port net, x (B, n_in) int64, lanes)."""
    rng = np.random.default_rng(5)
    out = {}
    for name, dims, bits, kw in (
            ("exact_small", (7, 8, 3), 8, {}),
            ("exact_sparse", (11, 10, 7), 6, dict(sparsity=0.5, seed=1)),
            ("exact_clustered", (16, 20, 10), 8,
             dict(sparsity=0.3, clusters=8, seed=2)),
            ("exact_deep", (5, 6, 6, 4), 7, dict(sparsity=0.2, seed=3)),
            ("exact_int64", (11, 12, 12, 7), 8, dict(seed=3))):
        rnet, tnet, _ = synth(dims, bits, **kw)
        out[name] = (rnet, tnet, rng.integers(0, 256, (37, dims[0])))
    for name, dims, bits, params, kw in (
            ("approx_csd", (11, 10, 7), 6, ((2, 2), (0, 0), 0),
             dict(seed=4)),
            ("approx_csd6_lsb", (11, 10, 7), 8, ((6, 6), (3, 2), 0),
             dict(sparsity=0.2, seed=5)),
            ("approx_lsb_at_clamp", (9, 8, 4), 5, ((0, 0), (16, 16), 0),
             dict(clusters=4, seed=6)),
            ("approx_argmax_ties", (7, 8, 4), 8, ((1, 1), (2, 2), 24),
             dict(seed=7)),
            ("approx_int64", (11, 12, 12, 7), 8, ((0, 0, 0), (0, 0, 0), 4),
             dict(seed=3))):
        rnet, tnet, _ = _approx_pair(dims, bits, params, **kw)
        out[name] = (rnet, tnet, rng.integers(0, 256, (41, dims[0])))
    for width in (32, 62):
        out[f"clamp_width{width}"] = (clamp_net(RIR, width),
                                      clamp_net(TIR, width),
                                      rng.integers(0, 256, (50, 3)))
    return out


CASES = _cases()
LANES = {"exact_int64": torch.int64, "approx_int64": torch.int64,
         "clamp_width32": torch.int32, "clamp_width62": torch.int64}


@pytest.mark.parametrize("case", sorted(CASES))
def test_simulator_bit_exact_against_reference(case):
    rnet, tnet, x = CASES[case]
    ref = RCIRC.Simulator(rnet).run(x)
    sim = TCIRC.Simulator(tnet, device="cpu")
    assert sim.dtype == LANES.get(case, torch.int32)
    assert (sim.dtype == torch.int64) == RCIRC.Simulator(rnet)._x64
    got = sim.run(x)
    assert len(got["pre"]) == len(ref["pre"])
    for a, b in zip(got["pre"], ref["pre"]):
        assert a.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got["logits"], ref["logits"])
    assert got["argmax"].dtype == np.int64
    np.testing.assert_array_equal(got["argmax"], ref["argmax"])
    # and the population engine's plain version and oracle agree
    pop = TNS.pack_population([tnet])
    for engine in ("levels", "ref"):
        out = TNS.simulate_population(pop, x, engine=engine, device="cpu")
        np.testing.assert_array_equal(out["argmax"][0], got["argmax"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_plan_equals_reference(case):
    rnet, tnet, _ = CASES[case]
    rp, tp = r_build_plan(rnet), t_build_plan(tnet)
    for f in ("const_ids", "const_vals", "input_ids", "output_ids",
              "argmax_ids"):
        np.testing.assert_array_equal(getattr(tp, f), getattr(rp, f))
    assert (tp.n_nodes, tp.max_width) == (rp.n_nodes, rp.max_width)
    assert len(tp.steps) == len(rp.steps)
    for a, b in zip(tp.steps, rp.steps):
        assert int(a.op) == int(b.op)
        for f in ("out", "a", "b"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    for a, b in zip(tp.pre_ids, rp.pre_ids):
        np.testing.assert_array_equal(a, b)


def test_exact_netlists_reproduce_integer_forward():
    rng = np.random.default_rng(11)
    for dims, bits, kw in (((7, 8, 3), 8, {}),
                           ((16, 20, 10), 8, dict(clusters=8, seed=2))):
        _, tnet, c = synth(dims, bits, **kw)
        xq = TMZ.quantize_inputs(c, rng.random((29, dims[0])))
        pres, cls = TMZ.integer_forward(c, xq)
        got = TCIRC.simulate(tnet, xq, device="cpu")
        for a, b in zip(got["pre"], pres):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["argmax"], cls)


def test_ties_take_the_first_maximum():
    """Truncated comparator operands tie on most samples; the decision is
    the first maximal operand, as numpy, jnp and K1 take it."""
    for name in ("approx_argmax_ties", "clamp_width32", "clamp_width62"):
        rnet, tnet, x = CASES[name]
        got = TCIRC.Simulator(tnet, device="cpu").run(x)
        pop = TNS.pack_population([tnet])
        amx = TNS.simulate_population(pop, x, engine="ref")["amx"][0]
        top = amx.max(axis=1, keepdims=True)
        ties = int(((amx == top).sum(axis=1) > 1).sum())
        assert ties > 0, name
        np.testing.assert_array_equal(got["argmax"],
                                      np.argmax(amx, axis=1))
        np.testing.assert_array_equal(
            got["argmax"], RCIRC.Simulator(rnet).run(x)["argmax"])


def test_trunc_at_the_clamp_reaches_the_lane_width():
    """The clamp cases shift by 31 in int32 lanes and 61 in int64 lanes,
    and TRUNC floors toward minus infinity at those counts."""
    for width, lanes in ((32, torch.int32), (62, torch.int64)):
        _, tnet, x = CASES[f"clamp_width{width}"]
        shifts = {n.shift for n in tnet.nodes if n.op == TIR.Op.TRUNC}
        assert shifts == {width - 1}
        sim = TCIRC.Simulator(tnet, device="cpu")
        assert sim.dtype == lanes
        logits = sim.run(x)["logits"]
        x = x.astype(np.int64)
        s = width - 9
        a = -(x[:, 0] << s)
        expect = (a >> (width - 1)) << (width - 1)
        np.testing.assert_array_equal(logits[:, 0], expect)
        assert set(np.unique(logits)) <= {0, -(1 << (width - 1))}


def test_single_sample_run_squeezes():
    rnet, tnet, x = CASES["approx_csd6_lsb"]
    got = TCIRC.Simulator(tnet, device="cpu").run(x[3])
    ref = RCIRC.Simulator(rnet).run(x[3])
    assert got["argmax"] == ref["argmax"] and np.ndim(got["argmax"]) == 0
    for a, b in zip(got["pre"], ref["pre"]):
        assert a.ndim == 1
        np.testing.assert_array_equal(a, b)


def test_simulator_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tnet, x = CASES["exact_small"]
    with pytest.raises(RuntimeError, match="CUDA"):
        TCIRC.Simulator(tnet)
    with pytest.raises(RuntimeError, match="CUDA"):
        TCIRC.simulate(tnet, x)
