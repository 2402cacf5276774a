"""The port's single-spec pipeline (`repro_torch.core.minimize`, the
circuit compiler) against `repro.core.minimize` / `repro.circuit`.

With the reference's pretrained and QAT-finetuned weights injected, every
integer stage — `compile_bespoke`, `integer_biases`, `integer_forward`, the
netlist node for node, its structural cost — is bit-exact. Training is a
float stage: from the same injected weights the port's Adam loop stays
within ``TRAIN_ATOL`` of the reference. Its float32 sums (matmuls,
log-softmax, the batch mean, k-means centroids) reduce in another order
than XLA's, and Adam's normalised steps keep that drift near float32
rounding (2e-6 observed after 30 QAT epochs, 2e-5 after 600 pretraining
epochs); the bound is set above both with margin.
"""
import functools

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import circuit as RCIRC  # noqa: E402
from repro.configs.printed_mlp import PRINTED_MLPS  # noqa: E402
from repro.core import minimize as RMZ  # noqa: E402
from repro.core.compression_spec import ModelMin as RModelMin  # noqa: E402
from repro.data import uci as RUCI  # noqa: E402
from repro_torch import circuit as TCIRC  # noqa: E402
from repro_torch.configs.printed_mlp import \
    PRINTED_MLPS as T_PRINTED_MLPS  # noqa: E402
from repro_torch.core import minimize as TMZ  # noqa: E402
from repro_torch.core.compression_spec import \
    ModelMin as TModelMin  # noqa: E402
from repro_torch.data import uci as TUCI  # noqa: E402
from repro_torch.nn import mlp as TM  # noqa: E402

TRAIN_ATOL = 1e-4

SPEC_KW = [dict(bits=8), dict(bits=3, sparsity=0.3),
           dict(bits=4, sparsity=0.4, clusters=8), dict(bits=6, clusters=3)]


@functools.lru_cache(maxsize=None)
def _ref_pretrained(dataset):
    params, data = RMZ.pretrain(PRINTED_MLPS[dataset], seed=0)
    return jax.tree_util.tree_map(np.asarray, params), data


def _np_params(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _maxdiff(ref, got):
    return max(float(np.abs(np.asarray(a[k]) - b[k].detach().cpu().numpy())
                     .max())
               for a, b in zip(ref["layers"], got["layers"]) for k in "wb")


@pytest.mark.parametrize("dataset", ["seeds", "redwine", "whitewine",
                                     "pendigits"])
def test_configs_and_data_equal(dataset):
    assert T_PRINTED_MLPS[dataset].layer_dims == \
        PRINTED_MLPS[dataset].layer_dims
    for a, b in zip(TUCI.make_dataset(dataset), RUCI.make_dataset(dataset)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dataset", ["seeds", "redwine", "whitewine",
                                     "pendigits"])
def test_integer_stages_bit_exact_with_injected_weights(dataset):
    """Reference QAT weights -> both compilers: CompiledMLP, integer biases,
    integer forward, netlist (node for node) and costs all equal; the
    port's netlist-exact accuracy (plain engine on the CPU) equals its
    integer forward."""
    cfg = PRINTED_MLPS[dataset]
    p0, (xtr, ytr, xte, yte) = _ref_pretrained(dataset)
    n = len(cfg.layer_dims) - 1
    for kw in SPEC_KW:
        rspec, tspec = RModelMin.uniform(n, **kw), TModelMin.uniform(n, **kw)
        rmasks = RMZ.make_masks(p0, rspec)
        tmasks = TMZ.make_masks(TM.params_from_numpy(p0, "cpu"), tspec)
        for a, b in zip(rmasks, tmasks):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), b.numpy())
        pq = _np_params(RMZ.qat_finetune(p0, rspec, rmasks, xtr, ytr,
                                         epochs=3))
        cr = RMZ.compile_bespoke(pq, rspec, rmasks)
        ct = TMZ.compile_bespoke(TM.params_from_numpy(pq, "cpu"), tspec,
                                 tmasks)
        for f in ("q_layers", "biases"):
            for a, b in zip(getattr(cr, f), getattr(ct, f)):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert cr.scales == ct.scales and cr.w_bits == ct.w_bits
        for a, b in zip(cr.clusters, ct.clusters):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
        for a, b in zip(RMZ.integer_biases(cr), TMZ.integer_biases(ct)):
            np.testing.assert_array_equal(a, b)
        xq = TMZ.quantize_inputs(ct, xte)
        np.testing.assert_array_equal(xq, RMZ.quantize_inputs(cr, xte))
        pr_r, cls_r = RMZ.integer_forward(cr, xq)
        pr_t, cls_t = TMZ.integer_forward(ct, xq)
        np.testing.assert_array_equal(cls_r, cls_t)
        for a, b in zip(pr_r, pr_t):
            np.testing.assert_array_equal(a, b)
        assert TMZ.compiled_accuracy(ct, xte, yte) == \
            RMZ.compiled_accuracy(cr, xte, yte)

        rnet, tnet = RCIRC.compile_netlist(cr), TCIRC.compile_netlist(ct)
        assert len(rnet.nodes) == len(tnet.nodes)
        for a, b in zip(rnet.nodes, tnet.nodes):
            assert (int(a.op), a.args, a.value, a.shift, a.lo, a.hi, a.role,
                    a.layer, a.unit, a.product_root) == \
                (int(b.op), b.args, b.value, b.shift, b.lo, b.hi, b.role,
                 b.layer, b.unit, b.product_root)
        assert tnet.critical_path_levels() == rnet.critical_path_levels()
        assert TCIRC.cross_validate(tnet, ct)["ok"]
        sc_t, sc_r = TCIRC.structural_cost(tnet), RCIRC.structural_cost(rnet)
        assert (sc_t.area_mm2, sc_t.power_mw) == (sc_r.area_mm2,
                                                  sc_r.power_mw)
        an = TMZ.compiled_cost(ct)
        assert sc_t.area_mm2 == an.area_mm2
        assert TCIRC.netlist_accuracy(tnet, ct, xte, yte, device="cpu") == \
            float(np.mean(cls_t == yte))


@pytest.mark.parametrize("kw", SPEC_KW + [dict()])
def test_qat_finetune_matches_reference(kw):
    """Same injected weights, 30 QAT epochs on whitewine: trained weights
    within TRAIN_ATOL."""
    p0, (xtr, ytr, _, _) = _ref_pretrained("whitewine")
    rspec, tspec = RModelMin.uniform(2, **kw), TModelMin.uniform(2, **kw)
    rmasks = RMZ.make_masks(p0, rspec)
    ref = RMZ.qat_finetune(p0, rspec, rmasks, xtr, ytr, epochs=30)
    tp0 = TM.params_from_numpy(p0, "cpu")
    got = TMZ.qat_finetune(tp0, tspec, TMZ.make_masks(tp0, tspec), xtr, ytr,
                           epochs=30, device="cpu")
    assert _maxdiff(ref, got) <= TRAIN_ATOL


def test_pretrain_loop_matches_reference_from_injected_init():
    """The reference's threefry init injected into the port's `_train`:
    600 full-batch Adam epochs end within TRAIN_ATOL of `pretrain`."""
    cfg = PRINTED_MLPS["seeds"]
    p0, (xtr, ytr, _, _) = _ref_pretrained("seeds")
    init = _np_params(RMZ.M.mlp_init(jax.random.PRNGKey(0), cfg.layer_dims))
    got = TMZ._train(TM.params_from_numpy(init, "cpu"),
                     *TMZ._tensors(xtr, ytr, "cpu"), epochs=600, lr=5e-3,
                     w_transform=lambda i, w: w)
    assert _maxdiff(p0, got) <= TRAIN_ATOL


def test_adam_update_float32_step_counter():
    r = np.random.default_rng(0)
    g, m, v = (r.normal(size=(4, 5)).astype(np.float32) for _ in range(3))
    v = np.abs(v)
    for t in (1.0, 7.0, 599.0):
        ref = RMZ._adam_update(jnp.asarray(g), jnp.asarray(m), jnp.asarray(v),
                               jnp.float32(t), 5e-3)
        got = TMZ._adam_update(torch.from_numpy(g), torch.from_numpy(m),
                               torch.from_numpy(v),
                               torch.tensor(t, dtype=torch.float32), 5e-3)
        for a, b in zip(ref, got):
            assert b.dtype == torch.float32
            # one float32 pow each side (XLA's vs libm's): <= 2 ulp
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=3e-7,
                                       atol=0)


def test_end_to_end_accuracy_drift_from_scratch(capsys):
    """Own torch.Generator init (threefry cannot be reproduced): the port's
    pretrained baseline lands within 2 points of the reference's on
    seeds; the drift is reported."""
    cfg = PRINTED_MLPS["seeds"]
    p0, (_, _, xte, yte) = _ref_pretrained("seeds")
    tp, _ = TMZ.pretrain(T_PRINTED_MLPS["seeds"], device="cpu")
    acc_r = float(RMZ.M.accuracy(jax.tree_util.tree_map(jnp.asarray, p0),
                                 jnp.asarray(xte), jnp.asarray(yte)))
    acc_t = float(TM.accuracy(tp, torch.from_numpy(xte),
                              torch.from_numpy(yte.astype(np.int64))))
    print(f"pretrained accuracy drift on {cfg.name}: reference {acc_r:.4f} "
          f"port {acc_t:.4f} (delta {acc_t - acc_r:+.4f})")
    assert abs(acc_t - acc_r) <= 0.02
