"""Parity of the port's core transforms with the JAX reference: the same
seeded numpy inputs go through `repro.core.*` and `repro_torch.core.*`.

Integer and grid-snapping stages must match exactly. k-means centroids are
float sums whose reduction order differs between XLA and torch; their
stated tolerance is one float32 ulp of the row's absolute sum (the largest
partial sum a centroid sum can reach), and the assignments must match
exactly.
"""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.core import batch_eval as RBE  # noqa: E402
from repro.core import clustering as RC  # noqa: E402
from repro.core import compression_spec as RS  # noqa: E402
from repro.core import hw_model as RHW  # noqa: E402
from repro.core import pruning as RP  # noqa: E402
from repro.core import quantization as RQ  # noqa: E402
from repro_torch.core import batch_eval as TBE  # noqa: E402
from repro_torch.core import clustering as TC  # noqa: E402
from repro_torch.core import compression_spec as TS  # noqa: E402
from repro_torch.core import hw_model as THW  # noqa: E402
from repro_torch.core import pruning as TP  # noqa: E402
from repro_torch.core import quantization as TQ  # noqa: E402

RNG_SEED = 11


def _w(shape, seed=RNG_SEED, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _assert_within_row_ulp(got, ref, x):
    """|got - ref| <= 1 float32 ulp of sum|x| (per row when 2-D)."""
    x = np.atleast_2d(x)
    tol = np.spacing(np.abs(x).sum(axis=-1)).astype(np.float64)
    diff = np.abs(np.atleast_2d(got).astype(np.float64)
                  - np.atleast_2d(ref).astype(np.float64))
    assert np.all(diff <= tol[:, None]), (diff.max(), tol.min())


@pytest.mark.parametrize("bits", [2, 3, 4, 5, 8, 16])
def test_quantize_int_and_fake_quant_exact(bits):
    w = _w((11, 10), scale=0.7)
    qc_r, qc_t = RQ.QuantConfig(bits=bits), TQ.QuantConfig(bits=bits)
    q_r, s_r = RQ.quantize_int(jnp.asarray(w), qc_r)
    q_t, s_t = TQ.quantize_int(torch.from_numpy(w), qc_t)
    np.testing.assert_array_equal(np.asarray(q_r), q_t.numpy())
    assert np.float32(s_r) == np.float32(s_t.item())
    fq_r = RQ.fake_quant(jnp.asarray(w), qc_r)
    wt = torch.from_numpy(w).requires_grad_(True)
    fq_t = TQ.fake_quant(wt, qc_t)
    np.testing.assert_array_equal(np.asarray(fq_r), fq_t.detach().numpy())
    g = np.random.default_rng(1).normal(size=w.shape).astype(np.float32)
    (fq_t * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), g)     # STE = identity


@pytest.mark.parametrize("bits", [0, 2, 5, 8])
def test_quant_dyn_exact_and_identity_gradient(bits):
    w = _w((3, 7, 8))
    ref = np.stack([np.asarray(RBE._quant_dyn(jnp.asarray(w[p]),
                                              jnp.int32(bits)))
                    for p in range(3)])
    wt = torch.from_numpy(w).requires_grad_(True)
    got = TBE._quant_dyn(wt, torch.full((3,), bits, dtype=torch.int32))
    np.testing.assert_array_equal(got.detach().numpy(), ref)
    got.sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.ones_like(w))
    if bits:       # the dynamic grid is the static fake-quant's grid
        st = TQ.fake_quant(torch.from_numpy(w[1]), TQ.QuantConfig(bits=bits))
        np.testing.assert_array_equal(got[1].detach().numpy(), st.numpy())


@pytest.mark.parametrize("sparsity", [0.0, 0.1, 0.3, 0.5, 0.8])
def test_magnitude_mask_exact(sparsity):
    w = _w((16, 20))
    w[0, :4] = w[1, :4]                       # ties at the threshold kept
    ref = np.asarray(RP.magnitude_mask(jnp.asarray(w), sparsity))
    got = TP.magnitude_mask(torch.from_numpy(w), sparsity).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("k", range(1, 17))
def test_kmeans_static_padded_and_per_input(k):
    """Static, padded and per-input-row k-means assign exactly like the
    reference; centroids within the stated ulp; the port's padded run
    equals its static run bit for bit; the cluster STE's gradient is the
    identity."""
    x = _w((13,), seed=100 + k)
    c_r, a_r = RC._kmeans_1d(jnp.asarray(x), k)
    c_t, a_t = TC._kmeans_1d(torch.from_numpy(x), k)
    np.testing.assert_array_equal(a_t.numpy(), np.asarray(a_r))
    _assert_within_row_ulp(c_t.numpy(), np.asarray(c_r), x)
    cp_r, ap_r = RBE._padded_kmeans_1d(jnp.asarray(x), jnp.int32(k),
                                       RBE.K_MAX)
    cp_t, ap_t = TBE._padded_kmeans_1d(torch.from_numpy(x), k, TBE.K_MAX)
    np.testing.assert_array_equal(ap_t.numpy(), np.asarray(ap_r))
    _assert_within_row_ulp(cp_t[:k].numpy(), np.asarray(cp_r)[:k], x)
    np.testing.assert_array_equal(cp_t[:k].numpy(), c_t.numpy())
    np.testing.assert_array_equal(ap_t.numpy(), a_t.numpy())

    w = _w((11, 10), seed=k)
    cb_r, idx_r = RC.cluster_per_input(jnp.asarray(w), k)
    cb_t, idx_t = TC.cluster_per_input(torch.from_numpy(w), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    # occupied clusters: the stated ulp. Empty clusters keep their
    # quantile init, which the reference's *jitted* executable computes
    # with its own rounding of (slot + 0.5) / k (the eager reference and
    # the port agree); a 1-ulp change of q moves the interpolated init by
    # up to (n - 1) * eps * (max - min).
    used = np.zeros((11, k), bool)
    np.put_along_axis(used, idx_t.numpy().astype(np.int64), True, axis=1)
    cb_t, cb_r = cb_t.numpy(), np.asarray(cb_r)
    _assert_within_row_ulp(np.where(used, cb_t, 0), np.where(used, cb_r, 0),
                           w)
    spread = (w.max(1) - w.min(1)) * (w.shape[1] - 1) * np.finfo(
        np.float32).eps
    assert np.all(np.abs(cb_t - cb_r) <= spread[:, None]
                  + np.spacing(np.abs(w).sum(1))[:, None])
    for row in (0, 7):           # per row, the port's static k-means
        c1, a1 = TC._kmeans_1d(torch.from_numpy(w[row]), k)
        np.testing.assert_array_equal(cb_t[row], c1.numpy())
    wt = torch.from_numpy(w).requires_grad_(True)
    TC.cluster_ste(wt, k).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), np.ones_like(w))


def test_cluster_dyn_matches_per_candidate_reference():
    """The batched per-candidate-k cluster STE: exact assignments (through
    the snapped values' row structure) and 1-ulp values against the
    reference's vmapped single-candidate transform; k == 0 is identity."""
    w = _w((4, 7, 8), seed=5)
    ks = np.array([0, 2, 5, 16], np.int32)
    got = TBE._cluster_dyn(torch.from_numpy(w), torch.from_numpy(ks)).numpy()
    for p in range(4):
        ref = np.asarray(RBE._cluster_dyn(jnp.asarray(w[p]),
                                          jnp.int32(ks[p])))
        _assert_within_row_ulp(got[p], ref, w[p])
    np.testing.assert_array_equal(got[0], w[0])


SPECS_JSON = [
    (dict(bits=8), 0),
    (dict(bits=3, sparsity=0.3), 0),
    (dict(bits=4, sparsity=0.4, clusters=8), 0),
    (dict(bits=None, sparsity=0.0, clusters=None), 0),
    (dict(bits=4, sparsity=0.2, clusters=3, csd_drop=1, lsb=2), 4),
]


@pytest.mark.parametrize("kw,am", SPECS_JSON)
def test_to_json_byte_identical(kw, am):
    r = RS.ModelMin.uniform(2, argmax_lsb=am, input_bits=6, **kw)
    t = TS.ModelMin.uniform(2, argmax_lsb=am, input_bits=6, **kw)
    assert t.to_json() == r.to_json()
    assert TS.ModelMin.from_json(r.to_json()) == t
    assert t.has_approx == r.has_approx


def test_qat_weight_matches_reference():
    w = _w((11, 10), seed=3)
    mask = np.abs(w) > 0.3
    spec = (0, RS.LayerMin(bits=5, sparsity=0.3, clusters=4))
    ref = np.asarray(RS.qat_weight(jnp.asarray(w), spec[1],
                                   jnp.asarray(mask)))
    got = TS.qat_weight(torch.from_numpy(w),
                        TS.LayerMin(bits=5, sparsity=0.3, clusters=4),
                        torch.from_numpy(mask)).numpy()
    # the 4-bit grid snap after clustering: values equal unless a 1-ulp
    # centroid difference crosses a rounding boundary, which it must not
    np.testing.assert_array_equal(got, ref)


def test_hw_model_costs_equal():
    r = np.random.default_rng(2)
    qs = [r.integers(-127, 128, (11, 10)), r.integers(-127, 128, (10, 7))]
    qs[0][r.random(qs[0].shape) < 0.3] = 0
    idx = r.integers(0, 4, (11, 10))
    cb = r.integers(-7, 8, (11, 4))
    for cl in ([None, None], [(idx, cb), None]):
        a = RHW.mlp_cost(qs, w_bits=[8, 6], in_bits=8, clusters=cl)
        b = THW.mlp_cost(qs, w_bits=[8, 6], in_bits=8, clusters=cl)
        assert (a.total_fa, a.area_mm2, a.power_mw, a.n_multipliers) == \
            (b.total_fa, b.area_mm2, b.power_mw, b.n_multipliers)
    for c in range(-300, 300, 7):
        assert THW.csd_digits(c) == RHW.csd_digits(c)
