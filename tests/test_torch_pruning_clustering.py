"""The port's completed producers of compressed weights,
`repro_torch.core.pruning` and `repro_torch.core.clustering`, against
`repro.core.pruning` and `repro.core.clustering` on the same seeded numpy
inputs.

Masks must match bit for bit. They are thresholds on norms that the two
frameworks sum in different orders, so an exact tie at the threshold could
flip; the weights here are seeded normals whose tile and column norms are
checked to be apart at the threshold by far more than float32 rounding.
k-means centroids are float sums in another order: within one float32 ulp
of the row's absolute sum (the largest partial sum a centroid sum can
reach, as in ``tests/test_torch_core.py``); assignments must match exactly.
``clustering_error`` is a ratio of norms of such values: within 1e-5.
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

from repro.core import clustering as RC  # noqa: E402
from repro.core import pruning as RP  # noqa: E402
from repro_torch.core import clustering as TC  # noqa: E402
from repro_torch.core import pruning as TP  # noqa: E402


def _w(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _assert_within_ulp(got, ref, x):
    """|got - ref| <= 1 float32 ulp of sum|x| (per row of x when 2-D)."""
    x = np.atleast_2d(x)
    tol = np.spacing(np.abs(x).sum(axis=-1)).astype(np.float64)
    diff = np.abs(np.atleast_2d(got).astype(np.float64)
                  - np.atleast_2d(ref).astype(np.float64))
    assert np.all(diff <= tol[:, None]), (diff.max(), tol.min())


def _assert_untied(values: np.ndarray, sparsity: float) -> None:
    """The k-th largest value (the threshold) is apart from its neighbours
    by more than 1e-5 relative: no rounding of the sum can flip a mask."""
    v = np.sort(values.astype(np.float64).reshape(-1))
    k = max(int(round(v.size * (1.0 - sparsity))), 1)
    at = v.size - k
    near = v[max(at - 1, 0):at + 2]
    assert np.all(np.diff(near) > 1e-5 * np.abs(v[at])), near


# ---------------------------------------------------------------------------
# pruning
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", [0.0, 0.25, 0.5, 0.8])
@pytest.mark.parametrize("block", [(16, 16), (32, 32), (16, 32)], ids=str)
def test_block_mask_exact(sparsity, block):
    bk, bn = block
    w = _w((128, 96), seed=bk + bn + int(sparsity * 100))
    norms = np.sqrt((w.astype(np.float64).reshape(128 // bk, bk, 96 // bn, bn)
                     ** 2).sum(axis=(1, 3)))
    if sparsity:
        _assert_untied(norms, sparsity)
    ref = np.asarray(RP.block_mask(jnp.asarray(w), sparsity, block=block))
    got = TP.block_mask(torch.from_numpy(w), sparsity, block=block)
    assert got.dtype == torch.bool and got.shape == w.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    # the tile mask the block-sparse kernel takes is constant on each tile
    tiles = got[::bk, ::bn]
    assert torch.equal(tiles.repeat_interleave(bk, 0)
                       .repeat_interleave(bn, 1), got)


def test_block_mask_rejects_a_ragged_weight():
    with pytest.raises(ValueError):
        TP.block_mask(torch.zeros((30, 32)), 0.5, block=(16, 16))


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.9])
def test_neuron_mask_exact(sparsity):
    w = _w((40, 30), seed=int(sparsity * 10))
    if sparsity:
        _assert_untied(np.linalg.norm(w.astype(np.float64), axis=0),
                       sparsity)
    ref = np.asarray(RP.neuron_mask(jnp.asarray(w), sparsity))
    got = TP.neuron_mask(torch.from_numpy(w), sparsity)
    assert got.shape == w.shape
    np.testing.assert_array_equal(got.numpy(), ref)


def _tree(seed):
    """A parameter tree of the shape a model has: layers with 2-D kernels,
    a 3-D stacked kernel, biases and a norm scale below ``min_size``."""
    return {"layers": ({"kernel": _w((12, 10), seed), "bias": _w((10,),
                                                                  seed + 1)},
                       {"kernel": _w((10, 7), seed + 2),
                        "bias": _w((7,), seed + 3)}),
            "stacked": {"kernel": _w((2, 8, 6), seed + 4)},
            "norm": {"scale": _w((3, 4), seed + 5)}}


def _jax_tree(t):
    return jax.tree_util.tree_map(jnp.asarray, t)


def _torch_tree(t):
    return jax.tree_util.tree_map(torch.from_numpy, t)


@pytest.mark.parametrize("sparsity", [0.2, 0.5, 0.75])
def test_global_magnitude_masks_apply_and_sparsity_exact(sparsity):
    t = _tree(7)
    big = np.concatenate([np.abs(a).reshape(-1) for a in
                          jax.tree_util.tree_leaves(t)
                          if a.size >= 16 and a.ndim >= 2])
    _assert_untied(big, sparsity)
    ref = RP.global_magnitude_masks(_jax_tree(t), sparsity)
    got = TP.global_magnitude_masks(_torch_tree(t), sparsity)
    ref_l = jax.tree_util.tree_leaves(ref)
    got_l = jax.tree_util.tree_leaves(got)
    assert len(ref_l) == len(got_l) == 6
    for a, b in zip(ref_l, got_l):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert TP.sparsity_of(got) == RP.sparsity_of(ref)
    assert torch.all(got["norm"]["scale"])          # too small to prune
    masked_r = RP.apply_masks(_jax_tree(t), ref)
    masked_t = TP.apply_masks(_torch_tree(t), got)
    for a, b in zip(jax.tree_util.tree_leaves(masked_r),
                    jax.tree_util.tree_leaves(masked_t)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_cubic_schedule_equal():
    for step in range(-5, 130, 3):
        for initial in (0.0, 0.1):
            kw = dict(begin=10, end=110, final=0.8, initial=initial)
            assert TP.cubic_schedule(step, **kw) == \
                RP.cubic_schedule(step, **kw)


# ---------------------------------------------------------------------------
# clustering
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 4, 7, 16])
def test_kmeans_layer_and_reconstruct_layer(k):
    w = _w((11, 10), seed=30 + k)
    cb_r, idx_r = RC.kmeans_layer(jnp.asarray(w), k)
    cb_t, idx_t = TC.kmeans_layer(torch.from_numpy(w), k)
    assert idx_t.shape == w.shape and idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    _assert_within_ulp(cb_t.numpy(), np.asarray(cb_r), w.reshape(-1))
    # the same codebook and indices rebuild the same weight, exactly
    np.testing.assert_array_equal(
        TC.reconstruct_layer(torch.from_numpy(np.array(cb_r)),
                             torch.from_numpy(np.array(idx_r))).numpy(),
        np.asarray(RC.reconstruct_layer(cb_r, idx_r)))


@pytest.mark.parametrize("k", [3, 6, 16])
def test_cluster_per_input_and_multipliers(k):
    w = _w((24, 40), seed=50 + k)
    w[3, ::2] = 0.0                 # a row with a zero cluster
    cb_r, idx_r = RC.cluster_per_input(jnp.asarray(w), k)
    cb_t, idx_t = TC.cluster_per_input(torch.from_numpy(w), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_r))
    # occupied clusters within the stated ulp (empty ones keep a quantile
    # init that the reference's jitted call rounds its own way; see
    # tests/test_torch_core.py)
    used = np.zeros((24, k), bool)
    np.put_along_axis(used, idx_t.numpy().astype(np.int64), True, axis=1)
    _assert_within_ulp(np.where(used, cb_t.numpy(), 0),
                       np.where(used, np.asarray(cb_r), 0), w)
    # multiplier counts: on the reference's own codebooks, and end to end
    assert TC.multipliers_needed(torch.from_numpy(np.array(idx_r)),
                                 torch.from_numpy(np.array(cb_r))) == \
        RC.multipliers_needed(idx_r, cb_r)
    assert TC.multipliers_needed(idx_t, cb_t) == \
        RC.multipliers_needed(idx_r, cb_r)


@pytest.mark.parametrize("per_input", [True, False])
@pytest.mark.parametrize("k", [2, 5, 12])
def test_clustering_error(per_input, k):
    w = _w((16, 20), seed=70 + k)
    ref = RC.clustering_error(jnp.asarray(w), k, per_input=per_input)
    got = TC.clustering_error(torch.from_numpy(w), k, per_input=per_input)
    assert abs(got - ref) <= 1e-5, (got, ref)


@pytest.mark.parametrize("per_input", [True, False])
def test_cluster_ste_value_and_identity_gradient(per_input):
    """Per layer or per input row: the snapped values within the stated
    ulp of the reference's, and the gradient the identity."""
    w = _w((9, 14), seed=90)
    ref = np.asarray(RC.cluster_ste(jnp.asarray(w), 4, per_input=per_input))
    wt = torch.from_numpy(w).requires_grad_(True)
    got = TC.cluster_ste(wt, 4, per_input=per_input)
    # per layer, every row's sums run over the whole layer
    scope = w if per_input else np.broadcast_to(w.reshape(1, -1),
                                                (9, w.size))
    _assert_within_ulp(got.detach().numpy(), ref, scope)
    g = _w((9, 14), seed=91)
    (got * torch.from_numpy(g)).sum().backward()
    np.testing.assert_array_equal(wt.grad.numpy(), g)
