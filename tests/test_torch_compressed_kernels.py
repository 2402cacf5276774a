"""The port's compressed-weight kernels K3 (`clustered_matmul`) and K4
(`block_sparse_matmul`) against the JAX package's Pallas kernels, run in
interpret mode as ``tests/test_kernels.py`` runs them, and against the JAX
oracles. The same numpy inputs, made from a seed, go to both sides; bf16
inputs are rounded to bf16 once (both frameworks round to nearest even, so
both sides see the same bits). On CPU tensors the wrappers run their plain
versions, so the kernels' launch counts stay 0; the CUDA kernels are held
against the plain versions by the card-only tests in
``tests/test_torch_cuda.py``.

Tolerances: float32 1e-4 against the Pallas kernels (they accumulate
K / block_k partial tiles where the plain versions take one product: a few
ulp of reassociation at these depths) and 1e-5 against the JAX oracles (one
product each, summed in another order); bf16 outputs 3e-2 (one bf16 ulp is
2^-8 relative, and the Pallas kernels round their per-tile partial results
differently). Every case is also held to the elementwise bound stated
beside the plain version (`clustered_matmul_tolerance`,
`block_sparse_matmul_tolerance`: 2 K eps32 sum|x w|, plus one bf16 rounding
on each side), which is tighter where the values are small."""
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
from repro.kernels.block_sparse_matmul import block_sparse_matmul as jax_bsmm  # noqa: E402,E501
from repro.kernels.block_sparse_matmul import block_sparse_matmul_ref as jax_bref  # noqa: E402,E501
from repro.kernels.clustered_matmul import clustered_matmul as jax_cmm  # noqa: E402,E501
from repro.kernels.clustered_matmul import clustered_matmul_ref as jax_cref  # noqa: E402,E501
from repro_torch.core import clustering as TC  # noqa: E402
from repro_torch.core import pruning as TP  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import block_sparse_matmul as TBS  # noqa: E402
from repro_torch.kernels import clustered_matmul as TCM  # noqa: E402
from repro_torch.kernels.clustered_matmul import ops as TCMO  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 3e-2}
REF_TOL = {"float32": 1e-5, "bfloat16": 3e-2}
IDX = {"int8": (np.int8, torch.int8), "int32": (np.int32, torch.int32)}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``."""
    if dtype == "bfloat16":
        return (jnp.asarray(a, jnp.bfloat16),
                torch.tensor(a, dtype=torch.float32).to(torch.bfloat16))
    return jnp.asarray(a, jnp.float32), torch.tensor(a, dtype=torch.float32)


def _np(y) -> np.ndarray:
    if isinstance(y, torch.Tensor):
        return y.float().numpy()
    return np.asarray(y, np.float32)


def _within(got: torch.Tensor, other, tol: torch.Tensor) -> None:
    diff = np.abs(_np(got).astype(np.float64) - _np(other))
    assert np.all(diff <= tol.double().numpy()), (
        diff.max(), float(tol.min()))


# ---------------------------------------------------------------------------
# K3: clustered_matmul
# ---------------------------------------------------------------------------


# (M, K, N, C): the JAX test's three shapes (the last ragged in every dim),
# and a decode shape of 8 rows
CMM_SHAPES = [(32, 64, 32, 4), (64, 128, 96, 16), (20, 70, 40, 3),
              (8, 256, 96, 16)]


@pytest.mark.parametrize("M,K,N,C", CMM_SHAPES)
@pytest.mark.parametrize("idx_dtype", sorted(IDX))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clustered_matmul_plain_matches_pallas_and_ref(M, K, N, C, idx_dtype,
                                                      dtype):
    r = np.random.default_rng(M * 1000 + K + N + C)
    x = r.normal(size=(M, K)).astype(np.float32)
    idx = r.integers(0, C, (K, N)).astype(IDX[idx_dtype][0])
    cb = r.normal(size=(K, C)).astype(np.float32)
    xj, xt = _pair(x, dtype)
    it, cbt = torch.from_numpy(idx), torch.from_numpy(cb)
    reset_launches()
    got = TCM.clustered_matmul(xt, it, cbt)
    assert got.dtype == xt.dtype and got.shape == (M, N)
    assert LAUNCHES["clustered_matmul"] == 0      # the plain version ran
    pallas = jax_cmm(xj, jnp.asarray(idx), jnp.asarray(cb), block_m=16,
                     block_n=32, block_k=32)
    ref = jax_cref(xj, jnp.asarray(idx), jnp.asarray(cb))
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=REF_TOL[dtype],
                               atol=REF_TOL[dtype])
    tol = TCM.clustered_matmul_tolerance(xt, it, cbt, got)
    _within(got, pallas, tol)
    _within(got, ref, tol)


def test_clustered_matmul_consistent_with_core_clustering():
    """K3 over the port's per-input codebooks == the dense product of the
    reconstructed weight (the paper's multiplier-sharing semantics), and
    == the JAX package's K3 over its own codebooks of the same weight."""
    r = np.random.default_rng(5)
    x = r.normal(size=(24, 32)).astype(np.float32)
    w = r.normal(size=(32, 48)).astype(np.float32)
    cb, idx = TC.cluster_per_input(torch.from_numpy(w), 6)
    xt = torch.from_numpy(x)
    got = TCM.clustered_matmul(xt, idx.to(torch.int8), cb)
    dense = xt @ TC.reconstruct_per_input(cb, idx)
    _within(got, dense, TCM.clustered_matmul_tolerance(xt, idx, cb, got))
    cb_r, idx_r = RC.cluster_per_input(jnp.asarray(w), 6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_r))
    theirs = jax_cmm(jnp.asarray(x), idx_r, cb_r, block_m=8, block_n=16,
                     block_k=16)
    np.testing.assert_allclose(_np(got), _np(theirs), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# K4: block_sparse_matmul
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sparsity", [0.0, 0.4, 0.8])
@pytest.mark.parametrize("block", [(32, 32), (16, 16)], ids=str)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_matmul_plain_matches_pallas_and_ref(sparsity, block,
                                                         dtype):
    """The JAX test's case (M 32, K 128, N 96, a `block_mask` of the
    weight) against the Pallas kernel and the oracle; then 20 rows, not a
    multiple of any row block, against the oracle (the Pallas kernel asserts
    block multiples; the port's kernel masks its rows)."""
    bk, bn = block
    r = np.random.default_rng(int(sparsity * 10) + bk)
    x = r.normal(size=(32, 128)).astype(np.float32)
    w = r.normal(size=(128, 96)).astype(np.float32)
    full = RP.block_mask(jnp.asarray(w), sparsity, block=(bk, bn))
    bm = np.asarray(full[::bk, ::bn]).astype(np.int32)
    xj, xt = _pair(x, dtype)
    wj, wt = _pair(w, dtype)
    bmt = torch.from_numpy(bm)
    reset_launches()
    got = TBS.block_sparse_matmul(xt, wt, bmt, block_k=bk, block_n=bn)
    assert got.dtype == xt.dtype and got.shape == (32, 96)
    assert LAUNCHES["block_sparse_matmul"] == 0
    pallas = jax_bsmm(xj, wj, jnp.asarray(bm), block_m=16, block_n=bn,
                      block_k=bk)
    ref = jax_bref(xj, wj, jnp.asarray(bm), block_k=bk, block_n=bn)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL[dtype],
                               atol=TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=REF_TOL[dtype],
                               atol=REF_TOL[dtype])
    tol = TBS.block_sparse_matmul_tolerance(xt, wt, bmt, got, block_k=bk,
                                            block_n=bn)
    _within(got, pallas, tol)
    _within(got, ref, tol)
    # a bool mask is the same mask
    same = TBS.block_sparse_matmul(xt, wt, bmt > 0, block_k=bk, block_n=bn)
    assert torch.equal(same, got)
    ragged = TBS.block_sparse_matmul(xt[:20], wt, bmt, block_k=bk,
                                     block_n=bn)
    ref20 = jax_bref(xj[:20], wj, jnp.asarray(bm), block_k=bk, block_n=bn)
    np.testing.assert_allclose(_np(ragged), _np(ref20), rtol=REF_TOL[dtype],
                               atol=REF_TOL[dtype])


def test_block_sparse_matmul_matches_apply_mask():
    """K4 over the port's `block_mask` == the dense product of
    `apply_mask(w, block_mask(w))` (`tests/test_kernels.py`'s link)."""
    r = np.random.default_rng(3)
    x = torch.from_numpy(r.normal(size=(12, 128)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(128, 96)).astype(np.float32))
    full = TP.block_mask(w, 0.5, block=(32, 32))
    got = TBS.block_sparse_matmul(x, w, full[::32, ::32], block_k=32,
                                  block_n=32)
    dense = x @ TP.apply_mask(w, full)
    _within(got, dense, TBS.block_sparse_matmul_tolerance(
        x, w, full[::32, ::32], got, block_k=32, block_n=32))


def test_block_sparse_matmul_dead_tiles_and_dead_strip():
    """A dead tile holding non-zero weights contributes nothing, and a
    column strip with no live tile comes out exactly zero."""
    r = np.random.default_rng(4)
    x = torch.from_numpy(r.normal(size=(9, 64)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(64, 96)).astype(np.float32))
    bm = torch.ones((4, 6), dtype=torch.int32)
    bm[1, 2] = 0                    # one dead tile, non-zero weights
    bm[:, 4] = 0                    # a whole column strip dead
    got = TBS.block_sparse_matmul(x, w, bm, block_k=16, block_n=16)
    assert torch.count_nonzero(got[:, 64:80]) == 0
    wl = w.clone()
    wl[16:32, 32:48] = 0
    wl[:, 64:80] = 0
    _within(got, x @ wl, TBS.block_sparse_matmul_tolerance(
        x, w, bm, got, block_k=16, block_n=16))
    assert not torch.allclose(got, x @ w)


def test_block_sparse_mask_values_follow_the_pallas_kernel():
    """Fault C4 of the reference: its oracle multiplies each tile by the
    mask's value, where the Pallas kernel takes a tile as live where the
    mask is > 0 and adds it unscaled. The port follows the kernel: a 2
    counts as live and unscaled, a -1 as dead."""
    r = np.random.default_rng(6)
    x = r.normal(size=(16, 64)).astype(np.float32)
    w = r.normal(size=(64, 64)).astype(np.float32)
    bm = np.array([[1, 2], [-1, 0]], np.int32)
    got = TBS.block_sparse_matmul(torch.from_numpy(x), torch.from_numpy(w),
                                  torch.from_numpy(bm), block_k=32,
                                  block_n=32)
    pallas = jax_bsmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bm),
                      block_m=16, block_n=32, block_k=32)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=1e-4, atol=1e-4)
    oracle = jax_bref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(bm),
                      block_k=32, block_n=32)
    assert not np.allclose(_np(oracle), _np(pallas), rtol=1e-2, atol=1e-2)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _cmm_args(**kw):
    a = dict(x=torch.zeros((4, 16)), idx=torch.zeros((16, 8),
                                                     dtype=torch.int8),
             codebook=torch.zeros((16, 4)))
    a.update(kw)
    return a


CMM_BAD = {
    "x_1d": (ValueError, _cmm_args(x=torch.zeros(16))),
    "k_mismatch": (ValueError, _cmm_args(x=torch.zeros((4, 15)))),
    "codebook_rows": (ValueError, _cmm_args(codebook=torch.zeros((15, 4)))),
    "too_many_clusters": (ValueError, _cmm_args(
        codebook=torch.zeros((16, TCMO.MAX_CLUSTERS + 1)))),
    "x_float16": (TypeError, _cmm_args(x=torch.zeros((4, 16),
                                                     dtype=torch.float16))),
    "idx_int64": (TypeError, _cmm_args(idx=torch.zeros((16, 8),
                                                       dtype=torch.int64))),
    "codebook_bf16": (TypeError, _cmm_args(
        codebook=torch.zeros((16, 4), dtype=torch.bfloat16))),
    "meta_device": (ValueError, {k: v.to("meta") for k, v in
                                 _cmm_args().items()}),
}


@pytest.mark.parametrize("case", sorted(CMM_BAD))
def test_clustered_matmul_rejects(case):
    exc, args = CMM_BAD[case]
    with pytest.raises(exc):
        TCM.clustered_matmul(**args)


def _bsmm_args(**kw):
    a = dict(x=torch.zeros((4, 64)), w=torch.zeros((64, 32)),
             block_mask=torch.ones((4, 2), dtype=torch.int32), block_k=16,
             block_n=16)
    a.update(kw)
    return a


BSMM_BAD = {
    "w_1d": (ValueError, _bsmm_args(w=torch.zeros(64))),
    "k_mismatch": (ValueError, _bsmm_args(x=torch.zeros((4, 63)))),
    "k_not_block_multiple": (ValueError, _bsmm_args(block_k=24)),
    "n_not_block_multiple": (ValueError, _bsmm_args(block_n=12)),
    "mask_shape": (ValueError, _bsmm_args(
        block_mask=torch.ones((2, 4), dtype=torch.int32))),
    "mixed_types": (TypeError, _bsmm_args(
        w=torch.zeros((64, 32), dtype=torch.bfloat16))),
    "float16": (TypeError, _bsmm_args(
        x=torch.zeros((4, 64), dtype=torch.float16),
        w=torch.zeros((64, 32), dtype=torch.float16))),
    "mask_float": (TypeError, _bsmm_args(block_mask=torch.ones((4, 2)))),
    "meta_device": (ValueError, {k: (v.to("meta") if torch.is_tensor(v)
                                     else v)
                                 for k, v in _bsmm_args().items()}),
}


@pytest.mark.parametrize("case", sorted(BSMM_BAD))
def test_block_sparse_matmul_rejects(case):
    exc, args = BSMM_BAD[case]
    with pytest.raises(exc):
        TBS.block_sparse_matmul(**args)


# ---------------------------------------------------------------------------
# fault F2 (repaired): an index outside [0, C) weighs 0, as in the Pallas
# kernel; reference defect C5: the JAX oracle gives NaN there
# ---------------------------------------------------------------------------


def _out_of_range_inputs():
    """(128, 128, 128) with C = 4, column 0 holding C + 1 on even rows and
    -1 on odd rows: no index of column 0 lies in [0, C)."""
    r = np.random.default_rng(16)
    x = r.normal(size=(128, 128)).astype(np.float32)
    idx = r.integers(0, 4, (128, 128)).astype(np.int32)
    idx[::2, 0] = 4 + 1
    idx[1::2, 0] = -1
    cb = r.normal(size=(128, 4)).astype(np.float32)
    return x, idx, cb


@pytest.mark.parametrize("idx_dtype", sorted(IDX))
def test_clustered_matmul_out_of_range_index_weighs_zero(idx_dtype):
    """The plain version (and the wrapper on the CPU) gives an index outside
    [0, C) weight 0 and matches the Pallas kernel, whose one-hot against
    iota(C) matches no entry there; the clamped weight of the kernel before
    the repair gives another answer."""
    x, idx, cb = _out_of_range_inputs()
    idx = idx.astype(IDX[idx_dtype][0])
    xt, it, cbt = (torch.from_numpy(a) for a in (x, idx, cb))
    got = TCM.clustered_matmul(xt, it, cbt)
    assert torch.equal(got, TCM.clustered_matmul_ref(xt, it, cbt))
    assert torch.count_nonzero(got[:, 0]) == 0
    pallas = jax_cmm(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cb),
                     block_m=32, block_n=32, block_k=32)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=TOL["float32"],
                               atol=TOL["float32"])
    _within(got, pallas, TCM.clustered_matmul_tolerance(xt, it, cbt, got))
    clamped = xt @ torch.gather(cbt, 1, it.long().clamp(0, 3))
    assert float((clamped[:, 0] - got[:, 0]).abs().max()) > 1.0


def test_clustered_matmul_oracle_gives_nan_out_of_range():
    """Reference defect C5: the JAX oracle gathers with take_along_axis,
    which fills an index past C with NaN (and wraps -1 to C - 1), so column
    0 comes out NaN where the Pallas kernel and the port give 0."""
    x, idx, cb = _out_of_range_inputs()
    oracle = _np(jax_cref(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cb)))
    assert np.isnan(oracle[:, 0]).all()
    assert np.isfinite(oracle[:, 1:]).all()
    pallas = _np(jax_cmm(jnp.asarray(x), jnp.asarray(idx), jnp.asarray(cb),
                         block_m=32, block_n=32, block_k=32))
    assert np.isfinite(pallas).all() and not np.any(pallas[:, 0])


# ---------------------------------------------------------------------------
# K4's arithmetic on the card: live k16 steps, zero-filled rows
# ---------------------------------------------------------------------------


def _bsmm_kernel_order(x, w, bm, bk, bn, split):
    """The sums of K4's CUDA body (``csrc/block_sparse_matmul.cu``) in plain
    PyTorch: per 16-column strip, the k16 steps with any live row are
    numbered in k order and rank r of ``split`` takes steps r, r + split,
    ...; rows of a dead tile inside a live step are zero-filled; a rank's
    steps form pieces of 8, warp w taking entries 2w and 2w + 1 of each
    piece and summing their float32 products in order; the 4 warps, then
    the ranks, are added in order."""
    M, K = x.shape
    N = w.shape[1]
    live = (bm > 0)[:, None, :, None].expand(K // bk, bk, N // bn, bn)
    wl = w.float() * live.reshape(K, N)
    xf = x.float()
    y = torch.zeros((M, N))
    steps = (K + 15) // 16
    for n0 in range(0, N, 16):
        cols = slice(n0, min(N, n0 + 16))
        live_steps = [s for s in range(steps)
                      if bool(live.reshape(K, N)[16 * s:16 * s + 16,
                                                 cols].any())]
        ranks = []
        for r in range(split):
            mine = live_steps[r::split]
            warps = [torch.zeros((M, cols.stop - n0)) for _ in range(4)]
            for j, s in enumerate(mine):
                part = xf[:, 16 * s:16 * s + 16] @ wl[16 * s:16 * s + 16,
                                                      cols]
                warps[(j % 8) // 2] = warps[(j % 8) // 2] + part
            ranks.append(((warps[0] + warps[1]) + warps[2]) + warps[3])
        total = ranks[0]
        for part in ranks[1:]:
            total = total + part
        y[:, cols] = total
    return y.to(x.dtype)


@pytest.mark.parametrize("bk", [8, 16, 128])
@pytest.mark.parametrize("split", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_sparse_matmul_tolerance_covers_zero_filled_steps(bk, split,
                                                               dtype):
    """K4's order of sums over live k16 steps (bk 8: a step spans two tiles
    and a dead one's rows are zero-filled) stays within
    `block_sparse_matmul_tolerance` of the plain version, and a strip with
    no live tile comes out exactly zero."""
    r = np.random.default_rng(bk + split)
    K, N, bn = 512, 256, 128 if bk == 128 else 32
    x = torch.from_numpy(r.normal(size=(8, K)).astype(np.float32))
    w = torch.from_numpy(r.normal(size=(K, N)).astype(np.float32))
    if dtype == "bfloat16":
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    bm = torch.from_numpy(r.random((K // bk, N // bn)) < 0.5)
    bm[:, -1] = False
    ref = TBS.block_sparse_matmul_ref(x, w, bm, block_k=bk, block_n=bn)
    got = _bsmm_kernel_order(x, w, bm, bk, bn, split)
    assert torch.count_nonzero(got[:, N - bn:]) == 0
    _within(got, ref, TBS.block_sparse_matmul_tolerance(
        x, w, bm, ref, block_k=bk, block_n=bn))


# ---------------------------------------------------------------------------
# the build: a shared header is part of every library's hash
# ---------------------------------------------------------------------------


def test_library_path_changes_with_a_shared_header(tmp_path, monkeypatch):
    """K2 and K4 include ``csrc/skinny_mma.cuh``: an edit of it must give
    every kernel a new library name, so no stale library is loaded."""
    from repro_torch.kernels import build
    for src in build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    for name in ("quant_matmul", "block_sparse_matmul"):
        assert '#include "skinny_mma.cuh"' in (
            tmp_path / f"{name}.cu").read_text()
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build.library_path(n) for n in build.KERNELS}
    assert before == {n: build.library_path(n) for n in build.KERNELS}
    header = tmp_path / "skinny_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in build.KERNELS}
    assert all(before[n] != after[n] for n in build.KERNELS)
    src = tmp_path / "quant_matmul.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert build.library_path("quant_matmul") != after["quant_matmul"]
    assert build.library_path("ssm_scan") == after["ssm_scan"]
