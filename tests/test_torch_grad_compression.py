"""The port's int8 error-feedback gradient compression
(`repro_torch.dist.grad_compression`) against the reference's, bit for
bit: `quantize_leaf`'s payload and scale, `init_error_state`, and four
rounds of `compress_tree` (what is sent and the residual carried) over a
tree of float32 and bfloat16 leaves of mixed sizes with exact ties at
half a step. `make_compressed_allreduce` is the identity without a process
group and averages over a live one (a one-rank gloo group through a file
store), whose all-reduces the roofline's counter records."""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.dist import grad_compression as RGC  # noqa: E402
from repro_torch.dist import grad_compression as GC  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402


def _tree(seed):
    r = np.random.default_rng(seed)
    ties = (np.arange(-254, 255, dtype=np.float32) / 2.0) * 0.01
    return {"w": r.normal(size=(33, 17)).astype(np.float32),
            "b": r.normal(size=(5,)).astype(np.float32) * 1e-3,
            "e": (r.normal(size=(4, 8)) * 10).astype(np.float32),
            "t": ties,
            "s": (tuple([r.normal(size=(3, 2, 7)).astype(np.float32)]),
                  np.zeros((6,), np.float32))}


def _torch(tree, dtype=torch.float32):
    return jax.tree_util.tree_map(lambda a: torch.from_numpy(a).to(dtype),
                                  tree)


def _np(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


def test_quantize_leaf_bit_equal():
    for seed in range(3):
        for g in jax.tree_util.tree_leaves(_tree(seed)):
            q, s = GC.quantize_leaf(torch.from_numpy(g))
            rq, rs = RGC.quantize_leaf(jnp.asarray(g))
            assert q.dtype == torch.int8 and s.dtype == torch.float32
            np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
            assert float(s) == float(rs)
            err = np.abs(g - q.numpy().astype(np.float32) * s.numpy())
            # within half a step, up to float32's rounding of g and q*s
            slack = 4 * np.finfo(np.float32).eps * np.abs(g).max()
            assert (err <= s.numpy() / 2 + slack).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_compress_tree_four_rounds_bit_equal(dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    grads = [_tree(s) for s in range(4)]
    err_t = GC.init_error_state(_torch(grads[0], dtype))
    err_r = RGC.init_error_state(jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jdt), grads[0]))
    assert all(e.dtype == torch.float32 and not e.any()
               for e in jax.tree_util.tree_leaves(err_t))
    total_true, total_sent = 0.0, 0.0
    for g in grads:
        sent_t, err_t = GC.compress_tree(_torch(g, dtype), err_t)
        sent_r, err_r = RGC.compress_tree(
            jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), g), err_r)
        for a, b in zip(jax.tree_util.tree_leaves(sent_t),
                        jax.tree_util.tree_leaves(sent_r)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        for a, b in zip(jax.tree_util.tree_leaves(err_t),
                        jax.tree_util.tree_leaves(err_r)):
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        total_true = total_true + _np(_torch(g, dtype)["w"])
        total_sent = total_sent + _np(sent_t["w"])
    # error feedback: what was sent tracks the true sum up to the residual
    np.testing.assert_allclose(total_sent + _np(err_t["w"]), total_true,
                               rtol=1e-5, atol=1e-5)


def test_allreduce_identity_without_a_group_and_mean_over_one(tmp_path):
    import torch.distributed as dist
    mesh = M.make_production_mesh()
    g = _torch(_tree(7))
    e = GC.init_error_state(g)
    sent, _ = GC.compress_tree(g, e)
    mean, new_err = GC.make_compressed_allreduce(mesh, "data")(g, e)
    for a, b in zip(jax.tree_util.tree_leaves(mean),
                    jax.tree_util.tree_leaves(sent)):
        assert torch.equal(a, b)
    with pytest.raises(AssertionError):
        GC.make_compressed_allreduce(mesh, "pod")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        ar = GC.make_compressed_allreduce(mesh, "data",
                                          group=dist.group.WORLD)
        count = RA.count_step(ar, g, e)
        mean, err2 = count.result
    finally:
        dist.destroy_process_group()
    for a, b in zip(jax.tree_util.tree_leaves(mean),
                    jax.tree_util.tree_leaves(sent)):
        assert torch.equal(a, b)
    for a, b in zip(jax.tree_util.tree_leaves(err2),
                    jax.tree_util.tree_leaves(new_err)):
        assert torch.equal(a, b)
    # the roofline's counter sees each leaf's all-reduce, priced at twice
    # its float32 payload (a ring's reduce-scatter and all-gather)
    n = sum(t.numel() for t in jax.tree_util.tree_leaves(g))
    assert len(count.counter.collectives) == len(jax.tree_util.tree_leaves(g))
    assert RA.collective_bytes(count.counter.collectives) == \
        {"all-reduce": 2.0 * 4 * n, "total": 2.0 * 4 * n}
