"""4-bit payloads stored two to a byte, end to end on the CPU.

* `pack_int4`/`unpack_int4` round trips (odd widths, leading axes, a
  property over shapes and values), and the layout's nibble order.
* `quantize_params(bits=4)` on reduced qwen3-0.6b and falcon-mamba-7b:
  uint8 payloads of last axis ceil(N/2) whose values, and the scales,
  equal the reference's ``jnp.int4`` ones bit for bit; the reference's
  int4 tree carried across by `params_from_numpy` gives the same leaves.
* The w4 decode step against the reference's ``make_quant_serve_step`` on
  the same weights (float32, as the w8 tests: greedy tokens equal, logits
  within 1e-4 for products reordered).
* `abstract_quantized(bits=4)` equal in shape and dtype to
  `quantize_params(bits=4)`; a w4 dry-run cell on meta counts half the w8
  payload bytes plus the scales, in its arguments and in K2's records.
* A w4 tree through `ckpt.CheckpointManager` bit for bit; K2's wrapper
  refusing a packed payload whose width does not match ``scale``;
  `quantized_shardings` refusing a sharded packed axis that does not
  split.
"""
import dataclasses
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
from _hypothesis_compat import given, settings, st  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro_torch.ckpt import CheckpointManager  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import ShapeConfig, SSMConfig  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import quant_matmul as QM  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as QMO  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402

# every attention and MLP weight (qwen3) or dense product (falcon-mamba)
# large enough to quantize
QWEN = ("qwen3-0.6b", dict(vocab_size=512, d_model=256, num_heads=4,
                           num_kv_heads=2, head_dim=64, d_ff=512))
MAMBA = ("falcon-mamba-7b", dict(vocab_size=512, d_model=256,
                                 ssm=SSMConfig(d_state=16, d_conv=4,
                                               expand=2, dt_rank=64)))


@functools.lru_cache(maxsize=None)
def _carried(model):
    name, overrides = model
    overrides = dict(overrides)
    rcfg = RARCHS[name].reduced(**overrides)
    tcfg = ARCHS[name].reduced(**overrides)
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tree = jax.tree_util.tree_map(np.asarray, rparams)
    return (rcfg, tcfg, rparams, TT.params_from_numpy(tree, tcfg, "cpu"),
            RQ.quantize_params(rparams, bits=4))


def carried(name, overrides):
    """(reference config, port config, reference params, the same params
    carried across, the reference's w4 tree); built once a model, read
    only by the tests."""
    return _carried((name, tuple(sorted(overrides.items()))))


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


def _qleaves(tree, path=()):
    """path -> quantized leaf, over a port tree."""
    if TL.is_qleaf(tree):
        return {path: tree}
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _qleaves(sub, path + (key,)).items()}
    if isinstance(tree, (tuple, list)):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _qleaves(sub, path + (i,)).items()}
    return {}


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (2,), (7,), (3, 64), (2, 5, 65),
                                   (4, 1, 33)])
def test_pack_unpack_round_trip(shape):
    r = np.random.default_rng(sum(shape))
    q = torch.from_numpy(r.integers(-8, 8, shape).astype(np.int8))
    p = TL.pack_int4(q)
    n = shape[-1]
    assert p.dtype == torch.uint8
    assert p.shape == shape[:-1] + ((n + 1) // 2,)
    assert torch.equal(TL.unpack_int4(p, n), q)
    if n % 2:                       # the last high nibble is 0
        assert int((p[..., -1] >> 4).max()) == 0


def test_nibble_order_is_the_documented_layout():
    q = torch.tensor([[1, -2, 7, -8, 3]], dtype=torch.int8)
    # byte j: element 2j low, 2j + 1 high, two's complement
    assert TL.pack_int4(q).tolist() == [[0xE1, 0x87, 0x03]]
    with pytest.raises(ValueError, match="uint8 of last axis 4"):
        TL.unpack_int4(TL.pack_int4(q), 7)


@settings(max_examples=40, deadline=None)
@given(st.lists(st.integers(1, 5), min_size=1, max_size=3),
       st.integers(0, 2 ** 32 - 1))
def test_pack_unpack_property(dims, seed):
    q = torch.from_numpy(np.random.default_rng(seed).integers(
        -8, 8, tuple(dims)).astype(np.int8))
    assert torch.equal(TL.unpack_int4(TL.pack_int4(q), dims[-1]), q)


# ---------------------------------------------------------------------------
# quantized trees against the reference's jnp.int4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("model", [QWEN, MAMBA], ids=lambda m: m[0])
def test_w4_payload_and_scales_equal_the_reference(model):
    _, _, _, tparams, rq = carried(*model)
    want = _with_paths(rq)
    tq = TQ.quantize_params(tparams, bits=4)
    got = _with_paths(TT.params_to_numpy(tq))
    assert got.keys() == want.keys()
    n_q = 0
    for k, w in want.items():
        w = np.asarray(w)
        if k.endswith("['q']"):
            n_q += 1
            assert w.dtype == jnp.int4
            assert got[k].dtype == np.uint8
            assert got[k].shape == w.shape[:-1] + ((w.shape[-1] + 1) // 2,)
            vals = TL.unpack_int4(torch.from_numpy(got[k]), w.shape[-1])
            np.testing.assert_array_equal(vals.numpy(), w.astype(np.int8))
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w)
    assert n_q >= 6
    # the reference's int4 tree carried across packs to the same bytes
    back = TT.params_from_numpy(jax.tree_util.tree_map(np.asarray, rq),
                                ARCHS[model[0]].reduced(**model[1]), "cpu")
    mine, theirs = _qleaves(tq), _qleaves(back)
    assert mine.keys() == theirs.keys() and len(mine) == n_q
    for path, leaf in mine.items():
        assert theirs[path]["q"].dtype == torch.uint8
        assert torch.equal(theirs[path]["q"], leaf["q"]), path
        assert torch.equal(theirs[path]["scale"], leaf["scale"]), path


@pytest.mark.parametrize("model", [QWEN, MAMBA], ids=lambda m: m[0])
def test_w4_decode_matches_the_reference(model, monkeypatch):
    """Greedy tokens equal, logits within 1e-4 (the w8 tests' bound: the
    same payload and scales, products summed in another order)."""
    rcfg, tcfg, _, tparams, rq = carried(*model)
    tq = TQ.quantize_params(tparams, bits=4)
    calls = []
    real = TL.quant_matmul
    monkeypatch.setattr(TL, "quant_matmul", lambda x, w, s: (
        calls.append(w.dtype), real(x, w, s))[1])
    rstep = jax.jit(lambda p, s, t: RT.decode_step(
        RQ.dequantize_params(p, jnp.float32), s, t, rcfg))
    B, steps = 2, 5
    toks = np.random.default_rng(4).integers(0, rcfg.vocab_size, (B, steps))
    rs = RT.init_decode_state(rcfg, B, 8, jnp.float32)
    ts = TT.init_decode_state(tcfg, B, 8, torch.float32, device="cpu")
    reset_launches()
    for t in range(steps):
        want, rs = rstep(rq, rs, jnp.asarray(toks[:, t:t + 1]))
        got, ts = TT.decode_step(tq, ts, torch.from_numpy(
            toks[:, t:t + 1]), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.numpy().argmax(-1),
                                      np.asarray(want).argmax(-1))
    # every product on a packed payload, through K2's wrapper (its plain
    # version on the CPU: no launch)
    assert calls and set(calls) == {torch.uint8}
    assert LAUNCHES["quant_matmul"] == 0
    step = TQ.make_quant_serve_step(tcfg)
    ts = TT.init_decode_state(tcfg, B, 8, torch.float32, device="cpu")
    nxt, _ = step(tq, ts, torch.from_numpy(toks[:, :1]))
    assert nxt.dtype == torch.int32 and nxt.shape == (B, 1)


def test_abstract_w4_equals_the_quantized_tree():
    _, _, _, tparams, rq = carried(*MAMBA)
    tq = TQ.quantize_params(tparams, bits=4)
    meta = jax.tree_util.tree_map(lambda t: t.to("meta"), tparams)
    shapes = TQ.abstract_quantized(meta, bits=4)
    for a, b in zip(jax.tree_util.tree_leaves(shapes),
                    jax.tree_util.tree_leaves(tq)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert a.device.type == "meta"
    # dequantizing unpacks: the reference's dequantized tree, exactly
    want = RQ.dequantize_params(rq, jnp.float32)
    got = TT.params_to_numpy(TQ.dequantize_params(tq, torch.float32))
    for a, b in zip(jax.tree_util.tree_leaves(want),
                    jax.tree_util.tree_leaves(got)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_w4_dry_run_counts_half_the_w8_payload():
    """On meta, the w4 decode's arguments and K2's byte records differ from
    w8's by half the payload (every N even here), the scales the same."""
    cfg = ARCHS["qwen3-0.6b"].reduced(d_model=128, d_ff=512)
    shape = ShapeConfig("decode_tiny", 48, 2, "decode")
    counts, trees = {}, {}
    for bits in (8, 4):
        step, args = D.lower_cell(cfg, shape, serve_bits=bits)
        trees[bits] = args[0]
        counts[bits] = RA.count_step(step, *args)
    q8, q4 = _qleaves(trees[8]), _qleaves(trees[4])
    assert q8.keys() == q4.keys() and q8
    pay8 = sum(v["q"].numel() for v in q8.values())
    pay4 = sum(v["q"].numel() for v in q4.values())
    assert all(v["q"].dtype == torch.uint8 for v in q4.values())
    assert all(v["scale"].shape[0] % 2 == 0 for v in q8.values())
    assert 2 * pay4 == pay8
    scales = sum(v["scale"].numel() * 4 for v in q4.values())
    assert scales == sum(v["scale"].numel() * 4 for v in q8.values())
    mem8, mem4 = (RA.memory_dict(counts[b]) for b in (8, 4))
    assert mem8["argument_bytes"] - mem4["argument_bytes"] == pay8 - pay4
    k8 = counts[8].counter.kernels["quant_matmul"]
    k4 = counts[4].counter.kernels["quant_matmul"]
    assert k8["launches"] == k4["launches"] > 0
    assert k8["flops"] == k4["flops"]
    # each launch reads K ceil(N/2) weight bytes instead of K N
    products = sum(v["q"].numel() for p, v in q4.items()
                   if p[-1] == "kernel")
    assert k8["bytes"] - k4["bytes"] == products
    assert QMO.cost(8, 64, 33, 2, packed=True)[1] == \
        QMO.cost(8, 64, 33, 2)[1] - 64 * 33 + 64 * 17


def test_w4_tree_survives_a_checkpoint(tmp_path):
    tparams = carried(*QWEN)[3]
    tq = TQ.quantize_params(tparams, bits=4)
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(1, tq)
    back, _ = mgr.restore(like=tq)
    a, b = _qleaves(tq), _qleaves(back)
    assert a.keys() == b.keys() and a
    for path, leaf in a.items():
        got = torch.as_tensor(b[path]["q"])
        assert got.dtype == torch.uint8 and torch.equal(got, leaf["q"])
        assert torch.equal(torch.as_tensor(b[path]["scale"]),
                           leaf["scale"])


def test_wrapper_checks_a_packed_payload():
    x = torch.randn(3, 64)
    q = torch.randint(-7, 8, (64, 33), dtype=torch.int8)
    s = torch.rand(33) + 0.1
    packed = TL.pack_int4(q)
    assert torch.equal(QM.quant_matmul(x, packed, s),
                       QM.quant_matmul(x, q, s))
    with pytest.raises(ValueError, match="ceil"):
        QM.quant_matmul(x, packed[:, :16], s)          # too narrow
    with pytest.raises(ValueError, match="ceil"):
        QM.quant_matmul(x, TL.pack_int4(q[:, :31]), s)
    with pytest.raises(TypeError, match="uint8"):
        QM.quant_matmul(x, packed.to(torch.int16), s)
    with pytest.raises(ValueError, match="ceil"):       # int8 of the packed
        QM.quant_matmul(x, packed.view(torch.int8), s)  # width
    tol = QM.quant_matmul_tolerance(x, packed, s, QM.quant_matmul_ref(
        x, packed, s))
    assert torch.equal(tol, QM.quant_matmul_tolerance(
        x, q, s, QM.quant_matmul_ref(x, q, s)))


def test_dense_layers_and_gathers_read_packed_leaves():
    r = np.random.default_rng(5)
    leaf = lambda w: TQ.quantize_params({"w": w}, bits=4)["w"]  # noqa: E731
    w3 = torch.from_numpy(r.normal(size=(64, 16, 64)).astype(np.float32))
    k3 = leaf(w3)
    assert k3["q"].shape == (64, 16, 32)
    x = torch.randn(2, 64)
    got = TL.dense_apply({"kernel": k3}, x)
    want = x @ TL.dequantize(k3, torch.float32).reshape(64, 1024)
    torch.testing.assert_close(got, want.reshape(2, 16, 64), rtol=1e-5,
                               atol=1e-5)
    k_in3 = leaf(torch.from_numpy(r.normal(size=(4, 64, 1024)).astype(
        np.float32)))
    xi = torch.randn(2, 4, 64)
    torch.testing.assert_close(
        TL.dense_in3_apply({"kernel": k_in3}, xi),
        xi.reshape(2, 256) @ TL.dequantize(k_in3, torch.float32).reshape(
            256, 1024), rtol=1e-5, atol=1e-5)
    table = leaf(torch.from_numpy(r.normal(size=(1100, 65)).astype(
        np.float32)))
    tok = torch.tensor([[3, 1099], [0, 7]])
    full = TL.dequantize(table, torch.float32)
    assert torch.equal(TL.embedding_apply({"table": table}, tok,
                                          torch.float32), full[tok])
    assert torch.equal(TL.table_rows({"table": table}, 5, 9, torch.float32),
                       full[5:9])


def test_sharded_packed_axis_must_split():
    cfg = dataclasses.replace(ARCHS["qwen3-0.6b"].reduced(
        vocab_size=512, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=520))
    mesh = SH.abstract_mesh((1, 8), ("data", "model"))
    from repro_torch.launch import specs as SP
    params = SP.abstract_params(cfg)
    # d_ff 520 splits over 8 (65 columns a shard) but its 260 packed bytes
    # do not
    with pytest.raises(ValueError, match="wi_gate"):
        TQ.quantized_shardings(cfg, mesh, params, bits=4)
    specs, _ = TQ.quantized_shardings(cfg, mesh, params, bits=8)
    assert specs
    ok = SP.abstract_params(ARCHS["qwen3-0.6b"].reduced(
        vocab_size=512, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512))
    specs, q = TQ.quantized_shardings(cfg, mesh, ok, bits=4)
    assert q["embed"]["table"]["q"].dtype == torch.uint8
