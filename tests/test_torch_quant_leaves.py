"""Quantized leaves that no K2 product consumes (fault F1 of the port, in
ROADMAP.md), and the quantized serve step of the Mamba family.

The JAX package's ``quantize_params`` quantizes every stacked leaf with a
last dim >= 64 and >= 65 536 elements, norm scales, biases and Mamba's
``D``, conv and ``dt_proj`` leaves included, and ``dequantize_params``
turns each back into the config's dtype. The port reads such leaves in
place through `nn.layers.real`, which must give the same tensors.

The family case is falcon-mamba-7b with d_model 256, d_inner 512, N 16,
dt_rank 64 and 256 repeats (124 846 336 parameters): at that depth every
kind of leaf the full width quantizes is quantized too. float32 throughout,
where the JAX step (dequantize, then the model) and the port's (K2
dequantizes in float32) compute the same products. Tolerances: payload and
scales bit for bit, greedy tokens exactly; the norm within 1e-6 and the
dense products within 1e-5 (the same dequantized values, float32 sums of up
to 3072 terms reordered)."""
import dataclasses

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs.base import Segment as RSegment  # noqa: E402
from repro.configs.base import SSMConfig as RSSMConfig  # noqa: E402
from repro.nn import layers as RL  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.configs.base import Segment, SSMConfig  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.nn import layers as TL  # noqa: E402
from repro_torch.nn import transformer as TT  # noqa: E402
from repro_torch.serve import quantized as TQ  # noqa: E402

NAME = "falcon-mamba-7b"
REPEATS = 256


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _with_paths(tree):
    return {jax.tree_util.keystr(p): v for p, v in
            jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------------------
# F1 unit cases: a stacked norm scale and dense biases, quantized
# ---------------------------------------------------------------------------


def leaves(seed=0):
    """gemma-7b's stacked norm scale (28, 3072) and dense layers with a
    (28, 3072) bias, as numpy."""
    r = np.random.default_rng(seed)
    f = np.float32
    return {
        "norm": {"scale": r.normal(0, 0.1, (28, 3072)).astype(f)},
        "dense": {"kernel": r.normal(0, 0.05, (28, 64, 3072)).astype(f),
                  "bias": r.normal(0, 0.5, (28, 3072)).astype(f)},
        "dense3": {"kernel": r.normal(0, 0.05, (28, 2, 32, 3072)).astype(f),
                   "bias": r.normal(0, 0.5, (28, 3072)).astype(f)},
    }


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_norm_scale_and_biases_read_as_the_reference(dtype):
    tree = leaves()
    rq = RQ.quantize_params(jax.tree_util.tree_map(jnp.asarray, tree))
    tq = TQ.quantize_params(TT.map_tree(
        lambda _, a: torch.from_numpy(a.copy()), tree))
    for k in ("norm", "dense", "dense3"):
        assert RQ.is_qleaf(rq[k]["scale" if k == "norm" else "bias"])
    real = RQ.dequantize_params(rq, jnp.dtype(dtype))
    # K2 dequantizes a kernel in float32, where the JAX step rounds it to
    # the model's dtype first: the reference product takes the float32 one
    f32_kernels = RQ.dequantize_params(rq, jnp.float32)
    x = np.random.default_rng(1).normal(size=(2, 3, 3072)).astype(
        np.float32)
    x3 = np.random.default_rng(2).normal(size=(2, 3, 64)).astype(np.float32)
    xh = x3.reshape(2, 3, 2, 32)
    for r in (0, 27):
        take = jax.tree_util.tree_map(lambda a: a[r], real)
        take32 = jax.tree_util.tree_map(lambda a: a[r], f32_kernels)
        tr = TT._take(tq, r)
        want = RL.norm_apply(take["norm"], jnp.asarray(x))
        got = TL.norm_apply(tr["norm"], torch.from_numpy(x), dtype=dtype)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)
        # the kernels are quantized as well: their products go through K2
        # (its plain version here); the biases are read through `real`
        for k, xin in (("dense", x3), ("dense3", xh)):
            apply = TL.dense_apply if k == "dense" else TL.dense_in3_apply
            rapply = RL.dense_apply if k == "dense" else RL.dense_in3_apply
            want = rapply({"kernel": take32[k]["kernel"],
                           "bias": take[k]["bias"].astype(jnp.float32)},
                          jnp.asarray(xin))
            got = apply(tr[k], torch.from_numpy(xin), dtype=dtype)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="dtype"):
        TL.norm_apply(TT._take(tq, 0)["norm"], torch.from_numpy(x))
    scale = TT._take(tq, 3)["norm"]["scale"]
    assert TL.real(scale, dtype).dtype == TL.torch_dtype(dtype)
    plain = torch.ones(3)
    assert TL.real(plain, dtype) is plain


# ---------------------------------------------------------------------------
# falcon-mamba-7b, 256 repeats: every kind of leaf quantized
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def deep():
    ssm = dict(d_state=16, d_conv=4, expand=2, dt_rank=64)
    rcfg = RARCHS[NAME].reduced(
        d_model=256, ssm=RSSMConfig(**ssm),
        segments=(RSegment(RARCHS[NAME].segments[0].pattern, REPEATS),))
    tcfg = ARCHS[NAME].reduced(
        d_model=256, ssm=SSMConfig(**ssm),
        segments=(Segment(ARCHS[NAME].segments[0].pattern, REPEATS),))
    rparams = RT.init(jax.random.PRNGKey(0), rcfg)
    tparams = TT.params_from_numpy(_np_tree(rparams), tcfg, "cpu")
    assert RT.param_count(rparams) == TT.param_count(tparams) == 124846336
    return rcfg, tcfg, rparams, tparams


QUANTIZED = {"['embed']['table']", "['lm_head']['kernel']",
             "['segments'][0][0]['norm1']['scale']"} | {
    f"['segments'][0][0]['mixer']{k}" for k in (
        "['in_proj']['kernel']", "['x_proj']['kernel']",
        "['dt_proj']['kernel']", "['dt_proj']['bias']",
        "['out_proj']['kernel']", "['conv']['kernel']", "['conv']['bias']",
        "['D']")}


def _payload_values(q, shape, bits):
    """A payload's integer values: int8 at 8 bits; at 4 bits uint8 packed
    two to a byte along the last axis (ceil(N/2) bytes), unpacked."""
    if bits == 8:
        assert q.dtype == np.int8
        return q
    assert q.dtype == np.uint8
    assert q.shape == tuple(shape[:-1]) + ((shape[-1] + 1) // 2,)
    return TL.unpack_int4(torch.from_numpy(q), shape[-1]).numpy()


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_bit_exact(deep, bits):
    _, _, rparams, tparams = deep
    want = _with_paths(RQ.quantize_params(rparams, bits=bits))
    got = _with_paths(TT.params_to_numpy(TQ.quantize_params(tparams,
                                                            bits=bits)))
    assert got.keys() == want.keys()
    assert {k[:-len("['q']")] for k in want if k.endswith("['q']")} == \
        QUANTIZED
    for k, w in want.items():
        w = np.asarray(w)
        if k.endswith("['q']"):
            vals = _payload_values(got[k], w.shape, bits)
            np.testing.assert_array_equal(vals, w.astype(np.int8))
            assert np.abs(vals).max() <= 2 ** (bits - 1) - 1
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w)


def test_chunked_quantization_is_one_pass(deep, monkeypatch):
    """Slices of the leading axis give what one pass over a leaf gives."""
    _, _, _, tparams = deep
    whole = TQ.quantize_params(tparams)
    monkeypatch.setattr(TQ, "_CHUNK_ELEMENTS", 1000)
    sliced = TQ.quantize_params(tparams)
    for a, b in zip(jax.tree_util.tree_leaves(TT.params_to_numpy(whole)),
                    jax.tree_util.tree_leaves(TT.params_to_numpy(sliced))):
        np.testing.assert_array_equal(a, b)


def test_quant_serve_step_tokens_equal(deep, monkeypatch):
    rcfg, tcfg, rparams, tparams = deep
    calls = []
    real = TL.quant_matmul

    def spy(x, w, s):
        calls.append((tuple(x.shape), tuple(w.shape)))
        return real(x, w, s)

    monkeypatch.setattr(TL, "quant_matmul", spy)
    rq = RQ.quantize_params(rparams, bits=8)
    tq = TQ.quantize_params(tparams, bits=8)
    rstep = jax.jit(RQ.make_quant_serve_step(
        dataclasses.replace(rcfg, dtype="float32")))
    tstep = TQ.make_quant_serve_step(tcfg)
    B, prompt, new = 2, 3, 2
    toks = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (B, prompt)).astype(np.int32)
    rs = RT.init_decode_state(rcfg, B, 8, jnp.float32)
    ts = TT.init_decode_state(tcfg, B, 8, torch.float32, device="cpu")
    reset_launches()
    r_out, t_out = [], []
    rn = tn = None
    for t in range(prompt + new):
        if t < prompt:
            rin = jnp.asarray(toks[:, t:t + 1])
            tin = torch.from_numpy(toks[:, t:t + 1]).long()
        else:
            rin, tin = rn, tn
        rn, rs = rstep(rq, rs, rin)
        tn, ts = tstep(tq, ts, tin)
        r_out.append(np.asarray(rn))
        t_out.append(tn.numpy())
    np.testing.assert_array_equal(np.concatenate(t_out, 1),
                                  np.concatenate(r_out, 1))
    # in_proj, x_proj, dt_proj (float32 input), out_proj in each layer and
    # the untied LM head, each through K2's wrapper, which runs its plain
    # version on CPU tensors and launches nothing
    d, di, r = tcfg.d_model, 2 * tcfg.d_model, tcfg.ssm.dt_rank
    layer = [((B, d), (d, 2 * di)), ((B, di), (di, r + 32)),
             ((B, r), (r, di)), ((B, di), (di, d))]
    step = layer * REPEATS + [((B, d), (d, tcfg.vocab_size))]
    assert calls == step * (prompt + new)
    assert LAUNCHES["quant_matmul"] == 0
