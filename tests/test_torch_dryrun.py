"""The port's dry-run (`repro_torch.launch.dryrun`, `launch.specs`) against
the reference's abstract states: for every arch at full size, the train
state (parameters, step, both moments) built on the meta device equal in
shape and dtype, leaf by leaf, to the reference's ``jax.eval_shape``; the
decode states of every applicable decode shape and the inputs of every
shape too; `active_param_count` and `model_flops` equal (exact). Then the
affine depth fit equal to the direct count at full depth (integers,
exact) on reduced configs of each family, `run_cell` on qwen3-0.6b
decode_32k at full size, and ``--mesh multi`` refused."""
import dataclasses
import functools

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.nn import transformer as RT  # noqa: E402
from repro.roofline import analysis as RRA  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, shape_applicable  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.nn import transformer as T  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402


def _dt(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _port_leaves(tree, path=()):
    """path -> (shape, dtype) over dicts, NamedTuples (by field) and
    tuples; a Python int (the port's kv_len) as ((), "int")."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _port_leaves(sub, path + (str(key),)).items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return {k: v for f in tree._fields
                for k, v in _port_leaves(getattr(tree, f),
                                         path + (f,)).items()}
    if isinstance(tree, tuple):
        return {k: v for i, sub in enumerate(tree)
                for k, v in _port_leaves(sub, path + (str(i),)).items()}
    if isinstance(tree, int):
        return {"/".join(path): ((), "int")}
    assert tree.device.type == "meta", path
    return {"/".join(path): (tuple(tree.shape), _dt(tree.dtype))}


def _ref_leaves(tree):
    out = {}
    for p, leaf in jax.tree_util.tree_leaves_with_path(tree):
        keys = [str(getattr(k, "key", getattr(k, "name",
                                               getattr(k, "idx", k))))
                for k in p]
        out["/".join(keys)] = (tuple(leaf.shape), _dt(leaf.dtype))
    return out


@functools.lru_cache(maxsize=None)
def _ref_state(name):
    return RSP.abstract_train_state(RARCHS[name])


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_abstract_states_and_inputs_equal_the_reference(name):
    cfg, rcfg = ARCHS[name], RARCHS[name]
    tstate = SP.abstract_train_state(cfg)
    assert _port_leaves(tstate) == _ref_leaves(_ref_state(name))
    assert _port_leaves(SP.abstract_params(cfg)) == \
        _ref_leaves(_ref_state(name).params)
    for shape_name, shape in SHAPES.items():
        for k in ("tokens", "frames", "patches"):
            got = SP.input_specs(cfg, shape).get(k)
            want = RSP.input_specs(rcfg, RSHAPES[shape_name]).get(k)
            assert (got is None) == (want is None)
            if got is not None:
                assert (tuple(got.shape), _dt(got.dtype)) == \
                    (tuple(want.shape), _dt(want.dtype))
        if shape.kind != "decode" or not shape_applicable(cfg, shape)[0]:
            continue
        got = _port_leaves(SP.abstract_decode_state(cfg, shape))
        want = _ref_leaves(RSP.abstract_decode_state(rcfg,
                                                     RSHAPES[shape_name]))
        # the reference's kv_len is an int32 scalar, the port's a Python
        # int the host keeps
        assert got.pop("kv_len") == ((), "int")
        assert want.pop("kv_len") == ((), "int32")
        assert got == want


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_active_params_and_model_flops_equal(name):
    n = T.active_param_count(SP.abstract_params(ARCHS[name]), ARCHS[name])
    assert n == RT.active_param_count(_ref_state(name).params, RARCHS[name])
    for shape in SHAPES.values():
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        kind = "train" if shape.kind == "train" else "serve"
        assert RA.model_flops(n, tokens, kind) == \
            RRA.model_flops(n, tokens, kind)


TRAIN = ShapeConfig("train_tiny", 32, 2, "train")
DECODE = ShapeConfig("decode_tiny", 48, 2, "decode")


@pytest.mark.parametrize("name,shape,bits", [
    ("qwen3-0.6b", TRAIN, None), ("qwen3-0.6b", DECODE, 8),
    ("falcon-mamba-7b", TRAIN, None), ("phi3.5-moe-42b-a6.6b", TRAIN, None),
    ("whisper-base", TRAIN, None), ("recurrentgemma-9b", DECODE, None)])
def test_depth_fit_equals_the_direct_count_at_full_depth(name, shape, bits):
    # d_ff 512: the MLP's stacked leaves are quantized at every depth
    # (65536 values at one repeat), so the w8 count is affine too
    cfg = ARCHS[name].reduced(d_model=128, d_ff=512)
    full = [3] * len(D.depth_knobs(cfg))
    cfg = D.with_depth(cfg, full)
    assert D.depth_knobs(cfg) == full
    fit = RA.fit_depth(lambda r: D.measure_variant(cfg, shape, r,
                                                   serve_bits=bits),
                       len(full))
    direct = D.measure_variant(cfg, shape, full, serve_bits=bits)
    assert fit.at(full) == direct
    assert all(isinstance(v, int) for v in direct.values())
    assert direct["flops"] > 0 and direct["coll_total"] == 0


def test_run_cell_qwen3_decode_at_full_size():
    rec = D.run_cell("qwen3-0.6b", "decode_32k", "single")
    assert rec["status"] == "ok" and rec["chips"] == 1
    assert rec["fit"]["matches_direct"] and rec["fit"]["knobs"] == [28]
    cfg, shape = ARCHS["qwen3-0.6b"], SHAPES["decode_32k"]
    params = sum(t.numel() * t.element_size() for _, t in
                 T._leaves(SP.abstract_params(cfg)))
    assert params == T.param_count(SP.abstract_params(cfg)) * 2 \
        + 2 * (2 * 28 + 1) * cfg.d_model + 2 * 2 * 28 * cfg.head_dim
    cache = 2 * 28 * shape.global_batch * shape.seq_len \
        * cfg.num_kv_heads * cfg.head_dim * 2
    mem = rec["memory"]
    assert mem["argument_bytes"] == params + cache + shape.global_batch * 4
    assert mem["alias_bytes"] == cache          # the caches, written in place
    r = rec["roofline"]
    assert r["dominant"] == "memory" and r["t_collective_s"] == 0
    assert r["t_memory_s"] == r["bytes_per_chip"] / 3.35e12
    assert rec["kernels"] == {}          # the decode's attention is plain
    assert 0 < rec["useful_flops_ratio"] < 1
    assert not rec["fits_hbm"]           # 448 GiB of cache at batch 128
    skipped = D.run_cell("qwen3-0.6b", "long_500k")
    assert skipped["status"] == "skipped" and skipped["reason"]


def test_mesh_multi_is_refused(tmp_path):
    with pytest.raises(SystemExit) as e:
        D.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k", "--mesh",
                "multi", "--out", str(tmp_path)])
    assert e.value.code == 2
    with pytest.raises(ValueError, match="one card"):
        D.run_cell("qwen3-0.6b", "decode_32k", "multi")
    assert list(tmp_path.iterdir()) == []
    assert dataclasses.replace(SHAPES["decode_32k"], global_batch=8) == \
        D.cell_shape("decode_32k", 8)
    assert torch.device("meta") == SP.META
