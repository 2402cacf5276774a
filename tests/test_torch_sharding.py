"""The port's sharding rules (`repro_torch.dist.sharding`) against the
reference's, leaf by leaf, for all ten registry archs at full size: the
port's parameters and decode states built on the meta device (nothing
drawn), the reference's with ``jax.eval_shape``; on the abstract 16x16 and
2x16x16 meshes. Specs are compared as tuples of their entries (exact).
`quantized_shardings` holds what the reference means (fault C7: the
reference's own raises a TypeError): q takes the weight's spec, scale
replicates, and with fsdp off every spec equals the reference's
`param_specs` on a (1, 16) mesh."""
import functools

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import pytest  # noqa: E402
from jax.sharding import PartitionSpec as RP  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.dist import sharding as RSH  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.serve import quantized as RQ  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, shape_applicable  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.serve import quantized as QS  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


@functools.lru_cache(maxsize=None)
def _ref_params(name):
    return RSP.abstract_params(RARCHS[name])


@functools.lru_cache(maxsize=None)
def _port_params(name):
    return SP.abstract_params(ARCHS[name])


def _ref_by_path(specs):
    return {RSH.path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                specs, is_leaf=lambda x: isinstance(x, RP))}


def _port_by_path(specs, path=()):
    if isinstance(specs, dict):
        return {k: v for key, sub in specs.items()
                for k, v in _port_by_path(sub, path + (key,)).items()}
    if isinstance(specs, tuple) and not isinstance(specs, SH.P):
        return {k: v for i, sub in enumerate(specs)
                for k, v in _port_by_path(sub, path + (i,)).items()}
    return {SH.path_str(path): tuple(specs)}


@pytest.mark.parametrize("name", sorted(ARCHS))
def test_param_specs_equal_the_reference_on_both_meshes(name):
    rp, tp = _ref_params(name), _port_params(name)
    assert all(t.device.type == "meta" for t in
               jax.tree_util.tree_leaves(tp))
    for sizes, axes in MESHES.values():
        want = _ref_by_path(RSH.param_specs(
            rp, RSH.abstract_mesh(sizes, axes)))
        got = _port_by_path(SH.param_specs(tp, SH.abstract_mesh(sizes,
                                                                axes)))
        assert got == want


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_the_reference(shape_name):
    shape = SHAPES[shape_name]
    n = 0
    for name in sorted(ARCHS):
        if not shape_applicable(ARCHS[name], shape)[0]:
            continue
        rstate = RSP.abstract_decode_state(RARCHS[name], RSHAPES[shape_name])
        tstate = SP.abstract_decode_state(ARCHS[name], shape)
        for sizes, axes in MESHES.values():
            rmesh = RSH.abstract_mesh(sizes, axes)
            tmesh = SH.abstract_mesh(sizes, axes)
            ok = shape.global_batch % SP.batch_divisor(tmesh) == 0
            assert ok == (shape.global_batch % RSP.batch_divisor(rmesh)
                          == 0)
            want = _ref_by_path(RSH.cache_specs(rstate, rmesh,
                                                shard_batch=ok))
            got = _port_by_path(SH.cache_specs(tstate, tmesh,
                                               shard_batch=ok))
            assert got == want, name
            n += 1
    assert n >= 4


def test_quantized_shardings_hold_c7s_meaning():
    name = "qwen3-0.6b"
    rp, tp = _ref_params(name), _port_params(name)
    rmesh = RSH.abstract_mesh((16, 16), ("data", "model"))
    tmesh = M.make_production_mesh()
    with pytest.raises(TypeError):       # fault C7, left in the reference
        RQ.quantized_shardings(RARCHS[name], rmesh, rp, bits=8, fsdp=True)
    rq = RQ.abstract_quantized(rp, 8)

    def expected(ref_specs):
        out = {}
        for p, spec in _ref_by_path(ref_specs).items():
            out[p] = spec
        flat_q = {RSH.path_str(p): x for p, x in
                  jax.tree_util.tree_leaves_with_path(
                      rq, is_leaf=RQ.is_qleaf)}
        want = {}
        for p, spec in out.items():
            if RQ.is_qleaf(flat_q[p]):
                want[p + "/q"], want[p + "/scale"] = spec, ()
            else:
                want[p] = spec
        return want

    specs, qshapes = QS.quantized_shardings(ARCHS[name], tmesh, tp, bits=8)
    assert _port_by_path(specs) == expected(RSH.param_specs(rp, rmesh))
    assert any(QS.is_qleaf(x) for x in jax.tree_util.tree_leaves(
        qshapes, is_leaf=QS.is_qleaf))
    # fsdp off: the reference's rules on a mesh whose data axis is 1
    specs, _ = QS.quantized_shardings(ARCHS[name], tmesh, tp, bits=8,
                                      fsdp=False)
    got = _port_by_path(specs)
    want = expected(RSH.param_specs(
        rp, RSH.abstract_mesh((1, 16), ("data", "model"))))
    assert got == want
    assert not any("data" in str(s) for s in got.values())


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SH.abstract_mesh((16, 16), ("data", "model"))
    mesh3 = M.make_production_mesh(multi_pod=True)
    assert SH.placements(SH.P(None, "data", "model", None), mesh) == \
        [Shard(1), Shard(2)]
    assert SH.placements(SH.P(), mesh) == [Replicate(), Replicate()]
    assert SH.placements(SH.P(("pod", "data"), None), mesh3) == \
        [Shard(0), Shard(0), Replicate()]
    assert SH.placements(SH.batch_spec(mesh3, 2), mesh3) == \
        [Shard(0), Shard(0), Replicate()]
    with pytest.raises(ValueError):
        SH.placements(SH.P("data", "data"), mesh)
    with pytest.raises(ValueError):
        SH.placements(SH.P("pod"), mesh)
    tree = SH.named_shardings({"a": SH.P("model", None), "b": (SH.P(),)},
                              mesh)
    assert tree == {"a": [Replicate(), Shard(0)],
                    "b": ([Replicate(), Replicate()],)}
    assert M.make_debug_mesh().size == 1


def test_path_str_has_one_home():
    from repro_torch.ckpt import checkpoint as CK
    assert CK.path_str is SH.path_str
    assert QS.path_str is SH.path_str
    assert SH.path_str(("segments", 0, 1, "mixer", "wq", "kernel")) == \
        "segments/0/1/mixer/wq/kernel"
