"""The port's `CheckpointManager` (`repro_torch.ckpt`).

* The reference's six manager cases (``tests/test_ckpt_manager.py``), run
  against the port's manager.
* Torch float32, bfloat16 and int64 leaves round-trip bit for bit.
* Each package restores a numpy-leaf checkpoint the other wrote, with
  equal leaves, ``paths`` and meta: the layout, leaf order (dict keys
  sorted, as ``jax.tree_util`` flattens) and manifests are the same.
"""
import json

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.ckpt.checkpoint import CheckpointManager as RefManager  # noqa
from repro_torch.ckpt import CheckpointManager  # noqa: E402


def _tree():
    return {"w": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.array([1, 2, 3], dtype=np.int64)}


def _assert_tree_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


# ---------------------------------------------------------------------------
# the reference's manager cases
# ---------------------------------------------------------------------------


def test_save_restore_roundtrip_sync(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    tree = _tree()
    mgr.save(7, tree, meta={"round": 7, "note": "hello"})
    like = {k: 0 for k in tree}
    restored, meta = mgr.restore(like=like)
    _assert_tree_equal(restored, tree)
    assert meta == {"round": 7, "note": "hello"}
    assert mgr.latest_step() == 7


def test_save_restore_roundtrip_async(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=True)
    tree = _tree()
    mgr.save(1, tree, meta={"k": 1}, block=True)
    mgr.wait()
    restored, meta = mgr.restore(like={k: 0 for k in tree})
    _assert_tree_equal(restored, tree)
    assert meta == {"k": 1}


def test_atomic_tmp_rename(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    # a stale .tmp from a previous crashed writer must not break the save,
    # must never be listed as a step, and must be gone after the publish
    stale = tmp_path / "step_00000003.tmp"
    stale.mkdir()
    (stale / "garbage").write_text("torn write")
    assert mgr.all_steps() == []              # .tmp dirs are not steps
    mgr.save(3, _tree())
    assert mgr.all_steps() == [3]
    assert not stale.exists()                 # renamed over, not leaked
    assert not list(tmp_path.glob("*.tmp"))
    restored, _ = mgr.restore(3, like={"w": 0, "b": 0})
    _assert_tree_equal(restored, _tree())


def test_keep_n_pruning(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_write=False)
    for s in range(5):
        mgr.save(s, _tree())
    assert mgr.all_steps() == [3, 4]
    # latest restore still works after pruning
    restored, _ = mgr.restore(like={"w": 0, "b": 0})
    _assert_tree_equal(restored, _tree())


def test_async_writer_error_propagates_into_next_save(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=True)
    # a set is not JSON-serializable: the manifest dump fails on the
    # writer thread, and the failure must surface on the NEXT save()
    mgr.save(0, _tree(), meta={"bad": {1, 2, 3}})
    mgr._q.join()                             # let the writer hit the error
    with pytest.raises(TypeError):
        mgr.save(1, _tree())
    # the error is cleared once raised: subsequent saves work again
    mgr.save(2, _tree(), block=True)
    mgr.wait()
    assert 2 in mgr.all_steps()


def test_restore_empty_root_returns_none(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    tree, meta = mgr.restore()
    assert tree is None and meta is None


# ---------------------------------------------------------------------------
# torch leaves
# ---------------------------------------------------------------------------


def _torch_tree():
    g = torch.Generator().manual_seed(0)
    w = torch.randn(5, 7, generator=g)
    w[0, 0] = float("nan")
    w[0, 1] = -0.0
    return {"f32": w,
            "bf16": torch.randn(4, 9, generator=g).to(torch.bfloat16),
            "i64": torch.randint(-2 ** 62, 2 ** 62, (6,), generator=g,
                                 dtype=torch.int64),
            "nested": [torch.arange(3, dtype=torch.int64),
                       (torch.ones(2, dtype=torch.bfloat16),)]}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


@pytest.mark.parametrize("async_write", [False, True])
def test_torch_leaves_round_trip_bit_for_bit(tmp_path, async_write):
    mgr = CheckpointManager(tmp_path, async_write=async_write)
    tree = _torch_tree()
    mgr.save(4, tree, meta={"round": 4}, block=True)
    mgr.wait()
    like = {"f32": torch.empty(0), "bf16": torch.empty(0),
            "i64": torch.empty(0), "nested": [torch.empty(0),
                                              (torch.empty(0),)]}
    got, meta = mgr.restore(like=like)
    assert meta == {"round": 4}
    want = [tree["bf16"], tree["f32"], tree["i64"], tree["nested"][0],
            tree["nested"][1][0]]
    have = [got["bf16"], got["f32"], got["i64"], got["nested"][0],
            got["nested"][1][0]]
    for a, b in zip(want, have):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype
        assert b.shape == a.shape and torch.equal(_bits(a), _bits(b))
    manifest = json.loads((tmp_path / "step_00000004" /
                           "MANIFEST.json").read_text())
    assert manifest["paths"] == ["bf16", "f32", "i64", "nested/0",
                                 "nested/1/0"]
    assert manifest["dtypes"] == ["bfloat16", "float32", "int64", "int64",
                                  "bfloat16"]
    # bf16 is stored as its uint16 bits; without `like` it comes back a
    # CPU tensor, and device= puts every leaf on the device as a tensor
    assert np.load(tmp_path / "step_00000004" / "leaf_000000.npy").dtype \
        == np.uint16
    leaves, _ = mgr.restore()
    assert leaves[0].dtype == torch.bfloat16
    assert isinstance(leaves[1], np.ndarray)
    on_cpu, _ = mgr.restore(like=like, device="cpu")
    assert torch.equal(_bits(on_cpu["bf16"]), _bits(tree["bf16"]))


def test_restore_checks_the_like_structure(tmp_path):
    mgr = CheckpointManager(tmp_path, async_write=False)
    mgr.save(0, _tree())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(like={"w": 0})


# ---------------------------------------------------------------------------
# across packages
# ---------------------------------------------------------------------------


def _numpy_state():
    r = np.random.default_rng(3)
    return {"rng": r.integers(0, 2 ** 32, (2, 625)).astype(np.uint64),
            "generation": np.array([4, 1], np.int64),
            "z": [r.normal(size=(3, 2)).astype(np.float32),
                  np.array(2.5)]}


META = {"round": 4, "populations": [["a", "b"], ["c"]],
        "evaluations": {"x": [0.25, 1.0]}}


@pytest.mark.parametrize("writer,reader", [("ref", "port"),
                                           ("port", "ref")])
def test_each_package_restores_the_others_numpy_checkpoint(tmp_path, writer,
                                                           reader):
    make = {"ref": RefManager, "port": CheckpointManager}
    state = _numpy_state()
    make[writer](tmp_path, async_write=False).save(4, state, meta=META)
    like = {"rng": 0, "generation": 0, "z": [0, 0]}
    got, meta = make[reader](tmp_path, async_write=False).restore(like=like)
    assert meta == META
    for a, b in ((state["rng"], got["rng"]),
                 (state["generation"], got["generation"]),
                 (state["z"][0], got["z"][0]), (state["z"][1], got["z"][1])):
        b = np.asarray(b)
        assert b.dtype == a.dtype and b.shape == a.shape
        assert b.tobytes() == a.tobytes()
    # both packages write the same manifest for the same state
    other = tmp_path / "other"
    make[reader](other, async_write=False).save(4, state, meta=META)
    m1 = json.loads((tmp_path / "step_00000004/MANIFEST.json").read_text())
    m2 = json.loads((other / "step_00000004/MANIFEST.json").read_text())
    for k in ("paths", "shapes", "dtypes", "n_leaves", "meta", "step"):
        assert m1[k] == m2[k], k
    assert m1["paths"] == ["generation", "rng", "z/0", "z/1"]
