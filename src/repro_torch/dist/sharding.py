"""Name-based sharding rules for every architecture in the registry, the
counterpart of `repro.dist.sharding`.

A parameter's *path* (joined with "/") and trailing shape pick a template
spec; any template axis whose mesh size does not divide the corresponding
dim falls back to replication, so `param_specs` resolves every leaf of
every arch. The rules resolve on an abstract mesh of axis names and sizes
(`abstract_mesh`), with no device and no process group: on one card they
are the plan a mesh of many would follow, and `placements` turns a spec
into the ``Shard``/``Replicate`` list a DTensor on a real
``torch.distributed`` device mesh takes.

Conventions (2D mesh ("data", "model"); a leading "pod" axis folds into the
batch axes):

* activations / batch:     sharded over all non-"model" axes;
* dense kernels (d, f):    fsdp on d ("data"), tensor-parallel on f ("model");
* attention projections:   heads on "model", d on "data" (q/k/v), reversed
  for the output projection;
* MoE experts:             expert axis on "model" (expert parallelism), d on
  "data";
* SSM / RG-LRU state dims: d_inner on "model";
* embeddings / lm_head:    vocab on "model";
* norms, gates, biases of norms: replicated.

Parameters stacked by a segment carry one leading ``repeats`` axis;
templates are right-aligned against the trailing dims, leading dims
replicate.

This module is also the one home of `path_str`, the stable leaf identifier
of checkpoint manifests and of the quantizer's rules.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

DATA_AXIS = "data"
MODEL_AXIS = "model"


class P(tuple):
    """A partition spec: one entry a dim, each None (replicated), a mesh
    axis name or a tuple of them (`jax.sharding.PartitionSpec`'s
    entries; a tuple of one axis is that axis, as there)."""

    def __new__(cls, *axes):
        return super().__new__(cls, tuple(
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


class AbstractMesh:
    """Axis names and sizes, no devices: what the rules read."""

    def __init__(self, axis_sizes: Sequence[int],
                 axis_names: Sequence[str]):
        if len(axis_sizes) != len(axis_names):
            raise ValueError(f"{axis_sizes} sizes for {axis_names}")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names,
                              (int(n) for n in axis_sizes)))

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n

    def __repr__(self) -> str:
        return f"AbstractMesh({self.shape})"


# ---------------------------------------------------------------------------
# paths
# ---------------------------------------------------------------------------


def path_str(path) -> str:
    """Join a tree path (dict keys and sequence indices) into "a/b/0/c"
    form (used for rule matching and as the stable leaf identifier in
    checkpoint manifests)."""
    return "/".join(str(k) for k in path)


def _map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, tuples and lists (lists come
    back as tuples); a leaf is anything else, a Python int included."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return tuple(_map_with_path(fn, v, path + (i,))
                     for i, v in enumerate(tree))
    return fn(path, tree)


def _axis_sizes(mesh) -> Dict[str, int]:
    return dict(mesh.shape)


def abstract_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str]):
    return AbstractMesh(axis_sizes, axis_names)


def batch_axes(mesh) -> Tuple[str, ...]:
    """All non-tensor-parallel mesh axes, in mesh order — the axes a global
    batch is sharded over (a "pod" super-axis composes with "data")."""
    return tuple(n for n in mesh.axis_names if n != MODEL_AXIS)


def batch_spec(mesh, ndim: int) -> P:
    """Spec of a batch-leading array: dim 0 over the batch axes, the rest
    replicated."""
    return P(batch_axes(mesh), *([None] * (ndim - 1)))


# ---------------------------------------------------------------------------
# rule templates
# ---------------------------------------------------------------------------

# Matched against the "/"-joined path, first hit wins. A template is the
# spec of the *trailing* dims of the leaf; leading (scan/stack) dims
# replicate. None = replicated dim.
_PARAM_RULES: Sequence[Tuple[Tuple[str, ...], Tuple]] = (
    # --- replicated small parameters ------------------------------------
    (("norm",), ()),                              # all norms incl. q/k/kv_norm
    (("cross_gate",), ()),
    (("router/kernel",), (DATA_AXIS, None)),      # router out dim replicated
    # --- embeddings ------------------------------------------------------
    (("pos_embed/table",), ()),
    (("embed/table",), (MODEL_AXIS, None)),
    (("lm_head/kernel",), (DATA_AXIS, MODEL_AXIS)),
    # --- MoE experts (E, d, de) / (E, de, d) -----------------------------
    (("experts/wi",), (MODEL_AXIS, DATA_AXIS, None)),
    (("experts/wo",), (MODEL_AXIS, None, DATA_AXIS)),
    # --- attention: (d, H, hd) in / (H, hd, d) out -----------------------
    (("wq/kernel", "wk/kernel", "wv/kernel",
      "c_wq/kernel", "c_wk/kernel", "c_wv/kernel"),
     (DATA_AXIS, MODEL_AXIS, None)),
    (("mixer/wo/kernel", "c_wo/kernel"), (MODEL_AXIS, None, DATA_AXIS)),
    # --- MLA (DeepSeek): low-rank down then per-head up ------------------
    (("w_dq/kernel", "w_dkv/kernel", "w_kr/kernel"), (DATA_AXIS, None)),
    (("w_uq/kernel", "w_uk/kernel", "w_uv/kernel"),
     (DATA_AXIS, MODEL_AXIS, None)),
    # --- dense MLP -------------------------------------------------------
    (("mlp/wi", "shared/wi"), (DATA_AXIS, MODEL_AXIS)),
    (("mlp/wo/kernel", "shared/wo/kernel"), (MODEL_AXIS, DATA_AXIS)),
    # --- Mamba SSM: d_inner is the TP dim --------------------------------
    (("in_proj/kernel",), (DATA_AXIS, MODEL_AXIS)),
    (("x_proj/kernel", "dt_proj/kernel"), (None, MODEL_AXIS)),
    (("out_proj/kernel",), (MODEL_AXIS, DATA_AXIS)),
    (("A_log",), (MODEL_AXIS, None)),
    (("mixer/D", "dt_proj/bias", "conv/bias"), (MODEL_AXIS,)),
    (("conv/kernel",), (None, MODEL_AXIS)),
    # --- RG-LRU (griffin): square d->d_inner gates, out proj back --------
    (("w_out/kernel",), (MODEL_AXIS, DATA_AXIS)),
    (("w_a/kernel", "w_i/kernel", "w_x/kernel", "w_gate/kernel"),
     (DATA_AXIS, MODEL_AXIS)),
    (("w_a/bias", "w_i/bias"), (MODEL_AXIS,)),
    (("Lambda",), (MODEL_AXIS,)),
)


def _template_for(path: str, shape) -> Tuple:
    for keys, tpl in _PARAM_RULES:
        if any(k in path for k in keys):
            return tpl
    # generic fallback: shard the two trailing dims of big matrices
    if len(shape) >= 2:
        return (DATA_AXIS, MODEL_AXIS)
    return ()


def _guard(tpl: Tuple, shape, sizes: Dict[str, int]) -> P:
    """Right-align the template on `shape`; drop any axis that does not
    divide its dim. Returns a full-rank spec."""
    spec = [None] * len(shape)
    if len(tpl) > len(shape):          # scalar/bias narrower than template
        tpl = tpl[-len(shape):] if len(shape) else ()
    off = len(shape) - len(tpl)
    for i, ax in enumerate(tpl):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        total = 1
        for a in axes:
            total *= sizes[a]
        if shape[off + i] % total == 0 and total > 1:
            spec[off + i] = ax
    # all-None spec of a norm/bias collapses to P() (cosmetic, equivalent)
    if all(s is None for s in spec) and len(tpl) == 0:
        return P()
    return P(*spec)


def param_specs(params, mesh, *, fsdp: bool = True):
    """Spec tree for a parameter tree (same structure, `P` leaves).
    Resolves on shapes alone (meta tensors will do). ``fsdp=False`` drops
    the data-axis weight sharding (TP-only serving): every leaf gets the
    spec it would have on a mesh whose data axis has size 1."""
    sizes = _axis_sizes(mesh)
    if not fsdp:
        sizes[DATA_AXIS] = 1

    def rule(path, leaf):
        return _guard(_template_for(path_str(path), leaf.shape),
                      leaf.shape, sizes)

    return _map_with_path(rule, params)


# ---------------------------------------------------------------------------
# decode-cache rules
# ---------------------------------------------------------------------------


def cache_specs(state, mesh, cfg=None, *, shard_batch: bool = True):
    """Specs for a decode state (stacked caches + counters). `cfg` is
    accepted for call-site symmetry with `param_specs`; the rules below
    resolve from shapes alone.

    KV caches (repeats, B, S, KV, hd): batch over the batch axes, then KV
    heads on "model" when divisible, else the sequence dim. SSM/RG-LRU
    state (.../h, .../conv): d_inner on "model". Counters (the port's
    ``kv_len`` is a Python int) replicate.
    """
    sizes = _axis_sizes(mesh)
    model = sizes.get(MODEL_AXIS, 1)
    baxes = batch_axes(mesh)
    btotal = 1
    for a in baxes:
        btotal *= sizes[a]

    def bspec(batch_dim_size):
        if shard_batch and btotal > 1 and batch_dim_size % btotal == 0:
            return baxes
        return None

    def rule(path, leaf):
        p = path_str(path)
        shape = tuple(getattr(leaf, "shape", ()))
        ndim = len(shape)
        if ndim == 0 or p.endswith("kv_len"):
            return P()
        if p.endswith("/k") or p.endswith("/v"):
            rep, B, S, KV, hd = shape
            if KV % model == 0 and model > 1:
                return P(None, bspec(B), None, MODEL_AXIS, None)
            if S % model == 0 and model > 1:
                return P(None, bspec(B), MODEL_AXIS, None, None)
            return P(None, bspec(B), None, None, None)
        if p.endswith("/h"):              # (rep, B, d_inner[, state])
            spec = [None, bspec(shape[1])] + [None] * (ndim - 2)
            if shape[2] % model == 0 and model > 1:
                spec[2] = MODEL_AXIS
            return P(*spec)
        if p.endswith("/conv"):           # (rep, B, width, d_inner)
            spec = [None, bspec(shape[1]), None, None]
            if shape[3] % model == 0 and model > 1:
                spec[3] = MODEL_AXIS
            return P(*spec)
        if p.endswith("c_kv") or p.endswith("k_rope"):  # MLA (rep, B, S, r)
            return P(None, bspec(shape[1]), *([None] * (ndim - 2)))
        if p.endswith("enc_out"):         # (B, T, d)
            return P(bspec(shape[0]), *([None] * (ndim - 1)))
        return P(*([None] * ndim))

    return _map_with_path(rule, state)


def placements(spec: P, mesh) -> list:
    """The DTensor placements of ``spec`` on ``mesh`` (its axis names in
    order): ``Shard(dim)`` for a mesh axis that a dim of the spec names,
    ``Replicate()`` for one that none names. A pure function of the two; a
    real ``DeviceMesh`` with the same axis names takes the list as it
    is."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            if ax in by_axis:
                raise ValueError(f"mesh axis {ax!r} shards two dims of "
                                 f"{spec}")
            by_axis[ax] = dim
    unknown = set(by_axis) - set(mesh.axis_names)
    if unknown:
        raise ValueError(f"{spec} names axes {sorted(unknown)} that "
                         f"{mesh} lacks")
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in mesh.axis_names]


def named_shardings(specs, mesh):
    """A spec tree -> the tree of each spec's `placements` on ``mesh``."""
    return _map_with_path(lambda _, s: placements(s, mesh), specs)
