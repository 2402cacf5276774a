"""Three-term roofline of one step on the card, the counterpart of
`repro.roofline.analysis`:

  compute    = FLOPs / peak FLOP/s
  memory     = bytes / HBM bandwidth
  collective = collective bytes / link bandwidth

XLA's ``compiled.cost_analysis()`` and ``memory_analysis()`` have no
PyTorch counterpart. In their place `count_step` runs the step once under
`StepCounter`, a ``TorchDispatchMode`` that sees every aten op below
autograd, the backward's included, on any device: on ``meta`` tensors it
counts a step that is never computed, at any size, and on CUDA tensors the
same step as it runs. It records

* the FLOPs of every aten op that ``torch.utils.flop_counter``'s registry
  prices (the products, convolutions and attention ops), and the analytic
  FLOPs and bytes each hand-written kernel reports for its launch
  through `obs.prof`'s launch hook (the counter watches it while it
  counts), since a ``ctypes`` launch is no aten op;
* the bytes of every aten op's tensor operands and results. This is the
  eager, unfused analogue of XLA's "bytes accessed": each op reads its
  inputs from device memory and writes its results there, as PyTorch runs
  it; views and allocations move nothing and count nothing, nor do 0-dim
  operands (a scalar broadcast into an elementwise op is read from cache,
  and the optimizer's one a slice of a leaf would make the count depend
  on how the leaves split into slices, not only on depth);
* the live bytes of the storages the step allocates, and their peak;
* the ``torch.distributed`` collectives it dispatches, priced by
  `collective_bytes`.

The port's segments loop over their repeats in Python, so a count at full
depth is exact; the affine fit over depth (`fit_depth`) is kept, and must
reproduce it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import weakref
from typing import Any, Dict, Iterable, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.obs import prof as PF
from repro_torch.roofline.hw import H100, HWSpec

# wire traffic per device as a multiple of the RESULT bytes (ring algorithms)
_WIRE_FACTOR = {
    "all-gather": 1.0,          # receives (n-1)/n of the result ~ result
    "all-reduce": 2.0,          # reduce-scatter + all-gather
    "reduce-scatter": 1.0,      # sends operand, result is the shard: operand ~ n*result
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# torch.distributed's ops (c10d and the functional collectives) by the
# collective they run
_COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_strided,
               torch.ops.aten.empty_like, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided}


def collective_bytes(records: Iterable[Tuple[str, float]]) -> Dict[str, float]:
    """Per-op-kind wire bytes per device from (kind, result bytes) records
    of the collectives a step dispatched (`StepCounter.collectives`); the
    reference parses the same records out of post-SPMD HLO."""
    out: Dict[str, float] = {}
    for kind, nbytes in records:
        out[kind] = out.get(kind, 0.0) + nbytes * _WIRE_FACTOR[kind]
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


# ---------------------------------------------------------------------------
# counting one step
# ---------------------------------------------------------------------------

_LOCK = threading.Lock()


def _tensors(obj) -> List[torch.Tensor]:
    return [t for t in tree_flatten(obj)[0] if isinstance(t, torch.Tensor)]


def _storage_bytes(tensors: Iterable[torch.Tensor]) -> Dict[int, int]:
    """Storage -> its bytes, each storage once."""
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in tensors}


class StepCounter(TorchDispatchMode):
    """Counts the aten ops of whatever runs inside it (see the module
    docstring). ``args`` are the step's arguments: their storages are the
    arguments' bytes and are never counted as allocated by the step."""

    def __init__(self, args=()):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: Dict[str, int] = collections.Counter()
        self.bytes_by_op: Dict[str, int] = collections.Counter()
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.libraries: set = set()
        self.collectives: List[Tuple[str, int]] = []
        self.args = _storage_bytes(_tensors(args))
        self.written: set = set()
        self.live = 0
        self.peak = 0
        self._seen: Dict[int, int] = {}
        self._open = True

    # -- records ---------------------------------------------------------------

    def add_kernel(self, name: str, flops: int, nbytes: int,
                   library: str) -> None:
        """A hand-written kernel's launch, priced by its wrapper's analytic
        cost (`obs.prof.launched`): where it launches on CUDA and where
        its meta branch stands in for it."""
        with _LOCK:
            self.flops += int(flops)
            self.bytes += int(nbytes)
            rec = self.kernels.setdefault(
                name, {"launches": 0, "flops": 0, "bytes": 0})
            rec["launches"] += 1
            rec["flops"] += int(flops)
            rec["bytes"] += int(nbytes)
            self.libraries.add(library)

    def _free(self, key: int, nbytes: int) -> None:
        with _LOCK:
            if self._open and self._seen.pop(key, None) is not None:
                self.live -= nbytes

    def _allocated(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen or key in self.args:
            return
        nbytes = st.nbytes()
        with _LOCK:
            self._seen[key] = nbytes
            self.live += nbytes
            self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, nbytes)

    # -- the mode --------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if func.namespace in ("c10d", "_c10d_functional", "c10d_functional"):
            kind = _COLLECTIVE_OPS.get(packet.__name__)
            if kind is not None:
                self.collectives.append(
                    (kind, sum(t.numel() * t.element_size()
                               for t in _tensors(out))))
            return out
        from torch.utils.flop_counter import flop_registry
        counter = flop_registry.get(packet)
        if counter is not None:
            n = int(counter(*args, **kwargs, out_val=out))
            with _LOCK:
                self.flops += n
                self.flops_by_op[str(packet.__name__)] += n
        outs = _tensors(out)
        if not func.is_view and packet not in _NO_TRAFFIC:
            ins = _tensors((args, kwargs))
            moved = sum(t.numel() * t.element_size() for t in ins + outs
                        if t.dim())
            with _LOCK:
                self.bytes += moved
                self.bytes_by_op[str(packet.__name__)] += moved
        for i, a in enumerate(func._schema.arguments):
            if a.alias_info is not None and a.alias_info.is_write:
                v = args[i] if i < len(args) else kwargs.get(a.name)
                for t in _tensors(v):
                    self.written.add(t.untyped_storage()._cdata)
        for t in outs:
            self._allocated(t)
        return out

    def __enter__(self):
        PF.watch(self.add_kernel)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            PF.unwatch(self.add_kernel)


@dataclasses.dataclass
class StepCount:
    """What `count_step` returns: the step's own result and its counter."""
    result: Any
    counter: StepCounter
    output_bytes: int
    alias_bytes: int


def count_step(fn, *args, **kwargs) -> StepCount:
    """Run ``fn(*args, **kwargs)`` once under a `StepCounter`. Its FLOPs,
    bytes and memory are read by `cost_dict` and `memory_dict`."""
    counter = StepCounter(args)
    with counter:
        result = fn(*args, **kwargs)
    counter._open = False
    outs = _storage_bytes(_tensors(result))
    alias = sum(n for k, n in outs.items()
                if k in counter.args and k in counter.written)
    return StepCount(result=result, counter=counter,
                     output_bytes=sum(outs.values()), alias_bytes=alias)


def cost_dict(count: StepCount) -> Dict[str, int]:
    """{"flops", "bytes"} of the step (integers: exact at any size)."""
    return {"flops": count.counter.flops, "bytes": count.counter.bytes}


def memory_dict(count: StepCount) -> Dict[str, float]:
    """XLA's ``memory_analysis()`` keys: the arguments (state and inputs),
    the outputs, the argument bytes the step wrote in place and returns
    (what a donated step aliases), the temporaries (the peak of the live
    storages the step allocated, beyond the arguments) and the code (the
    kernel libraries the step launched, where they are built)."""
    from repro_torch.kernels import build
    code = 0
    for lib in sorted(count.counter.libraries):
        so = build.library_path(lib)
        if so.exists():
            code += so.stat().st_size
    return {
        "argument_bytes": float(sum(count.counter.args.values())),
        "output_bytes": float(count.output_bytes),
        "temp_bytes": float(count.counter.peak),
        "alias_bytes": float(count.alias_bytes),
        "code_bytes": float(code),
    }


# ---------------------------------------------------------------------------
# affine depth extrapolation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DepthFit:
    """cost(R) = base + sum_i R_i * body_i, one entry per depth knob."""
    base: Dict[str, float]
    bodies: List[Dict[str, float]]

    def at(self, repeats: Sequence[int]) -> Dict[str, float]:
        assert len(repeats) == len(self.bodies)
        out = dict(self.base)
        for r, b in zip(repeats, self.bodies):
            for k, v in b.items():
                out[k] = out.get(k, 0.0) + r * v
        return out


def fit_depth(measure, n_knobs: int) -> DepthFit:
    """measure(repeats_tuple) -> dict of costs; lowers n_knobs+1 variants:
    all-ones and ones+e_i."""
    ones = tuple([1] * n_knobs)
    f0 = measure(ones)
    bodies = []
    for i in range(n_knobs):
        r = list(ones)
        r[i] += 1
        fi = measure(tuple(r))
        bodies.append({k: fi.get(k, 0.0) - f0.get(k, 0.0) for k in f0})
    base = {k: f0[k] - sum(b.get(k, 0.0) for b in bodies) for k in f0}
    return DepthFit(base=base, bodies=bodies)


# ---------------------------------------------------------------------------
# roofline terms
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    hw: HWSpec = H100

    @property
    def t_compute(self) -> float:
        return self.flops_per_chip / self.hw.peak_flops

    @property
    def t_memory(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.coll_bytes_per_chip / self.hw.ici_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_step(self) -> float:
        """Ideal-overlap step time: max of the three engines."""
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def t_serial(self) -> float:
        return self.t_compute + self.t_memory + self.t_collective

    def as_dict(self) -> Dict[str, float]:
        return {
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "t_step_s": self.t_step,
            "dominant": self.dominant,
        }


def model_flops(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference forward)."""
    per_tok = 6.0 if kind == "train" else 2.0
    return per_tok * n_active_params * tokens
