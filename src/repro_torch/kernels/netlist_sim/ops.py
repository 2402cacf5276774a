"""Population netlist simulation: one launch for P candidates x B samples.

Three engines over one packing (`pack.py`) and one oracle (`ref.py`):

* ``"ref"`` — the numpy oracle.
* ``"levels"`` — the plain PyTorch version: a host-built global wave
  schedule over the concatenated node tables (`_global_schedule`), run as a
  loop over fixed-width waves — gather, branchless ``torch.where`` opcode
  dispatch, scatter. Every wave of level l-1 precedes every wave of level
  l, so lanes inside a wave are independent. Padding lanes carry
  ``op = NOP`` and scatter to a dummy slot.
* ``"cuda"`` — `netlist_sim`, the wrapper of the hand-written CUDA kernel
  (``csrc/netlist_sim.cu``). It has two bodies, chosen by shape
  (`smem_tile`): a level-parallel walk with a tile of samples' slot values
  in shared memory, and, for a population too large for that, one thread
  per (candidate, sample) walking its slots through device memory. On a
  CUDA tensor it launches the kernel or raises; only for a tensor on the
  CPU does it run ``levels``.

Lanes are int32 when the verifier's per-node width bound over the population
is <= 32, int64 otherwise, in every engine; all are bit-exact against the
oracle. The reference's shape bucketing and candidate padding existed to
reuse XLA executables; eager torch and a kernel that takes its sizes at run
time need neither.

Every launch is accounted under the reference's names
(`simulate_population`): ``netlist_sim.launches`` and
``netlist_sim.candidates``, and the ``netlist_sim.pad.*`` counters, the
``netlist_sim.lane_util`` gauge, its histograms and the
``netlist_sim.padding`` event for the port's own padding. Its "lanes" are,
for the kernel's two bodies, the dense (P, N) node-table slots a launch
stages against the candidates' real slots (``n_nodes``), and for the plain
version, the wave grid (waves x ``window``) against the waves' real ops;
its "rows" are the samples: B real against the samples the grid covers (B
rounded up to the shared-memory body's tile, to the global body's block of
`BLOCK`, or B itself for the plain version). Candidates are never padded.
With tracing on, each kernel launch dispatches through the executable
observatory as ``kernels.netlist_sim.smem`` or
``kernels.netlist_sim.global`` with its analytic operations and bytes
(`cost`).
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.circuit import ir
from repro_torch.configs import backend
from repro_torch.kernels import LAUNCHES
from repro_torch.obs import metrics as MT
from repro_torch.obs import prof as PF
from repro_torch.obs import trace as TR
from repro_torch.kernels.netlist_sim.pack import (NOP, PackedPopulation,
                                                  pack_netlist,
                                                  pack_population)
from repro_torch.kernels.netlist_sim.ref import (_normalize_x,
                                                 simulate_population_ref)

_CONST = int(ir.Op.CONST)
_SHL = int(ir.Op.SHL)
_ADD = int(ir.Op.ADD)
_SUB = int(ir.Op.SUB)
_NEG = int(ir.Op.NEG)
_RELU = int(ir.Op.RELU)
_ARGMAX = int(ir.Op.ARGMAX)
_TRUNC = int(ir.Op.TRUNC)

# threads per block of the global-scratch body: small blocks spread one
# generation's few hundred warps over all 132 SMs
BLOCK = 64
# the tiles of samples a block of the shared-memory body may take
TILES = (16, 8, 4, 2, 1)


def lane_dtype(pop: PackedPopulation) -> torch.dtype:
    return torch.int32 if pop.max_width <= 32 else torch.int64


def smem_bytes(N: int, bt: int, lane_bytes: int) -> int:
    """Shared memory of one block of the shared-memory body: a 16-byte
    descriptor and ``bt`` lane values a slot."""
    return N * (16 + bt * lane_bytes)


def smem_tile(P: int, N: int, B: int, lane_bytes: int, sms: int,
              smem_max: int) -> Optional[int]:
    """The samples a block of the shared-memory body takes, or None for the
    global-scratch body, from the population's shape and the card's
    ``sms`` SMs and ``smem_max`` bytes of shared memory a block
    (`device_limits`; 132 and 227 KB on the H100).

    The largest tile of `TILES` that fits twice in ``smem_max`` (two
    blocks an SM) and gives a grid of at least two blocks an SM; where no
    tile gives that many blocks, the largest that fits twice; else the
    largest that fits once. None where even one sample's table exceeds
    ``smem_max``."""
    fits = [bt for bt in TILES if smem_bytes(N, bt, lane_bytes) <= smem_max]
    if not fits:
        return None
    twice = [bt for bt in fits
             if 2 * smem_bytes(N, bt, lane_bytes) <= smem_max]
    full = [bt for bt in twice if P * -(-B // bt) >= 2 * sms]
    return (full or twice or fits)[0]


def cost(pop: PackedPopulation, B: int, lane_bytes: int, *,
         smem: bool = True) -> Tuple[int, int]:
    """(integer operations, bytes) of one kernel launch over B samples:
    every computed slot (SHL..TRUNC, not CONST, INPUT or ARGMAX) once a
    sample; the op tables, x, the comparator operands and the class
    decisions each moved once, and the level tables for the shared-memory
    body. The counts behind the kernel's bound."""
    P, N = pop.op.shape
    n = pop.n_nodes.astype(np.int64)
    valid = np.arange(N)[None, :] < n[:, None]
    comp = valid & (pop.op >= _SHL) & (pop.op != _ARGMAX)
    ops = int(comp.sum()) * B
    nbytes = (pop.op.size * 4 * 4 + pop.op.size * lane_bytes + P * 4
              + pop.input_pos.size * 4 + pop.argmax_pos.size * 4
              + P * B * pop.n_inputs * lane_bytes
              + P * B * pop.n_classes * lane_bytes + P * B * 8)
    if smem:
        nbytes += pop.level_ptr.size * 4 + P * 4
    return ops, nbytes


def device_limits(device: torch.device) -> Tuple[int, int]:
    """(SMs, the most shared memory a block can take) of a CUDA device, the
    latter as the kernel's library reads it."""
    from repro_torch.kernels import build
    fn = build.load("netlist_sim").netlist_sim_smem_limit
    fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    smem = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = fn(ctypes.byref(smem))
    if rc != 0:
        raise RuntimeError(f"netlist_sim_smem_limit failed: CUDA error {rc}")
    return (torch.cuda.get_device_properties(device).multi_processor_count,
            smem.value)


# ---------------------------------------------------------------------------
# plain PyTorch version ("levels")
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _Schedule:
    """Host-derived global wave schedule (numpy)."""
    OP: np.ndarray        # (n_waves, W) int32, NOP on padding lanes
    AI: np.ndarray        # (n_waves, W) int32 global operand positions
    BI: np.ndarray        # (n_waves, W) int32
    SH: np.ndarray        # (n_waves, W) int32 immediates (0 elsewhere)
    OUT: np.ndarray       # (n_waves, W) int32 global out positions
    vals0: np.ndarray     # (N_buf,) int64 CONST-seeded initial buffer
    inp_cols: np.ndarray  # (P, n_in) int32 global input positions
    am_cols: np.ndarray   # (P, C) int32 global comparator-operand positions


def _global_schedule(pop: PackedPopulation, window: int) -> _Schedule:
    """Concatenate the population's tables into one flat position space
    (candidate p's slot s lives at ``off[p] + s``) and chunk each global
    level into waves of at most ``window`` lanes. Vectorized numpy."""
    P, N = pop.op.shape
    n = pop.n_nodes.astype(np.int64)
    off = np.zeros(P, np.int64)
    off[1:] = np.cumsum(n)[:-1]
    total = int(n.sum())
    slot = np.arange(N, dtype=np.int64)
    valid = slot[None, :] < n[:, None]                    # (P, N)
    gpos = slot[None, :] + off[:, None]                   # (P, N)
    lvls = np.zeros((P, N), np.int64)
    for p in range(P):
        ptr = pop.level_ptr[p].astype(np.int64)
        lvls[p, :n[p]] = np.repeat(np.arange(ptr.size - 1), np.diff(ptr))

    comp = valid & (pop.op >= _SHL) & (pop.op != _ARGMAX)
    op_c = pop.op[comp].astype(np.int64)
    a_c = (pop.arg_a + off[:, None])[comp]
    b_c = (pop.arg_b + off[:, None])[comp]
    sh_c = pop.shift[comp].astype(np.int64)
    out_c = gpos[comp]
    lv_c = lvls[comp]

    ordr = np.argsort(lv_c, kind="stable")
    op_s, a_s, b_s = op_c[ordr], a_c[ordr], b_c[ordr]
    sh_s, out_s, lv_s = sh_c[ordr], out_c[ordr], lv_c[ordr]
    M = op_s.size

    counts = np.bincount(lv_s) if M else np.zeros(1, np.int64)
    wins = -(-counts // window)                           # ceil per level
    wstart = np.concatenate([[0], np.cumsum(wins)])
    lfirst = np.concatenate([[0], np.cumsum(counts)])
    rank = np.arange(M) - lfirst[lv_s]
    row = wstart[lv_s] + rank // window
    col = rank % window

    nw = int(wstart[-1])
    dummy = total                                         # +1: dummy slot
    OP = np.full((nw, window), NOP, np.int32)
    AI = np.zeros((nw, window), np.int32)
    BI = np.zeros((nw, window), np.int32)
    SH = np.zeros((nw, window), np.int32)
    OUT = np.full((nw, window), dummy, np.int32)
    OP[row, col] = op_s
    AI[row, col] = a_s
    BI[row, col] = b_s
    SH[row, col] = sh_s
    OUT[row, col] = out_s

    vals0 = np.zeros(total + 1, np.int64)
    cmask = valid & (pop.op == _CONST)
    vals0[gpos[cmask]] = pop.val[cmask]
    return _Schedule(
        OP=OP, AI=AI, BI=BI, SH=SH, OUT=OUT, vals0=vals0,
        inp_cols=(pop.input_pos + off[:, None]).astype(np.int32),
        am_cols=(pop.argmax_pos + off[:, None]).astype(np.int32))


def simulate_levels(pop: PackedPopulation, x: torch.Tensor, *,
                    window: int = 256) -> torch.Tensor:
    """The plain version. x: (P, B, n_in) integer tensor on any device.
    -> amx (P, B, C) int64 on x's device. Padding lanes fall through to the
    TRUNC arm with shift 0 and scatter to the dummy slot."""
    dev, dt = x.device, lane_dtype(pop)
    P, B, _ = x.shape
    sched = _global_schedule(pop, window)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(a, device=dev).to(dtype)

    OP, AI, BI, SH, OUT = (t(a) for a in (sched.OP, sched.AI, sched.BI,
                                          sched.SH, sched.OUT))
    SHd = SH.to(dt)
    vals = t(sched.vals0, dt)[None, :].repeat(B, 1)
    # (P, B, n_in) -> (B, P*n_in) columns in global-position order
    vals[:, t(sched.inp_cols).reshape(-1)] = \
        x.to(dt).permute(1, 0, 2).reshape(B, -1)
    for w in range(OP.shape[0]):
        o, sh = OP[w], SHd[w]
        a = vals[:, AI[w]]
        b = vals[:, BI[w]]
        r = torch.where(o == _SHL, torch.bitwise_left_shift(a, sh),
            torch.where(o == _ADD, a + b,
            torch.where(o == _SUB, a - b,
            torch.where(o == _NEG, -a,
            torch.where(o == _RELU, torch.clamp_min(a, 0),
                        # TRUNC (and NOP padding, with sh = 0)
                        torch.bitwise_left_shift(
                            torch.bitwise_right_shift(a, sh), sh))))))
        vals[:, OUT[w]] = r
    amx = vals[:, t(sched.am_cols)]                        # (B, P, C)
    return amx.permute(1, 0, 2).to(torch.int64).contiguous()


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _check_tables(pop: PackedPopulation) -> None:
    """Host-side bounds of every index the kernel dereferences."""
    P, N = pop.op.shape
    n = pop.n_nodes.astype(np.int64)
    if P > 65535 or np.any(n < 0) or np.any(n > N):
        raise ValueError(f"bad population shape P={P}, N={N}, n_nodes={n}")
    real = np.arange(N)[None, :] < n[:, None]
    for name in ("arg_a", "arg_b"):
        a = getattr(pop, name)
        if np.any(real & ((a < 0) | (a >= n[:, None]))):
            raise ValueError(f"{name} points outside its candidate's slots")
    for name in ("input_pos", "argmax_pos"):
        a = getattr(pop, name)
        if np.any((a < 0) | (a >= n[:, None])):
            raise ValueError(f"{name} points outside its candidate's slots")
    check_levels(pop)


def check_levels(pop: PackedPopulation) -> None:
    """The order the shared-memory body's level barriers rely on: each
    candidate's levels tile its slots [0, n_nodes) in order, and every
    operand of a computed slot lies in a strictly earlier level."""
    P, N = pop.op.shape
    ptr = pop.level_ptr.astype(np.int64)
    nl = pop.n_levels.astype(np.int64)
    L = ptr.shape[1] - 1
    if np.any(nl < 0) or np.any(nl > L) or np.any(ptr[:, 0] != 0) or \
            np.any(np.diff(ptr, axis=1) < 0) or \
            np.any(ptr[np.arange(P), nl] != pop.n_nodes):
        raise ValueError("level_ptr does not tile each candidate's slots")
    n = pop.n_nodes.astype(np.int64)
    lvl = np.zeros((P, N), np.int64)
    for p in range(P):
        lvl[p, :n[p]] = np.repeat(np.arange(L), np.diff(ptr[p]))
    real = np.arange(N)[None, :] < n[:, None]
    rows = np.arange(P)[:, None]
    two = (pop.op == _ADD) | (pop.op == _SUB)
    one = two | (pop.op == _SHL) | (pop.op == _NEG) | (pop.op == _RELU) | \
        (pop.op == _TRUNC)
    for args, used in ((pop.arg_a, one), (pop.arg_b, two)):
        late = real & used & (lvl[rows, args] >= lvl)
        if np.any(late):
            raise ValueError("an operand does not lie in an earlier level "
                             "than its slot")


class StagedLaunch:
    """One kernel launch with its inputs staged on the card: the op tables,
    x in the lane type, and the outputs (and, for the global-scratch body,
    its scratch) allocated with ``torch.empty``. The body follows from the
    shape (`smem_tile`; ``tile`` is None for the global body). `launch`
    enqueues the kernel on the current stream without synchronising;
    calling it again recomputes the same outputs."""

    def __init__(self, pop: PackedPopulation, x: torch.Tensor):
        from repro_torch.kernels import build
        _check_tables(pop)
        dev, dt = x.device, lane_dtype(pop)
        P, N = pop.op.shape
        B, C = x.shape[1], pop.n_classes
        self.tile = smem_tile(P, N, B, torch.iinfo(dt).bits // 8,
                              *device_limits(dev))

        def t(a, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(
                dtype).contiguous()

        tables = [t(pop.op), t(pop.arg_a), t(pop.arg_b), t(pop.shift),
                  t(pop.val, dt), t(pop.n_nodes)]
        self.amx = torch.empty((P, B, C), dtype=dt, device=dev)
        self.cls = torch.empty((P, B), dtype=torch.int64, device=dev)
        lib = build.load("netlist_sim")
        suffix = "i32" if dt == torch.int32 else "i64"
        if self.tile is None:
            self.scratch = torch.empty((P, N, B), dtype=dt, device=dev)
            self.inputs = tables + [t(pop.input_pos), t(pop.argmax_pos),
                                    x.to(dt).contiguous(), self.scratch]
            self.dims = (P, N, B, pop.n_inputs, C, BLOCK)
            self.fn = getattr(lib, f"netlist_sim_{suffix}")
        else:
            self.inputs = tables + [t(pop.level_ptr), t(pop.n_levels),
                                    t(pop.input_pos), t(pop.argmax_pos),
                                    x.to(dt).contiguous()]
            self.dims = (P, N, pop.level_ptr.shape[1] - 1, B, pop.n_inputs,
                         C, self.tile.bit_length() - 1)
            self.fn = getattr(lib, f"netlist_sim_smem_{suffix}")
        self.fn.argtypes = [ctypes.c_void_p] * (len(self.inputs) + 2) + \
            [ctypes.c_int] * len(self.dims) + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.device = dev
        self.lane_bytes = torch.iinfo(dt).bits // 8
        self.body = "global" if self.tile is None else "smem"
        self.key = ("netlist_sim", self.body, P, N,
                    pop.level_ptr.shape[1] - 1, B, pop.n_inputs, C,
                    self.tile or BLOCK, suffix)
        grid_b = self.tile or BLOCK
        self.stats = {
            "engine": "cuda." + self.body, "key": self.key,
            "cand_real": P, "cand_total": P,
            "lanes_used": int(pop.n_nodes.sum()), "lanes_total": P * N,
            "rows_real": B, "rows_total": -(-B // grid_b) * grid_b,
            "tiles": -(-B // grid_b)}

    def launch(self) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = self.fn(*(a.data_ptr() for a in self.inputs),
                         self.amx.data_ptr(), self.cls.data_ptr(),
                         *self.dims, stream)
        if rc != 0:
            raise RuntimeError(f"netlist_sim kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["netlist_sim"] += 1
        if self.tile is not None:
            LAUNCHES["netlist_sim_smem"] += 1


def _levels_stats(pop: PackedPopulation, B: int, window: int) -> Dict:
    """The plain version's padding: its wave grid against the waves' real
    ops."""
    OP = _global_schedule(pop, window).OP
    return {"engine": "levels",
            "key": ("netlist_levels", OP.shape[0], window,
                    pop.n_candidates, pop.n_inputs, pop.n_classes, B),
            "cand_real": pop.n_candidates, "cand_total": pop.n_candidates,
            "lanes_used": int((OP != NOP).sum()), "lanes_total": OP.size,
            "rows_real": B, "rows_total": B, "tiles": 1}


def netlist_sim(pop: PackedPopulation, x: torch.Tensor, *,
                window: int = 256, stats: Optional[Dict] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper. x: (P, B, n_in) integer tensor.
    -> (amx (P, B, C) int64, cls (P, B) int64) on x's device.

    A CUDA tensor launches the kernel (counted in
    ``repro_torch.kernels.LAUNCHES["netlist_sim"]``, and in
    ``LAUNCHES["netlist_sim_smem"]`` where it took the shared-memory body)
    or raises; a CPU tensor takes the plain version `simulate_levels`.
    ``stats``, if given, receives the launch's padding accounting."""
    if x.dim() != 3 or x.shape[0] != pop.n_candidates \
            or x.shape[2] != pop.n_inputs:
        raise ValueError(f"x shape {tuple(x.shape)} vs population "
                         f"(P={pop.n_candidates}, n_in={pop.n_inputs})")
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"x must be int32/int64, got {x.dtype}")
    if x.device.type == "cpu":
        if stats is not None:
            stats.update(_levels_stats(pop, x.shape[1], window))
        amx = simulate_levels(pop, x, window=window)
        return amx, torch.argmax(amx, dim=-1)
    if x.device.type != "cuda":
        raise ValueError(f"netlist_sim runs on CUDA or CPU, not {x.device}")
    run = StagedLaunch(pop, x)
    if stats is not None:
        stats.update(run.stats)
    if not PF.observed():
        run.launch()
    else:
        ops, nbytes = cost(pop, x.shape[1], run.lane_bytes,
                           smem=run.tile is not None)
        with PF.kernel("kernels.netlist_sim." + run.body, run.key,
                         device=x.device, args=run.inputs, flops=ops,
                         bytes_accessed=nbytes, library="netlist_sim",
                         p=pop.n_candidates, b=x.shape[1],
                         tiles=run.stats["tiles"]) as call:
            run.launch()
            call.outputs = (run.amx, run.cls)
    return run.amx.to(torch.int64), run.cls


# ---------------------------------------------------------------------------
# population entry points
# ---------------------------------------------------------------------------


def simulate_population(pop: PackedPopulation, x: np.ndarray, *,
                        engine: Optional[str] = None,
                        device: DeviceLike = None,
                        window: int = 256) -> Dict[str, np.ndarray]:
    """Simulate P packed candidates over a batch in one launch.

    x: (B, n_in) shared inputs or (P, B, n_in) per-candidate. engine:
    ``"cuda"`` (the kernel on a CUDA device, its plain version on
    ``device="cpu"``), ``"levels"`` (the plain version on ``device``) or
    ``"ref"`` (numpy); None takes
    `configs.backend.default_netlist_engine` of the device: ``"cuda"`` on
    a CUDA device, ``"levels"`` on the CPU, unless ``REPRO_NETLIST_ENGINE``
    says otherwise. -> {"amx": (P, B, C) int64 comparator operands,
    "argmax": (P, B) int64 class decisions}."""
    x = np.asarray(_normalize_x(pop, x))
    if engine is None:
        engine = backend.default_netlist_engine(resolve_device(device))
    if engine == "ref":
        return simulate_population_ref(pop, x)
    if engine not in ("levels", "cuda"):
        raise ValueError(f"unknown engine {engine!r}")
    xt = torch.as_tensor(x, device=resolve_device(device))
    P, B = x.shape[0], x.shape[1]
    MT.counter("netlist_sim.launches").inc()
    MT.counter("netlist_sim.candidates").inc(P)
    stats: Dict = {}
    with (TR.span("kernels.netlist_sim", engine=engine, p=P, b=B,
                  slots=int(pop.n_nodes.sum()))
          if TR.active() else contextlib.nullcontext()):
        if engine == "levels":
            stats.update(_levels_stats(pop, B, window))
            amx = simulate_levels(pop, xt, window=window)
            cls = torch.argmax(amx, dim=-1)
        else:
            amx, cls = netlist_sim(pop, xt, window=window, stats=stats)
        out = {"amx": amx.cpu().numpy(), "argmax": cls.cpu().numpy()}
    _account_padding(stats)
    return out


def _account_padding(stats: Dict) -> None:
    """Always-on packing-efficiency accounting for one launch, under the
    reference's names with the port's own lanes and rows (module
    docstring). Counters hold exact totals (deterministic functions of the
    evaluated populations, so they keep the checkpoint bit-identity
    contract); utilization ratios go to gauges/histograms; the full stats
    ride the trace as a ``netlist_sim.padding`` event when tracing."""
    lanes_u, lanes_t = stats["lanes_used"], stats["lanes_total"]
    rows_r, rows_t = stats["rows_real"], stats["rows_total"]
    MT.counter("netlist_sim.pad.lanes_used").inc(lanes_u)
    MT.counter("netlist_sim.pad.lanes_total").inc(lanes_t)
    MT.counter("netlist_sim.pad.rows_real").inc(rows_r)
    MT.counter("netlist_sim.pad.rows_total").inc(rows_t)
    MT.counter("netlist_sim.pad.cand_real").inc(stats["cand_real"])
    MT.counter("netlist_sim.pad.cand_total").inc(stats["cand_total"])
    lane_util = lanes_u / max(lanes_t, 1)
    MT.gauge("netlist_sim.lane_util").set(lane_util)
    MT.histogram("netlist_sim.lane_util_hist").observe(lane_util)
    MT.histogram("netlist_sim.row_util_hist").observe(
        rows_r / max(rows_t, 1))
    if TR.active():
        TR.event("netlist_sim.padding",
                 **{k: (PF.key_str(v) if k == "key" else v)
                    for k, v in stats.items()})


def population_accuracy(pop: PackedPopulation, x: np.ndarray,
                        y: np.ndarray, **kw) -> np.ndarray:
    """Netlist-exact test accuracy per candidate: -> (P,) float64. ``x``
    must already be ADC-quantized integers (see
    `minimize.quantize_inputs`)."""
    cls = simulate_population(pop, x, **kw)["argmax"]
    return np.mean(cls == np.asarray(y)[None, :], axis=1)


__all__ = ["simulate_population", "population_accuracy", "netlist_sim",
           "simulate_levels", "smem_tile", "device_limits", "check_levels",
           "cost",
           "pack_netlist", "pack_population", "simulate_population_ref"]
