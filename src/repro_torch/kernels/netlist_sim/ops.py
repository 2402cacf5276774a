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
  (``csrc/netlist_sim.cu``): one thread per (candidate, sample) walking its
  candidate's slots in topological order. On a CUDA tensor it launches the
  kernel or raises; only for a tensor on the CPU does it run ``levels``.

Lanes are int32 when the verifier's per-node width bound over the population
is <= 32, int64 otherwise, in every engine; all are bit-exact against the
oracle. The reference's shape bucketing and candidate padding existed to
reuse XLA executables; eager torch and a kernel that takes its sizes at run
time need neither.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.circuit import ir
from repro_torch.kernels import LAUNCHES
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

# threads per block of the CUDA kernel: small blocks spread one
# generation's few hundred warps over all 132 SMs
BLOCK = 64


def lane_dtype(pop: PackedPopulation) -> torch.dtype:
    return torch.int32 if pop.max_width <= 32 else torch.int64


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


class StagedLaunch:
    """One kernel launch with its inputs staged on the card: the op tables,
    x in the lane type, and the scratch and outputs allocated with
    ``torch.empty``. `launch` enqueues the kernel on the current stream
    without synchronising; calling it again recomputes the same outputs."""

    def __init__(self, pop: PackedPopulation, x: torch.Tensor):
        from repro_torch.kernels import build
        _check_tables(pop)
        dev, dt = x.device, lane_dtype(pop)
        P, N = pop.op.shape
        self.dims = (P, N, x.shape[1], pop.n_inputs, pop.n_classes)

        def t(a, dtype=torch.int32):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev).to(
                dtype).contiguous()

        self.inputs = [t(pop.op), t(pop.arg_a), t(pop.arg_b), t(pop.shift),
                       t(pop.val, dt), t(pop.n_nodes), t(pop.input_pos),
                       t(pop.argmax_pos), x.to(dt).contiguous()]
        B, C = self.dims[2], self.dims[4]
        self.scratch = torch.empty((P, N, B), dtype=dt, device=dev)
        self.amx = torch.empty((P, B, C), dtype=dt, device=dev)
        self.cls = torch.empty((P, B), dtype=torch.int64, device=dev)
        lib = build.load("netlist_sim")
        self.fn = lib.netlist_sim_i32 if dt == torch.int32 \
            else lib.netlist_sim_i64
        self.fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int
        self.device = dev

    def launch(self) -> None:
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            rc = self.fn(*(a.data_ptr() for a in self.inputs),
                         self.scratch.data_ptr(), self.amx.data_ptr(),
                         self.cls.data_ptr(), *self.dims, BLOCK, stream)
        if rc != 0:
            raise RuntimeError(f"netlist_sim kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["netlist_sim"] += 1


def netlist_sim(pop: PackedPopulation, x: torch.Tensor, *,
                window: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel wrapper. x: (P, B, n_in) integer tensor.
    -> (amx (P, B, C) int64, cls (P, B) int64) on x's device.

    A CUDA tensor launches the kernel (counted in
    ``repro_torch.kernels.LAUNCHES["netlist_sim"]``) or raises; a CPU tensor
    takes the plain version `simulate_levels`."""
    if x.dim() != 3 or x.shape[0] != pop.n_candidates \
            or x.shape[2] != pop.n_inputs:
        raise ValueError(f"x shape {tuple(x.shape)} vs population "
                         f"(P={pop.n_candidates}, n_in={pop.n_inputs})")
    if x.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"x must be int32/int64, got {x.dtype}")
    if x.device.type == "cpu":
        amx = simulate_levels(pop, x, window=window)
        return amx, torch.argmax(amx, dim=-1)
    if x.device.type != "cuda":
        raise ValueError(f"netlist_sim runs on CUDA or CPU, not {x.device}")
    run = StagedLaunch(pop, x)
    run.launch()
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
    ``"cuda"`` (the default: the kernel on a CUDA device, its plain version
    on ``device="cpu"``), ``"levels"`` (the plain version on ``device``) or
    ``"ref"`` (numpy). -> {"amx": (P, B, C) int64 comparator operands,
    "argmax": (P, B) int64 class decisions}."""
    x = np.asarray(_normalize_x(pop, x))
    engine = engine or "cuda"
    if engine == "ref":
        return simulate_population_ref(pop, x)
    xt = torch.as_tensor(x, device=resolve_device(device))
    if engine == "levels":
        amx = simulate_levels(pop, xt, window=window)
        cls = torch.argmax(amx, dim=-1)
    elif engine == "cuda":
        amx, cls = netlist_sim(pop, xt, window=window)
    else:
        raise ValueError(f"unknown engine {engine!r}")
    return {"amx": amx.cpu().numpy(), "argmax": cls.cpu().numpy()}


def population_accuracy(pop: PackedPopulation, x: np.ndarray,
                        y: np.ndarray, **kw) -> np.ndarray:
    """Netlist-exact test accuracy per candidate: -> (P,) float64. ``x``
    must already be ADC-quantized integers (see
    `minimize.quantize_inputs`)."""
    cls = simulate_population(pop, x, **kw)["argmax"]
    return np.mean(cls == np.asarray(y)[None, :], axis=1)


__all__ = ["simulate_population", "population_accuracy", "netlist_sim",
           "simulate_levels", "pack_netlist", "pack_population",
           "simulate_population_ref"]
