"""Wrapper of kernel K6, the hand-written CUDA selective scan
(``csrc/ssm_scan.cu``).

`ssm_scan` takes the model's layout and mixed types, as the TPU kernel's
call does: u (B, T, d) with B_, C_ (B, T, N) in one type (float32 or
bf16), and dt (B, T, d), A (d, N), D (d,) in float32; it returns y
(B, T, d) in u's type. For CUDA tensors it launches the kernel (counted in
``repro_torch.kernels.LAUNCHES["ssm_scan"]``) or raises; the kernel masks
ragged T and d itself, so nothing is padded or copied. Only for CPU tensors
does it run the plain version `ssm_scan_ref`, whose own autograd gives the
gradient there. Meta tensors, under a `roofline.analysis.StepCounter`,
take the meta branch of the forward and the backward: empty outputs of the
kernels' shapes, their analytic costs recorded, nothing launched
(`kernels.check_device`).

On CUDA, when grad mode is on and an input requires grad, `ssm_scan` goes
through `SsmScanFn`, whose forward has K6 also store the states at the
start of every 16 steps (`ssm_scan_with_states`) and whose backward is the
hand-written kernel ``csrc/ssm_scan_bwd.cu`` (`ssm_scan_bwd`, counted in
``LAUNCHES["ssm_scan_bwd"]``) reading them, so y always carries a
``grad_fn`` there. Otherwise it launches K6 without the states, as the
serve and prefill paths do.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES, check_device
from repro_torch.obs import prof as PF
from repro_torch.kernels.ssm_scan.ref import (ssm_scan_bwd_plain,
                                               ssm_scan_ref,
                                               ssm_scan_states_plain)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 16          # the state values a channel holds in registers
BWD_CHUNK = 16          # steps between the states the forward saves
BWD_CHANNELS = 64       # channels a block of the backward
_FNS: Dict[str, object] = {}


def _kernel(dtype: torch.dtype, lib: str = "ssm_scan"):
    name = f"{lib}_{_SUFFIX[dtype]}"
    if name not in _FNS:
        from repro_torch.kernels import build
        fn = getattr(build.load(lib), name)
        n_ptr = 8 if lib == "ssm_scan" else 17
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check(u, dt, B_, C_, A, D) -> None:
    if u.dim() != 3 or B_.dim() != 3 or A.dim() != 2 or D.dim() != 1:
        raise ValueError(f"ssm_scan takes u, dt (B, T, d), B_, C_ (B, T, N), "
                         f"A (d, N), D (d,); got {tuple(u.shape)}, "
                         f"{tuple(B_.shape)}, {tuple(A.shape)}, "
                         f"{tuple(D.shape)}")
    Bsz, T, d = u.shape
    N = A.shape[1]
    if dt.shape != u.shape or B_.shape != (Bsz, T, N) or \
            C_.shape != B_.shape or A.shape != (d, N) or D.shape != (d,):
        raise ValueError(f"shape mismatch: u {tuple(u.shape)}, dt "
                         f"{tuple(dt.shape)}, B_ {tuple(B_.shape)}, C_ "
                         f"{tuple(C_.shape)}, A {tuple(A.shape)}, D "
                         f"{tuple(D.shape)}")
    if u.dtype not in _SUFFIX or not (u.dtype == B_.dtype == C_.dtype):
        raise TypeError(f"u, B_ and C_ must share float32 or bfloat16, got "
                        f"{u.dtype}, {B_.dtype}, {C_.dtype}")
    if not (dt.dtype == A.dtype == D.dtype == torch.float32):
        raise TypeError(f"dt, A and D must be float32, got {dt.dtype}, "
                        f"{A.dtype}, {D.dtype}")
    if len({a.device for a in (u, dt, B_, C_, A, D)}) != 1:
        raise ValueError("ssm_scan's inputs lie on different devices")


def cost(B: int, T: int, d: int, N: int, x_bytes: int) -> Tuple[int, int]:
    """(float32 operations, bytes) of one scan: N state updates of 5
    operations (dt A, its exp's argument times h, dt u, its product with
    B_, the add) and N multiply-adds into y per (b, t, channel), plus D u;
    u, B_, C_ (``x_bytes`` each), dt, A, D (float32) read once, y written
    once. The B T d N exps, on the special-function units, are counted
    apart by the caller that needs them. The counts behind the kernel's
    bound."""
    nbytes = (B * T * d * x_bytes + B * T * d * 4 + 2 * B * T * N * x_bytes
              + d * N * 4 + d * 4 + B * T * d * x_bytes)
    return B * T * d * (7 * N + 2), nbytes


def bwd_cost(B: int, T: int, d: int, N: int, x_bytes: int
             ) -> Tuple[int, int, int]:
    """(float32 operations, bytes, exps) of one backward: the reverse
    walk's operations per (b, t, channel, state) (dh, its products into
    ddt, dA, du, dB_ and dC_, the carried product: 14) and per (b, t,
    channel) (du, ddt, dD: 4); u, dt, B_, C_, dy, A, D read once, du, ddt,
    dB_, dC_, dA, dD written once; the B T d N exps of exp(dt A) the
    gradient needs. The counts behind the backward's bound (the kernel
    itself takes 2 B T d N exps, as it rebuilds each chunk's states, and
    reads the forward's chunk-start states beside these bytes)."""
    nbytes = (3 * B * T * d * x_bytes + 2 * B * T * d * 4
              + 4 * B * T * N * x_bytes + 2 * (d * N * 4 + d * 4))
    return B * T * d * (14 * N + 4), nbytes, B * T * d * N


def _launch_checks(u, dt, B_, C_, A, D) -> None:
    if not all(a.is_contiguous() for a in (u, dt, B_, C_, A, D)):
        raise ValueError("ssm_scan's kernel takes contiguous tensors")
    Bsz, T, d = u.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"ssm_scan's kernel takes a state of 1 to "
                         f"{MAX_STATE} values, got {N}")
    if Bsz > 65535 or Bsz * T * max(d, N) >= 2 ** 62 or max(T, d) >= 2 ** 31:
        raise ValueError(f"ssm_scan: shape {(Bsz, T, d, N)} out of the "
                         f"kernel's range")
    if u.device.type == "cuda" and \
            u.device.index != torch.cuda.current_device():
        raise ValueError(f"u lies on {u.device}, not the current device")


def ssm_scan_bwd(u, dt, B_, C_, A, D, dy, states):
    """(du, ddt, dB_, dC_, dA, dD) of `ssm_scan`'s y for the gradient dy,
    in the dtypes of (u, dt, B_, C_, A, D). ``states`` are the chunk-start
    states K6's forward stores (`ssm_scan_with_states`). CUDA tensors
    launch the backward kernel, which reads them (counted in
    ``LAUNCHES["ssm_scan_bwd"]``), or raise; CPU tensors run the plain
    version `ssm_scan_bwd_plain`, which rebuilds the states itself. The
    wrapper makes dy contiguous (a copy only when it is not) and allocates
    the kernel's float32 scratch: the per-block sums of dB_ and dC_ (B,
    d/64, T, 32), dA and dD per batch row."""
    _check(u, dt, B_, C_, A, D)
    if dy.shape != u.shape or dy.dtype != u.dtype or dy.device != u.device:
        raise ValueError(f"dy must match u: got {tuple(dy.shape)} "
                         f"{dy.dtype} on {dy.device}")
    if u.device.type == "cpu":
        return ssm_scan_bwd_plain(u, dt, B_, C_, A, D, dy)
    check_device("ssm_scan", u)
    _launch_checks(u, dt, B_, C_, A, D)
    Bsz, T, d = u.shape
    N = A.shape[1]
    if tuple(states.shape) != _states_shape(Bsz, T, d) or \
            states.dtype != torch.float32 or states.device != u.device or \
            not states.is_contiguous():
        raise ValueError(f"states must be {_states_shape(Bsz, T, d)} "
                         f"float32 contiguous on {u.device}, got "
                         f"{tuple(states.shape)} {states.dtype}")
    dy = dy.contiguous()
    f32 = dict(dtype=torch.float32, device=u.device)
    blocks = -(-d // BWD_CHANNELS)
    part = torch.empty((Bsz, blocks, T, 2 * MAX_STATE), **f32)
    dA_part = torch.empty((Bsz, d, N), **f32)
    dD_part = torch.empty((Bsz, d), **f32)
    du, ddt = torch.empty_like(u), torch.empty_like(dt)
    dB, dC = torch.empty_like(B_), torch.empty_like(C_)
    dA, dD = torch.empty_like(A), torch.empty_like(D)
    out = (du, ddt, dB, dC, dA, dD)
    if u.device.type == "meta":         # the meta branch: no launch
        PF.launched("kernels.ssm_scan_bwd",
                    *bwd_cost(Bsz, T, d, N, u.element_size())[:2],
                    "ssm_scan_bwd")
        return out
    fn = _kernel(u.dtype, "ssm_scan_bwd")

    def launch():
        rc = fn(u.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                A.data_ptr(), D.data_ptr(), dy.data_ptr(), states.data_ptr(),
                part.data_ptr(), dA_part.data_ptr(), dD_part.data_ptr(),
                du.data_ptr(), ddt.data_ptr(), dB.data_ptr(), dC.data_ptr(),
                dA.data_ptr(), dD.data_ptr(), Bsz, T, d, N,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ssm_scan_bwd kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["ssm_scan_bwd"] += 1

    if not PF.observed():
        launch()
        return out
    ops, nbytes, _ = bwd_cost(Bsz, T, d, N, u.element_size())
    with PF.kernel("kernels.ssm_scan_bwd",
                     ("ssm_scan_bwd", (Bsz, T, d), N, str(u.dtype)),
                     device=u.device, args=(u, dt, B_, C_, A, D, dy),
                     flops=ops, bytes_accessed=nbytes,
                     library="ssm_scan_bwd", b=Bsz, t=T, d=d, n=N) as call:
        launch()
        call.outputs = out
    return out


def _states_shape(Bsz: int, T: int, d: int) -> Tuple[int, int, int, int]:
    """The chunk-start states K6's forward stores: (B, ceil(T / 16), d, 16)
    float32, slots past N zero."""
    return (Bsz, -(-T // BWD_CHUNK), d, MAX_STATE)


class SsmScanFn(torch.autograd.Function):
    """K6's forward storing its chunk-start states, K6's backward kernel
    reading them as its gradient (CUDA only)."""

    @staticmethod
    def forward(ctx, u, dt, B_, C_, A, D):
        y, states = _launch_forward(u, dt, B_, C_, A, D, True)
        ctx.save_for_backward(u, dt, B_, C_, A, D, states)
        return y

    @staticmethod
    def backward(ctx, dy):
        *ins, states = ctx.saved_tensors
        return ssm_scan_bwd(*ins, dy, states)


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor
             ) -> torch.Tensor:
    """y of the selective scan from a zero state (see `ref.selective_scan`),
    in u's dtype."""
    _check(u, dt, B_, C_, A, D)
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, B_, C_, A, D)
    check_device("ssm_scan", u)
    _launch_checks(u, dt, B_, C_, A, D)
    if torch.is_grad_enabled() and any(
            a.requires_grad for a in (u, dt, B_, C_, A, D)):
        return SsmScanFn.apply(u, dt, B_, C_, A, D)
    return _launch_forward(u, dt, B_, C_, A, D)


def ssm_scan_with_states(u, dt, B_, C_, A, D):
    """(y, states) with no autograd: y as `ssm_scan` gives it and the
    states at the start of every 16 steps, (B, ceil(T / 16), d, 16)
    float32 (state slots past N zero), what `ssm_scan_bwd` reads. CUDA
    tensors launch K6 once; CPU tensors run the plain versions."""
    _check(u, dt, B_, C_, A, D)
    if u.device.type == "cpu":
        return (ssm_scan_ref(u, dt, B_, C_, A, D),
                ssm_scan_states_plain(u, dt, B_, C_, A, D, BWD_CHUNK,
                                      MAX_STATE))
    check_device("ssm_scan", u)
    _launch_checks(u, dt, B_, C_, A, D)
    return _launch_forward(u, dt, B_, C_, A, D, True)


def _launch_forward(u, dt, B_, C_, A, D, with_states: bool = False):
    """K6 on CUDA tensors: y, and with ``with_states`` (y, states)."""
    Bsz, T, d = u.shape
    N = A.shape[1]
    y = torch.empty_like(u)
    states = torch.empty(_states_shape(Bsz, T, d), dtype=torch.float32,
                         device=u.device) if with_states else None
    if u.device.type == "meta":         # the meta branch: no launch
        PF.launched("kernels.ssm_scan",
                    *cost(Bsz, T, d, N, u.element_size()), "ssm_scan")
        return (y, states) if with_states else y
    fn = _kernel(u.dtype)

    def launch():
        rc = fn(u.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                A.data_ptr(), D.data_ptr(), y.data_ptr(),
                None if states is None else states.data_ptr(), Bsz, T, d, N,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES["ssm_scan"] += 1

    if not PF.observed():
        launch()
    else:
        ops, nbytes = cost(Bsz, T, d, N, u.element_size())
        with PF.kernel("kernels.ssm_scan",
                         ("ssm_scan", (Bsz, T, d), N, str(u.dtype),
                          with_states),
                         device=u.device, args=(u, dt, B_, C_, A, D),
                         flops=ops, bytes_accessed=nbytes,
                         library="ssm_scan", b=Bsz, t=T, d=d, n=N) as call:
            launch()
            call.outputs = y
    return (y, states) if with_states else y


__all__ = ["SsmScanFn", "ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_plain",
           "ssm_scan_ref", "ssm_scan_states_plain", "ssm_scan_with_states"]
