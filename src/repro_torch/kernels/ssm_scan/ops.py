"""Wrapper of kernel K6, the hand-written CUDA selective scan
(``csrc/ssm_scan.cu``).

`ssm_scan` takes the model's layout and mixed types, as the TPU kernel's
call does: u (B, T, d) with B_, C_ (B, T, N) in one type (float32 or
bf16), and dt (B, T, d), A (d, N), D (d,) in float32; it returns y
(B, T, d) in u's type. For CUDA tensors it launches the kernel (counted in
``repro_torch.kernels.LAUNCHES["ssm_scan"]``) or raises; the kernel masks
ragged T and d itself, so nothing is padded or copied. Only for CPU tensors
does it run the plain version `ssm_scan_ref`.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES
from repro_torch.obs import prof as PF
from repro_torch.obs import trace as TR
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
MAX_STATE = 16          # the state values a channel holds in registers
_FNS: Dict[str, object] = {}


def _kernel(dtype: torch.dtype):
    name = _SUFFIX[dtype]
    if name not in _FNS:
        from repro_torch.kernels import build
        fn = getattr(build.load("ssm_scan"), f"ssm_scan_{name}")
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + \
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


def ssm_scan(u: torch.Tensor, dt: torch.Tensor, B_: torch.Tensor,
             C_: torch.Tensor, A: torch.Tensor, D: torch.Tensor
             ) -> torch.Tensor:
    """y of the selective scan from a zero state (see `ref.selective_scan`),
    in u's dtype."""
    _check(u, dt, B_, C_, A, D)
    if u.device.type == "cpu":
        return ssm_scan_ref(u, dt, B_, C_, A, D)
    if u.device.type != "cuda":
        raise ValueError(f"ssm_scan runs on CUDA or CPU, not {u.device}")
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
    if u.device.index != torch.cuda.current_device():
        raise ValueError(f"u lies on {u.device}, not the current device")
    y = torch.empty_like(u)
    fn = _kernel(u.dtype)

    def launch():
        rc = fn(u.data_ptr(), dt.data_ptr(), B_.data_ptr(), C_.data_ptr(),
                A.data_ptr(), D.data_ptr(), y.data_ptr(), Bsz, T, d, N,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"ssm_scan kernel launch failed: CUDA error "
                               f"{rc}")
        LAUNCHES["ssm_scan"] += 1

    if not TR.active():
        launch()
        return y
    ops, nbytes = cost(Bsz, T, d, N, u.element_size())
    with PF.dispatch("kernels.ssm_scan",
                     ("ssm_scan", (Bsz, T, d), N, str(u.dtype)),
                     device=u.device, args=(u, dt, B_, C_, A, D), flops=ops,
                     bytes_accessed=nbytes, library="ssm_scan",
                     b=Bsz, t=T, d=d, n=N) as call:
        launch()
        call.outputs = y
    return y


__all__ = ["ssm_scan", "ssm_scan_ref"]
