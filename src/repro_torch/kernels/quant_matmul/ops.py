"""Wrapper of kernel K2, the hand-written CUDA quantized matmul
(``csrc/quant_matmul.cu``).

`quant_matmul` launches the kernel for CUDA tensors (counted in
``repro_torch.kernels.LAUNCHES["quant_matmul"]``) or raises; only for CPU
tensors does it run the plain version `quant_matmul_ref`. Meta tensors,
under a `roofline.analysis.StepCounter`, take the meta branch: y empty,
the kernel's `cost` recorded, nothing launched (`kernels.check_device`).
The reference's padding to (128, 128, 128) blocks is gone: the kernel
masks its ragged edges.

The kernel splits K over a thread-block cluster and reduces the partial
sums in a fixed order inside the one launch. bf16 x takes its tensor-core
body (``mma.sync``, counted also in ``LAUNCHES["quant_matmul_mma"]``),
float32 x its CUDA-core body; both apply the scale once per output column
after the k-sum. Whether the weights and x are staged by 16-byte copies
follows from their alignment, never from a failure.

The payload's type says how it is stored: int8 (K, N) is 8-bit storage;
uint8 (K, ceil(N / 2)) holds two 4-bit values a byte (`ref.pack_int4`'s
layout, N being ``scales``'s length) and takes the packed-int4 bodies of
the same kernel file, which read half a byte a weight and unpack in
registers (counted also in ``LAUNCHES["quant_matmul_int4"]``, and bf16 x
in ``"quant_matmul_mma"`` too). Any other type or shape raises.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES, check_device, refuse_grad
from repro_torch.obs import prof as PF
from repro_torch.kernels.quant_matmul.ref import (is_packed, packed_width,
                                                  quant_matmul_ref)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_FNS: Dict[str, object] = {}


def _kernel(dtype: torch.dtype, packed: bool):
    name = ("int4_" if packed else "") + _SUFFIX[dtype]
    if name not in _FNS:
        from repro_torch.kernels import build
        fn = getattr(build.load("quant_matmul"), f"quant_matmul_{name}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _check(x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor) -> bool:
    """Raise on inputs the kernel does not take; True for a packed 4-bit
    payload, False for an int8 one."""
    if x.dim() != 2 or w_q.dim() != 2 or scales.dim() != 1:
        raise ValueError(f"quant_matmul takes x (M, K), w_q (K, N) or "
                         f"(K, ceil(N/2)), scales (N,); got "
                         f"{tuple(x.shape)}, {tuple(w_q.shape)}, "
                         f"{tuple(scales.shape)}")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if w_q.dtype not in (torch.int8, torch.uint8) or \
            scales.dtype != torch.float32:
        raise TypeError(f"w_q must be int8 (8-bit) or uint8 (packed 4-bit) "
                        f"and scales float32, got {w_q.dtype}, "
                        f"{scales.dtype}")
    packed = is_packed(w_q)
    N = scales.shape[0]
    if x.shape[1] != w_q.shape[0] or w_q.shape[1] != (
            packed_width(N) if packed else N):
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w_q "
                         f"{tuple(w_q.shape)} {w_q.dtype}, scales "
                         f"{tuple(scales.shape)} (a packed w_q of N "
                         f"columns has ceil(N/2) bytes a row)")
    if not (x.device == w_q.device == scales.device):
        raise ValueError("x, w_q and scales lie on different devices")
    return packed


def cost(M: int, K: int, N: int, x_bytes: int,
         packed: bool = False) -> Tuple[int, int]:
    """(operations, bytes) of y = x @ dequant(w_q, scales): 2MKN; x, the
    weight payload (int8, or packed 4-bit at ceil(N/2) bytes a row) and
    the scales read once, y written once. The counts behind the kernel's
    bound."""
    w_bytes = K * (packed_width(N) if packed else N)
    return 2 * M * K * N, M * K * x_bytes + w_bytes + N * 4 + \
        M * N * x_bytes


def _flags(x: torch.Tensor, w_q: torch.Tensor) -> int:
    """Bit 0: the weights' rows of a strip are 16-byte copies (the payload
    row's bytes, N or ceil(N/2), a multiple of 16, w_q 16-byte aligned);
    bit 1: x's rows are staged by 16-byte copies (K a multiple of the
    values in 16 bytes, x aligned)."""
    w16 = w_q.shape[1] % 16 == 0 and w_q.data_ptr() % 16 == 0
    x16 = (x.shape[1] % (16 // x.element_size()) == 0
           and x.data_ptr() % 16 == 0)
    return int(w16) | int(x16) << 1


def quant_matmul(x: torch.Tensor, w_q: torch.Tensor,
                 scales: torch.Tensor) -> torch.Tensor:
    """y = x @ (w_q * scales[None, :]): x (M, K) float32/bf16, w_q (K, N)
    int8 on a ``bits`` grid or (K, ceil(N/2)) uint8 packed 4-bit, scales
    (N,) float32 -> (M, N) in x's dtype."""
    packed = _check(x, w_q, scales)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w_q, scales)
    check_device("quant_matmul", x)
    refuse_grad("quant_matmul", x, w_q, scales)
    if not (x.is_contiguous() and w_q.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("quant_matmul's kernel takes contiguous tensors")
    if x.device.type == "cuda" and \
            x.device.index != torch.cuda.current_device():
        raise ValueError(f"x lies on {x.device}, not the current device")
    M, K = x.shape
    N = scales.shape[0]
    if max(M, K, N) >= 2 ** 31 or M > 8 * 65535:
        raise ValueError(f"quant_matmul: shape {(M, K, N)} too large")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    ops, nbytes = cost(M, K, N, x.element_size(), packed)
    if x.device.type == "meta":         # the meta branch: no launch
        PF.launched("kernels.quant_matmul", ops, nbytes, "quant_matmul")
        return y
    fn = _kernel(x.dtype, packed)

    def launch():
        rc = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                y.data_ptr(), M, K, N, _flags(x, w_q),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quant_matmul kernel launch failed: CUDA "
                               f"error {rc}")
        LAUNCHES["quant_matmul"] += 1
        if x.dtype == torch.bfloat16:
            LAUNCHES["quant_matmul_mma"] += 1
        if packed:
            LAUNCHES["quant_matmul_int4"] += 1

    if not PF.observed():
        launch()
        return y
    with PF.kernel("kernels.quant_matmul",
                     ("quant_matmul", (M, K), (K, N), str(x.dtype))
                     + (("int4",) if packed else ()),
                     device=x.device, args=(x, w_q, scales), flops=ops,
                     bytes_accessed=nbytes, library="quant_matmul",
                     m=M, k=K, n=N) as call:
        launch()
        call.outputs = y
    return y


__all__ = ["quant_matmul", "quant_matmul_ref"]
