"""Wrapper of kernel K4, the hand-written CUDA block-sparse matmul
(``csrc/block_sparse_matmul.cu``).

`block_sparse_matmul` launches the kernel for CUDA tensors (counted in
``repro_torch.kernels.LAUNCHES["block_sparse_matmul"]``) or raises; only for
CPU tensors does it run the plain version `block_sparse_matmul_ref`. The
kernel shares each 16-column strip's live k16 steps among the blocks of a
thread-block cluster, reads no weight of a dead tile and reduces the partial
sums in a fixed order inside the one launch; M need not be a block multiple
(the kernel masks its rows). bf16 takes its tensor-core body (``mma.sync``,
counted also in ``LAUNCHES["block_sparse_matmul_mma"]``), float32 its
CUDA-core body. Whether the weights and x are staged by 16-byte copies
follows from the tile and the alignment, never from a failure.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES, refuse_grad
from repro_torch.obs import prof as PF
from repro_torch.kernels.block_sparse_matmul.ref import \
    block_sparse_matmul_ref

_X = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MASK = {torch.bool: "b8", torch.int32: "i32"}
_FNS: Dict[Tuple[str, str], object] = {}


def _kernel(dtype: torch.dtype, mask_dtype: torch.dtype):
    key = (_X[dtype], _MASK[mask_dtype])
    if key not in _FNS:
        from repro_torch.kernels import build
        fn = getattr(build.load("block_sparse_matmul"),
                     "block_sparse_matmul_{}_{}".format(*key))
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


def _check(x: torch.Tensor, w: torch.Tensor, block_mask: torch.Tensor,
           block_k: int, block_n: int) -> None:
    if x.dim() != 2 or w.dim() != 2 or block_mask.dim() != 2:
        raise ValueError(f"block_sparse_matmul takes x (M, K), w (K, N), "
                         f"block_mask (K/bk, N/bn); got {tuple(x.shape)}, "
                         f"{tuple(w.shape)}, {tuple(block_mask.shape)}")
    K, N = w.shape
    if x.shape[1] != K:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}")
    if block_k < 1 or block_n < 1 or K % block_k or N % block_n:
        raise ValueError(f"w {tuple(w.shape)} is not a multiple of the "
                         f"block ({block_k}, {block_n})")
    if tuple(block_mask.shape) != (K // block_k, N // block_n):
        raise ValueError(f"block_mask {tuple(block_mask.shape)} is not "
                         f"{(K // block_k, N // block_n)} for w "
                         f"{tuple(w.shape)} in ({block_k}, {block_n}) tiles")
    if x.dtype not in _X or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or both bfloat16, got "
                        f"{x.dtype}, {w.dtype}")
    if block_mask.dtype not in _MASK:
        raise TypeError(f"block_mask must be bool or int32, got "
                        f"{block_mask.dtype}")
    if not (x.device == w.device == block_mask.device):
        raise ValueError("x, w and block_mask lie on different devices")


def cost(M: int, K: int, N: int, live: float, mask_bytes: int,
         x_bytes: int) -> Tuple[float, float]:
    """(operations, bytes) of the block-sparse product with a ``live``
    share of its weight tiles: 2MKN x live; x, the live weights and the
    mask read once, y written once. The counts behind the kernel's
    bound."""
    return 2 * M * K * N * live, (M * K * x_bytes + live * K * N * x_bytes
                                  + mask_bytes + M * N * x_bytes)


def block_sparse_matmul(x: torch.Tensor, w: torch.Tensor,
                        block_mask: torch.Tensor, *, block_m: int = 128,
                        block_n: int = 128,
                        block_k: int = 128) -> torch.Tensor:
    """y = x @ (w * expand(block_mask > 0)): x (M, K) and w (K, N) both
    float32 or both bf16, block_mask (K/block_k, N/block_n) bool or int32
    -> (M, N) in x's dtype, accumulated in float32. A dead tile contributes
    nothing, whatever its weights hold.

    ``block_k`` and ``block_n`` define the mask's tiles. ``block_m`` is the
    TPU kernel's row tiling, kept for the same signature; it has no effect
    on the result and the kernel does not read it."""
    del block_m
    _check(x, w, block_mask, block_k, block_n)
    if x.device.type == "cpu":
        return block_sparse_matmul_ref(x, w, block_mask, block_k=block_k,
                                       block_n=block_n)
    if x.device.type != "cuda":
        raise ValueError(f"block_sparse_matmul runs on CUDA or CPU, not "
                         f"{x.device}")
    refuse_grad("block_sparse_matmul", x, w, block_mask)
    if not (x.is_contiguous() and w.is_contiguous()
            and block_mask.is_contiguous()):
        raise ValueError("block_sparse_matmul's kernel takes contiguous "
                         "tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x lies on {x.device}, not the current device")
    M, K = x.shape
    N = w.shape[1]
    if max(M, K, N) >= 2 ** 31 or M > 8 * 65535:
        raise ValueError(f"block_sparse_matmul: shape {(M, K, N)} too large")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # 16-byte copies: each lies in one mask column when block_n is a
    # multiple of the values in 16 bytes
    per = 16 // w.element_size()
    w16 = block_n % per == 0 and N % per == 0 and w.data_ptr() % 16 == 0
    x16 = K % per == 0 and x.data_ptr() % 16 == 0
    fn = _kernel(x.dtype, block_mask.dtype)

    def launch():
        rc = fn(x.data_ptr(), w.data_ptr(), block_mask.data_ptr(),
                y.data_ptr(), M, K, N, block_k, block_n,
                int(w16) | int(x16) << 1,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"block_sparse_matmul kernel launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES["block_sparse_matmul"] += 1
        if x.dtype == torch.bfloat16:
            LAUNCHES["block_sparse_matmul_mma"] += 1

    if not PF.observed():
        launch()
        return y
    # the live share is this call's data (one host read, reported path only)
    live = float((block_mask > 0).float().mean())
    ops, nbytes = cost(M, K, N, live,
                       block_mask.numel() * block_mask.element_size(),
                       x.element_size())
    with PF.kernel("kernels.block_sparse_matmul",
                     ("block_sparse_matmul", (M, K), (K, N), block_k,
                      block_n, str(x.dtype)),
                     device=x.device, args=(x, w, block_mask), flops=ops,
                     bytes_accessed=nbytes, library="block_sparse_matmul",
                     m=M, k=K, n=N, live=round(live, 6)) as call:
        launch()
        call.outputs = y
    return y


__all__ = ["block_sparse_matmul", "block_sparse_matmul_ref"]
