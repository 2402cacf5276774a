"""Wrapper of kernel K3, the hand-written CUDA clustered matmul
(``csrc/clustered_matmul.cu``).

`clustered_matmul` launches the kernel for CUDA tensors (counted in
``repro_torch.kernels.LAUNCHES["clustered_matmul"]``) or raises; only for
CPU tensors does it run the plain version `clustered_matmul_ref`. The
reference's padding to (128, 128, 128) blocks is gone: the kernel masks its
ragged edges. The kernel splits K over a thread-block cluster and reduces
the partial sums in a fixed order inside the one launch. The indices are read as stored, int8 or int32; the reference
widens them to int32 first.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import LAUNCHES, refuse_grad
from repro_torch.obs import prof as PF
from repro_torch.kernels.clustered_matmul.ref import clustered_matmul_ref

_X = {torch.float32: "f32", torch.bfloat16: "bf16"}
_IDX = {torch.int8: "i8", torch.int32: "i32"}
# the most codebook entries a row may have: the kernel stages at least two
# codebook rows at a time in shared memory
MAX_CLUSTERS = 4096
_FNS: Dict[Tuple[str, str], object] = {}


def _kernel(x_dtype: torch.dtype, idx_dtype: torch.dtype):
    key = (_X[x_dtype], _IDX[idx_dtype])
    if key not in _FNS:
        from repro_torch.kernels import build
        fn = getattr(build.load("clustered_matmul"),
                     "clustered_matmul_{}_{}".format(*key))
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[key] = fn
    return _FNS[key]


def _check(x: torch.Tensor, idx: torch.Tensor,
           codebook: torch.Tensor) -> None:
    if x.dim() != 2 or idx.dim() != 2 or codebook.dim() != 2:
        raise ValueError(f"clustered_matmul takes x (M, K), idx (K, N), "
                         f"codebook (K, C); got {tuple(x.shape)}, "
                         f"{tuple(idx.shape)}, {tuple(codebook.shape)}")
    if x.shape[1] != idx.shape[0] or codebook.shape[0] != idx.shape[0]:
        raise ValueError(f"shape mismatch: x {tuple(x.shape)}, idx "
                         f"{tuple(idx.shape)}, codebook "
                         f"{tuple(codebook.shape)}")
    if not 1 <= codebook.shape[1] <= MAX_CLUSTERS:
        raise ValueError(f"clustered_matmul takes 1 to {MAX_CLUSTERS} "
                         f"codebook entries a row, got {codebook.shape[1]}")
    if x.dtype not in _X:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if idx.dtype not in _IDX or codebook.dtype != torch.float32:
        raise TypeError(f"idx must be int8 or int32 and codebook float32, "
                        f"got {idx.dtype}, {codebook.dtype}")
    if not (x.device == idx.device == codebook.device):
        raise ValueError("x, idx and codebook lie on different devices")


def cost(M: int, K: int, N: int, C: int, x_bytes: int,
         idx_bytes: int = 1) -> Tuple[int, int]:
    """(operations, bytes) of y = x @ W, W gathered from per-row
    codebooks: 2MKN; x, the indices and the codebooks read once, y written
    once. The counts behind the kernel's bound."""
    return 2 * M * K * N, (M * K * x_bytes + K * N * idx_bytes + K * C * 4
                           + M * N * x_bytes)


def clustered_matmul(x: torch.Tensor, idx: torch.Tensor,
                     codebook: torch.Tensor) -> torch.Tensor:
    """y = x @ W, W[k, n] = codebook[k, idx[k, n]]: x (M, K) float32/bf16,
    idx (K, N) int8/int32, codebook (K, C) float32 -> (M, N) in x's dtype,
    accumulated in float32.

    An index outside [0, C) gives weight 0 in the kernel and in the plain
    version alike, as in the Pallas kernel; nothing is checked on the host
    (that would need a sync)."""
    _check(x, idx, codebook)
    if x.device.type == "cpu":
        return clustered_matmul_ref(x, idx, codebook)
    if x.device.type != "cuda":
        raise ValueError(f"clustered_matmul runs on CUDA or CPU, not "
                         f"{x.device}")
    refuse_grad("clustered_matmul", x, idx, codebook)
    if not (x.is_contiguous() and idx.is_contiguous()
            and codebook.is_contiguous()):
        raise ValueError("clustered_matmul's kernel takes contiguous tensors")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"x lies on {x.device}, not the current device")
    M, K = x.shape
    N, C = idx.shape[1], codebook.shape[1]
    if max(M, K, N) >= 2 ** 31 or M > 8 * 65535:
        raise ValueError(f"clustered_matmul: shape {(M, K, N)} too large")
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    # 16 bytes of neighbouring indices in one load (16 int8 or 4 int32)
    vec = int(N % (16 // idx.element_size()) == 0
              and idx.data_ptr() % 16 == 0)
    fn = _kernel(x.dtype, idx.dtype)

    def launch():
        rc = fn(x.data_ptr(), idx.data_ptr(), codebook.data_ptr(),
                y.data_ptr(), M, K, N, C, vec,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"clustered_matmul kernel launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES["clustered_matmul"] += 1

    if not PF.observed():
        launch()
        return y
    ops, nbytes = cost(M, K, N, C, x.element_size(), idx.element_size())
    with PF.kernel("kernels.clustered_matmul",
                     ("clustered_matmul", (M, K), (K, N), C, str(x.dtype),
                      str(idx.dtype)),
                     device=x.device, args=(x, idx, codebook), flops=ops,
                     bytes_accessed=nbytes, library="clustered_matmul",
                     m=M, k=K, n=N) as call:
        launch()
        call.outputs = y
    return y


__all__ = ["clustered_matmul", "clustered_matmul_ref"]
