"""Wrapper of kernel K2, the hand-written CUDA quantized matmul
(``csrc/quant_matmul.cu``).

`quant_matmul` launches the kernel for CUDA tensors (counted in
``repro_torch.kernels.LAUNCHES["quant_matmul"]``) or raises; only for CPU
tensors does it run the plain version `quant_matmul_ref`. Meta tensors,
under a `roofline.analysis.StepCounter`, take the meta branch: y empty,
the kernel's `cost` recorded, nothing launched (`kernels.check_device`).
The reference's padding to (128, 128, 128) blocks is gone: the kernel
masks its ragged edges.

The kernel file has a decode body and a large-M body; `body_for`, a pure
function of the shape, x's type, the payload's kind and the alignment,
names the one a call takes, never a failure. The decode body splits K
over a thread-block cluster and reduces the partial sums in a fixed order
inside the one launch: bf16 x on its tensor-core path (``mma.sync``,
counted also in ``LAUNCHES["quant_matmul_mma"]``), float32 x on the CUDA
cores; whether the weights and x are staged by 16-byte copies follows from
their alignment. The large-M body (``wgmma``, counted also in
``LAUNCHES["quant_matmul_wgmma"]``) takes bf16 x from `wgmma_min_m` rows
on where TMA can read both operands (`tma_readable`): a block computes 128
output columns by 128 or 160 rows of x (`wgmma_rows`) over the whole of
K, so its sums have one order too. Both apply the scale once per output
column after the k-sum.

The payload's type says how it is stored: int8 (K, N) is 8-bit storage;
uint8 (K, ceil(N / 2)) holds two 4-bit values a byte (`ref.pack_int4`'s
layout, N being ``scales``'s length) and takes the packed-int4 bodies of
the same kernel file, which read half a byte a weight and unpack in
registers (counted also in ``LAUNCHES["quant_matmul_int4"]``, and bf16 x
in the count of the body it took). Any other type or shape raises.
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

# The large-M body from this many rows of bf16 x on, by payload: the
# smallest M of chip_smoke's phase 42 sweep (16 to 1024 rows at
# qwen3-0.6b's (K, N) = (1024, 3072) and the vision cross projection's
# (4096, 1024)) from which it was no slower than the decode body at both
# shapes on the H100 (PERF.md §6).
WGMMA_MIN_M = {"int8": 256, "int4": 512}
# a block of the large-M body (``wide::`` in the kernel file): 128 output
# columns by WGMMA_ROWS rows of x, 64 k a stage, 6 stages, within a
# block's 232448 bytes of shared memory
WGMMA_COLS, WGMMA_ROWS, WGMMA_BK, WGMMA_STAGES = 128, (128, 160), 64, 6
SMEM_PER_BLOCK = 232448
# SMs of the card the rounds of blocks are reckoned for (an H100 SXM's)
_SMS = 132
# a block's time a row of x, against a block of 128 rows: one of 160 rows
# spreads its A fragments' conversion and its fixed costs over more rows
# (chip_smoke's phase 42 measures the ratio where rounds hardly matter,
# at 16384 rows: 0.93 to 0.95 on the H100)
ROW_COST = {128: 1.0, 160: 0.94}


def _kernel(name: str):
    """The C function ``quant_matmul_<name>``: the decode body's
    ``{,int4_}{bf16,f32}`` (M, K, N, flags) or the large-M body's
    ``wide_{,int4_}bf16`` (M, K, N, rows)."""
    if name not in _FNS:
        from repro_torch.kernels import build
        fn = getattr(build.load("quant_matmul"), f"quant_matmul_{name}")
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def tma_readable(K: int, N: int, packed: bool, aligned: bool) -> bool:
    """Whether TMA can read x (bf16 rows of K) and the payload (rows of N
    bytes, or ceil(N/2) packed): every row a multiple of 16 bytes and
    ``aligned``, both base pointers 16-byte aligned."""
    row = packed_width(N) if packed else N
    return aligned and K > 0 and (2 * K) % 16 == 0 and row % 16 == 0


def wgmma_min_m(packed: bool) -> int:
    """The first M of bf16 x the large-M body takes, for an int8 or a
    packed 4-bit payload."""
    return WGMMA_MIN_M["int4" if packed else "int8"]


def body_for(M: int, K: int, N: int, dtype: torch.dtype, packed: bool,
             aligned: bool) -> str:
    """The body a call takes: "wgmma" (the large-M body) for bf16 x of at
    least `wgmma_min_m` rows that TMA can read, else the decode body:
    "mma" for bf16 x, "cuda-core" for float32 x."""
    if dtype != torch.bfloat16:
        return "cuda-core"
    if M >= wgmma_min_m(packed) and tma_readable(K, N, packed, aligned):
        return "wgmma"
    return "mma"


def wgmma_rows(M: int, N: int) -> int:
    """Rows of x a block of the large-M body (one of ``WGMMA_ROWS``): the
    one whose blocks end soonest, reckoned as the rounds of ``_SMS``
    blocks times a block's time (its rows times ``ROW_COST``), the fewer
    rows on a tie. At the vision cross projection (M 12808, N 1024) 160
    rows make 760 blocks, 6 rounds, where 128 make 808, 7 rounds with 16
    blocks in the last."""
    def cost(rows):
        blocks = -(-N // WGMMA_COLS) * -(-M // rows)
        return -(-blocks // _SMS) * rows * ROW_COST[rows]
    return min(WGMMA_ROWS, key=cost)


def wgmma_smem_bytes(packed: bool, rows: int) -> int:
    """A block's shared memory in the large-M body (``wide::Ring::kSmem``):
    the ring of x tiles (``rows`` rows of 128 bytes) and payload tiles (64
    k rows of the block's 128 columns: 128 bytes int8, 64 packed), its two
    barriers a stage, and 1024 bytes to align the base."""
    row = WGMMA_COLS // (2 if packed else 1)
    stage = rows * 2 * WGMMA_BK + WGMMA_BK * row
    return WGMMA_STAGES * stage + 16 * WGMMA_STAGES + 1024


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
    body = body_for(M, K, N, x.dtype, packed,
                    x.data_ptr() % 16 == 0 and w_q.data_ptr() % 16 == 0)
    if body == "wgmma":
        fn = _kernel("wide_" + ("int4_" if packed else "") + "bf16")
        shape = (M, K, N, wgmma_rows(M, N))
    else:
        fn = _kernel(("int4_" if packed else "") + _SUFFIX[x.dtype])
        shape = (M, K, N, _flags(x, w_q))

    def launch():
        rc = fn(x.data_ptr(), w_q.data_ptr(), scales.data_ptr(),
                y.data_ptr(), *shape,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"quant_matmul kernel launch failed ({body} "
                               f"body): CUDA error {rc}")
        LAUNCHES["quant_matmul"] += 1
        if body != "cuda-core":
            LAUNCHES[f"quant_matmul_{body}"] += 1
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


__all__ = ["quant_matmul", "quant_matmul_ref", "body_for", "wgmma_min_m",
           "tma_readable", "WGMMA_MIN_M"]
