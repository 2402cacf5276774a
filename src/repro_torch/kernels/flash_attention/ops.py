"""Wrapper of kernel K5, the hand-written CUDA flash attention
(``csrc/flash_attention.cu``).

`flash_attention` takes the model's layout, q (B, T, H, hd) and k/v
(B, S, KV, hd) with H % KV == 0, and returns (B, T, H, hd). For CUDA tensors
it launches the kernel (counted in
``repro_torch.kernels.LAUNCHES["flash_attention"]``) or raises; the kernel
reads KV head h // (H // KV) by strides, so nothing is transposed, padded or
broadcast. Only for CPU tensors does it run the plain version
`flash_attention_plain`, which folds the heads as the reference's ops.py
does and calls `flash_attention_ref`.

The kernel has two bodies (see the note in the source). bf16 inputs at
head_dim 64, 128, 192 or 256 whose tensors TMA can read (`takes_wgmma`) go
through the wgmma body, counted also in ``LAUNCHES["flash_attention_wgmma"]``;
it rounds P to bf16 before P @ v, which `flash_attention_tolerance` covers
for bf16. Everything else goes through the CUDA-core body. The choice
follows from the inputs alone, never from a failure.

On CUDA, when grad mode is on and an input requires grad,
`flash_attention` goes through `FlashAttentionFn`: its forward launches K5
with the log-sum-exp output (B, H, T), and its backward is the hand-written
kernel ``csrc/flash_attention_bwd.cu`` (`flash_attention_bwd`, counted in
``LAUNCHES["flash_attention_bwd"]``; bf16 at head_dim 64, 128, 192 or 256
that TMA can read, `takes_wgmma_bwd`, takes its wgmma body, counted also in
``LAUNCHES["flash_attention_bwd_wgmma"]``: one warpgroup a block at 64 and
128, two at 192 and 256, where `bwd_head_split` says how many blocks share
a key tile's query heads), so the output always carries a
``grad_fn`` there. Otherwise K5 launches without lse, as the serve and
prefill paths do. On the CPU the plain version's own autograd gives the
gradient. Meta tensors, while a watcher counts the launches (a
`roofline.analysis.StepCounter`, `obs.prof.watch`), take the
same route with no launch (the meta branch): empty outputs of the
kernels' shapes, each launch's analytic `cost` or `bwd_cost` recorded
(`kernels.check_device`); the plain version, which builds the score
matrix the kernel never builds, is not run.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import LAUNCHES, check_device
from repro_torch.obs import prof as PF
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_plain, flash_attention_lse_plain,
    flash_attention_ref, flash_attention_tolerance)

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
HEAD_DIMS = (16, 32, 64, 128, 192, 256)
WGMMA_HEAD_DIMS = (64, 128, 192, 256)
WGMMA_BWD_HEAD_DIMS = (64, 128, 192, 256)
BWD_ROWS = 64           # rows of a tile of the backward's wgmma body
_FNS: Dict[str, object] = {}


def _kernel(name: str):
    if name not in _FNS:
        from repro_torch.kernels import build
        bwd = name.startswith("bwd")
        lib = "flash_attention_bwd" if bwd else "flash_attention"
        fn = getattr(build.load(lib), f"flash_attention_{name}")
        fn.argtypes = [ctypes.c_void_p] * (10 if bwd else 5) + \
            [ctypes.c_int] * 6 + \
            [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float] + \
            ([ctypes.c_int, ctypes.c_void_p] if bwd else []) + \
            [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """The plain version in the model's layout: (B, T, H, hd) queries,
    (B, S, KV, hd) keys and values -> (B, T, H, hd)."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV

    def fold_kv(a):
        return a.permute(0, 2, 1, 3)[:, :, None].expand(
            B, KV, G, S, a.shape[-1]).reshape(B * H, S, a.shape[-1])

    o = flash_attention_ref(q.permute(0, 2, 1, 3).reshape(B * H, T, hd),
                            fold_kv(k), fold_kv(v), causal=causal,
                            window=window, softcap=softcap)
    return o.reshape(B, H, T, -1).permute(0, 2, 1, 3)


def takes_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the wgmma body serves these inputs: bf16, head_dim 64, 128,
    192 or 256, and what TMA needs of each tensor, every (b, t, head) stride a
    multiple of 16 bytes (the stride of an extent-1 dimension is never
    used) and a 16-byte aligned start."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_HEAD_DIMS
            and _tma_readable(q, k, v))


def takes_wgmma_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: torch.Tensor, do: torch.Tensor) -> bool:
    """Whether the backward's wgmma body serves these tensors: bf16,
    head_dim 64, 128 (one warpgroup a block), 192 or 256 (two warpgroups
    a block, which split dK and dV's accumulators between them), and
    `takes_wgmma`'s TMA terms for each of q, k, v, o and do. Everything
    else (float32, head_dim 16 and 32, other strides) takes the CUDA-core
    body."""
    return (q.dtype == torch.bfloat16 and q.shape[-1] in WGMMA_BWD_HEAD_DIMS
            and _tma_readable(q, k, v, o, do))


def bwd_head_split(S: int, B: int, H: int, KV: int, sms: int) -> int:
    """How many blocks of the two-warpgroup dk/dv kernel (head_dim 192 and
    256) share one (KV tile, b, KV head): 1 where the n_kt B KV blocks fill
    ``sms`` SMs; else enough to fill them, at most the group's G = H / KV
    query heads. Block j of n takes heads [j G // n, (j + 1) G // n) of the
    group and writes float32 partials, which the kernel sums in j's
    order."""
    base = -(-S // BWD_ROWS) * B * KV
    if base >= sms:
        return 1
    return max(1, min(H // KV, -(-sms // base)))


def bwd_smem_bytes(hd: int) -> Tuple[int, int]:
    """Shared memory a block of the backward's wgmma body asks for at
    ``hd`` (``csrc/flash_attention_bwd.cu``), (dk/dv kernel, dq kernel):
    the tiles that stay and kStages = 2 x the streamed ones, each hd / 64
    boxes of 64 rows x 128 bytes, the dk/dv kernel's 2 x 64 lse and D
    values a stage, 3 mbarriers, 1024 bytes of alignment slack; at 192
    and 256 the two warpgroups' exchange besides (P and the softcap's
    factor, 16 KB each)."""
    box, stages, nb = BWD_ROWS * 128, 2, hd // 64
    tiles = nb * (2 + 2 * stages) * box + 64 + 1024
    rows = stages * 2 * BWD_ROWS * 4
    if hd in (64, 128):
        return tiles + rows, tiles + rows
    xchg = 2 * 32 * 128 * 4
    return tiles + rows + xchg, tiles + xchg


def _tma_readable(*tensors: torch.Tensor) -> bool:
    return all(a.data_ptr() % 16 == 0
               and all(s % 8 == 0 for s, n in zip(a.stride()[:3],
                                                  a.shape[:3]) if n > 1)
               for a in tensors)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, T, H, hd) and k, v "
                         f"(B, S, KV, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, hd = q.shape
    if k.shape[0] != B or k.shape[3] != hd or k.shape[2] == 0 \
            or H % k.shape[2] != 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "form grouped-query attention")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _SUFFIX:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v lie on different devices")


def visible_pairs(T: int, S: int, *, causal: bool = True,
                  window: int = 0) -> int:
    """The (query t, key s) pairs one head attends: s < S, s <= t when
    causal, s > t - window when ``window`` > 0."""
    t = np.arange(T, dtype=np.int64)
    hi = np.minimum(t, S - 1) if causal else np.full(T, S - 1, np.int64)
    lo = np.maximum(t - window + 1, 0) if window > 0 else np.zeros(T,
                                                                   np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def cost(B: int, T: int, S: int, H: int, KV: int, hd: int, elem: int, *,
         causal: bool = True, window: int = 0) -> Tuple[int, int]:
    """(flops, bytes) of one attention call: q k^T and P v, 4 hd flops a
    visible pair a head; q and o (B, T, H, hd), k and v (B, S, KV, hd)
    moved once at ``elem`` bytes a value. The counts behind the kernel's
    bound."""
    flops = 4 * hd * B * H * visible_pairs(T, S, causal=causal,
                                           window=window)
    return flops, elem * (2 * B * T * H * hd + 2 * B * S * KV * hd)


def bwd_cost(B: int, T: int, S: int, H: int, KV: int, hd: int, elem: int,
             *, causal: bool = True, window: int = 0,
             vd: Optional[int] = None) -> Tuple[int, int]:
    """(flops, bytes) of one backward call: the five products S = q k^T,
    dP = do v^T, dv = P^T do, dk = dS^T q and dq = dS k, 2 (3 hd + 2 vd)
    flops a visible pair a head; q, dq (B, T, H, hd), o, do (B, T, H, vd),
    k, dk (B, S, KV, hd) and v, dv (B, S, KV, vd) moved once at ``elem``
    bytes a value, lse read as float32. ``vd``: v's own head_dim (hd when
    None), for a caller that pads v with zeros to hd (MLA). The counts
    behind the backward's bound."""
    vd = hd if vd is None else vd
    flops = 2 * (3 * hd + 2 * vd) * B * H * visible_pairs(
        T, S, causal=causal, window=window)
    return flops, (elem * 2 * (hd + vd) * (B * T * H + B * S * KV)
                   + 4 * B * H * T)


def _launch_checks(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> None:
    B, T, H, hd = q.shape
    S = k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention's kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {hd}")
    if any(a.stride(-1) != 1 for a in (q, k, v)):
        raise ValueError("flash_attention's kernel needs unit stride along "
                         "head_dim")
    if B * H > 65535 or max(T, S) >= 2 ** 31 or S == 0:
        raise ValueError(f"flash_attention: shape B={B}, T={T}, S={S}, "
                         f"H={H} out of the kernel's range")
    if q.device.type == "cuda" and \
            q.device.index != torch.cuda.current_device():
        raise ValueError(f"q lies on {q.device}, not the current device")


def _launch_forward(q, k, v, causal, window, softcap, with_lse: bool):
    """K5 on CUDA tensors: o, and lse (B, H, T) float32 when
    ``with_lse`` (else None). On meta tensors (the meta branch) the same
    outputs, empty, and nothing launched."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    o = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device) \
        if with_lse else None
    if q.device.type == "meta":          # the meta branch: no launch
        PF.launched("kernels.flash_attention", *cost(
            B, T, S, H, KV, hd, q.element_size(), causal=causal,
            window=window), "flash_attention")
        return o, lse
    strides = (ctypes.c_int64 * 12)(*(s for a in (q, k, v, o)
                                      for s in a.stride()[:3]))
    wgmma = takes_wgmma(q, k, v)
    name = "bf16_wgmma" if wgmma else _SUFFIX[q.dtype]
    fn = _kernel(name)

    def launch():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                None if lse is None else lse.data_ptr(),
                B, T, S, H, KV, hd, strides, int(causal), int(window),
                float(softcap), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention kernel launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES["flash_attention"] += 1
        if wgmma:
            LAUNCHES["flash_attention_wgmma"] += 1

    if not PF.observed():
        launch()
        return o, lse
    flops, nbytes = cost(B, T, S, H, KV, hd, q.element_size(),
                         causal=causal, window=window)
    with PF.kernel("kernels.flash_attention",
                     ("flash_attention", (B, T, S, H, KV, hd), str(q.dtype),
                      bool(causal), int(window), name),
                     device=q.device, args=(q, k, v), flops=flops,
                     bytes_accessed=nbytes, library="flash_attention",
                     b=B, t=T, s=S, h=H) as call:
        launch()
        call.outputs = o
    return o, lse


def flash_attention_bwd(q, k, v, o, do, lse, *, causal: bool = True,
                        window: int = 0, softcap: float = 0.0):
    """(dq, dk, dv) of `flash_attention`'s o for the gradient ``do``,
    from the forward's o and lse (B, H, T), in the inputs' dtype: dq
    (B, T, H, hd), dk and dv (B, S, KV, hd), contiguous. CUDA tensors launch
    the backward kernel (counted in ``LAUNCHES["flash_attention_bwd"]``) or
    raise, reading q, k, v, o and do by strides; those `takes_wgmma_bwd`
    accepts go through its wgmma body, counted also in
    ``LAUNCHES["flash_attention_bwd_wgmma"]``. CPU tensors run the plain
    version `flash_attention_bwd_plain`; meta tensors, under a
    `roofline.analysis.StepCounter`, the meta branch."""
    _check(q, k, v)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (B, H, T) or lse.dtype != torch.float32 or \
            o.dtype != q.dtype or do.dtype != q.dtype or \
            not (o.device == do.device == lse.device == q.device):
        raise ValueError(f"o and do must match q {tuple(q.shape)} "
                         f"{q.dtype} on {q.device}, lse be (B, H, T) "
                         f"float32 there; got {tuple(o.shape)} {o.dtype}, "
                         f"{tuple(do.shape)} {do.dtype}, {tuple(lse.shape)} "
                         f"{lse.dtype}")
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal,
                                         window=window, softcap=softcap)
    check_device("flash_attention", q)
    _launch_checks(q, k, v)
    # autograd may hand over a gradient with any strides
    o, do, lse = (a if a.stride(-1) == 1 else a.contiguous()
                  for a in (o, do, lse.contiguous()))
    dq = torch.empty((B, T, H, hd), dtype=q.dtype, device=q.device)
    dk = torch.empty((B, S, KV, hd), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    wgmma = takes_wgmma_bwd(q, k, v, o, do)
    # the wgmma body's scratch: D and lse log2 e, padded to whole tiles
    delta = torch.empty((2, B, H, -(-T // BWD_ROWS) * BWD_ROWS) if wgmma
                        else (B, H, T), dtype=torch.float32,
                        device=q.device)
    if q.device.type == "meta":          # the meta branch: no launch
        PF.launched("kernels.flash_attention_bwd", *bwd_cost(
            B, T, S, H, KV, hd, q.element_size(), causal=causal,
            window=window), "flash_attention_bwd")
        return dq, dk, dv
    strides = (ctypes.c_int64 * 15)(*(s for a in (q, k, v, o, do)
                                      for s in a.stride()[:3]))
    name = "bwd_bf16_wgmma" if wgmma else "bwd_" + _SUFFIX[q.dtype]
    fn = _kernel(name)
    split, part = 1, None
    if wgmma and hd in (192, 256):
        split = bwd_head_split(S, B, H, KV, torch.cuda.get_device_properties(
            q.device).multi_processor_count)
        if split > 1:     # the split's float32 partial dv and dk
            part = torch.empty((2, split, B, S, KV, hd), dtype=torch.float32,
                               device=q.device)

    def launch():
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                B, T, S, H, KV, hd, strides, int(causal), int(window),
                float(softcap), split,
                None if part is None else part.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                               f"CUDA error {rc}")
        LAUNCHES["flash_attention_bwd"] += 1
        if wgmma:
            LAUNCHES["flash_attention_bwd_wgmma"] += 1

    if not PF.observed():
        launch()
        return dq, dk, dv
    flops, nbytes = bwd_cost(B, T, S, H, KV, hd, q.element_size(),
                             causal=causal, window=window)
    with PF.kernel("kernels.flash_attention_bwd",
                     ("flash_attention_bwd", (B, T, S, H, KV, hd),
                      str(q.dtype), bool(causal), int(window), name),
                     device=q.device, args=(q, k, v, o, do, lse),
                     flops=flops, bytes_accessed=nbytes,
                     library="flash_attention_bwd", b=B, t=T, s=S,
                     h=H) as call:
        launch()
        call.outputs = (dq, dk, dv)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """K5's forward with its log-sum-exp, K5's backward kernel as its
    gradient (CUDA only)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap):
        o, lse = _launch_forward(q, k, v, causal, window, softcap, True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = (causal, window, softcap)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, causal=causal,
                                         window=window, softcap=softcap)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    softcap: float = 0.0) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v per head, with KV head h // (H // KV);
    query t sees key s when s <= t (causal) and s > t - window (window > 0).
    Keys beyond S are never seen, causal or not."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     softcap=softcap)
    check_device("flash_attention", q)
    _launch_checks(q, k, v)
    if torch.is_grad_enabled() and any(a.requires_grad for a in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, bool(causal), int(window),
                                      float(softcap))
    return _launch_forward(q, k, v, causal, window, softcap, False)[0]


def flash_attention_with_lse(q, k, v, *, causal: bool = True,
                             window: int = 0, softcap: float = 0.0):
    """(o, lse (B, H, T) float32) with no autograd: K5 with its
    log-sum-exp on CUDA tensors, the plain versions on CPU ones."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return (flash_attention_plain(q, k, v, causal=causal, window=window,
                                      softcap=softcap),
                flash_attention_lse_plain(q, k, v, causal=causal,
                                          window=window, softcap=softcap))
    check_device("flash_attention", q)
    _launch_checks(q, k, v)
    return _launch_forward(q, k, v, causal, window, softcap, True)


def flash_attention_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          ref: torch.Tensor, *, causal: bool = True,
                          window: int = 0,
                          softcap: float = 0.0) -> torch.Tensor:
    """`flash_attention_tolerance` for these inputs, in the model's layout:
    for bf16 it needs softmax(q k^T / sqrt(hd)) |v|, the plain version run
    in float32 on |v|."""
    abs_out = None
    if ref.dtype == torch.bfloat16:
        abs_out = flash_attention_plain(q.float(), k.float(), v.float().abs(),
                                        causal=causal, window=window,
                                        softcap=softcap)
    return flash_attention_tolerance(v, ref, abs_out)


__all__ = ["FlashAttentionFn", "flash_attention", "flash_attention_bound",
           "flash_attention_bwd", "flash_attention_bwd_plain",
           "flash_attention_lse_plain", "flash_attention_plain",
           "flash_attention_ref", "flash_attention_with_lse", "takes_wgmma",
           "takes_wgmma_bwd", "bwd_head_split", "bwd_smem_bytes"]
