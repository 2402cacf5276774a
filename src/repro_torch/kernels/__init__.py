"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch counts.

Each wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel and
nowhere else, so a run can show that its path went through the kernel.
``LAUNCHES["flash_attention_wgmma"]`` counts, in addition, the launches of
K5 that took its wgmma body (bf16 at head_dim 64, 128, 192 or 256);
``LAUNCHES["quant_matmul_mma"]`` and ``LAUNCHES["block_sparse_matmul_mma"]``
those of K2 and K4 that took their tensor-core (``mma.sync``) decode body
(bf16 x); ``LAUNCHES["quant_matmul_wgmma"]`` those of K2 that took its
large-M body (``wgmma``, bf16 x from ``quant_matmul.ops.wgmma_min_m``
rows);
``LAUNCHES["quant_matmul_int4"]`` those of K2 on a packed 4-bit payload
(its int4 bodies, either x type);
``LAUNCHES["quant_matmul_experts"]`` counts the launches of K2's expert
body (an MoE layer's expert products in one launch), which are counted in
``quant_matmul_mma`` (bf16 x) and ``quant_matmul_int4`` too, not in
``quant_matmul``;
``LAUNCHES["netlist_sim_smem"]`` those of K1 that took its shared-memory
body (every population whose table fits in 227 KB at one sample a block).
``LAUNCHES["flash_attention_bwd"]`` and ``LAUNCHES["ssm_scan_bwd"]`` count
the backward kernels of K5 and K6, one a wrapper call (each call runs its
file's kernels in order on one stream);
``LAUNCHES["flash_attention_bwd_wgmma"]`` counts, in addition, those of
K5's backward that took its wgmma body (bf16 at head_dim 64 or 128).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.obs import prof as PF

LAUNCHES: Dict[str, int] = {"netlist_sim": 0, "netlist_sim_smem": 0,
                             "quant_matmul": 0,
                             "flash_attention": 0,
                             "flash_attention_wgmma": 0, "ssm_scan": 0,
                             "clustered_matmul": 0,
                             "block_sparse_matmul": 0,
                             "quant_matmul_mma": 0,
                             "quant_matmul_int4": 0,
                             "quant_matmul_wgmma": 0,
                             "quant_matmul_experts": 0,
                             "block_sparse_matmul_mma": 0,
                             "flash_attention_bwd": 0,
                             "flash_attention_bwd_wgmma": 0,
                             "ssm_scan_bwd": 0}


def check_device(name: str, t: torch.Tensor) -> None:
    """Where a kernel's wrapper goes past its CPU branch: CUDA launches,
    and meta, while something watches the launches (`obs.prof.watching`:
    a `roofline.analysis.StepCounter` counting a step), takes the
    wrapper's meta branch (empty outputs of the kernel's shapes and its
    analytic cost reported, no launch, no plain version). Anything else
    raises."""
    if t.device.type == "cuda":
        return
    if t.device.type == "meta" and PF.watching():
        return
    raise ValueError(f"{name} runs on CUDA or CPU, not {t.device} (meta "
                     f"tensors only under roofline.analysis.count_step)")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise when grad mode is on and an input requires grad: the kernel
    ``name`` has no backward, and its output, filled through ``ctypes``,
    would carry no ``grad_fn``, so the gradient would stop there without a
    word."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward kernel: an input requires grad, and "
            f"its output would silently carry none. Call it under "
            f"torch.no_grad(), or detach the inputs")
