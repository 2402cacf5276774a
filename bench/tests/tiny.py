"""Tiny configurations and mixes for the benchmark's CPU tests: the cells'
kinds of model and traffic at sizes a test run holds."""
import time

import torch

from bench.harness.common import Context
from bench.reference.spec import MLA, MoE, ModelSpec

MLA_MOE = ModelSpec(
    name="tiny-mla-moe", vocab_size=1024, d_model=128, num_heads=4,
    num_kv_heads=4, head_dim=24, n_dense=1, n_moe=2, d_ff=96,
    rope_theta=10000.0, rms_eps=1e-6,
    mla=MLA(q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
            qk_rope_head_dim=8, v_head_dim=16),
    moe=MoE(num_experts=8, top_k=2, d_expert=64, d_shared=64,
            capacity_factor=1.25), dtype="float32")
GQA_MOE = ModelSpec(
    name="tiny-gqa-moe", vocab_size=1024, d_model=128, num_heads=4,
    num_kv_heads=2, head_dim=32, n_dense=0, n_moe=2, d_ff=0,
    rope_theta=10000.0, rms_eps=1e-6, mla=None,
    moe=MoE(num_experts=8, top_k=2, d_expert=64, d_shared=0,
            capacity_factor=1.25), dtype="float32")

MIXES = {
    "decode": {"kind": "decode", "weights_bits": 8, "batch": 6,
               "prompt_len": 32, "fill_rows": 2, "fill_chunk": 16,
               "wave_tokens": 8, "trace_steps": 2, "check_rows": 2,
               "check_waves": 2},
    "prefill": {"kind": "prefill", "lengths": [24, 40], "trace_requests": 2,
                "check_requests": 2},
    "train": {"kind": "train", "batch": 2, "seq_len": 32, "checked_steps": 3,
              "trace_steps": 1,
              "adamw": {"lr": 0.001, "b1": 0.9, "b2": 0.95, "eps": 1e-08,
                        "weight_decay": 0.1, "grad_clip": 1.0,
                        "schedule": "constant", "warmup_steps": 0}},
}
SPECS = {"decode": MLA_MOE, "prefill": MLA_MOE, "train": GQA_MOE}


def context(kind: str, *, seed: int = 3_000_000_019, trace: bool = False,
            faults=(), control: bool = False, seconds: float = 0.5):
    return Context(workload=f"tiny.{kind}", spec=SPECS[kind],
                   mix=dict(MIXES[kind]), seed=seed, seconds=seconds,
                   trace=trace, device=torch.device("cpu"),
                   t_start=time.perf_counter(), faults=frozenset(faults),
                   control=control)
