"""End-to-end example: train a ~100M-parameter qwen3-family LM on the
synthetic Markov stream through the port's trainer, with asynchronous
checkpoints and resume (a second run with the same ``--ckpt-dir`` continues
from the last checkpoint). K5 and its backward kernel run every attention
layer on the card.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm_100m
      [--steps 300] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import ARCHS, backend
from repro_torch.configs.base import LayerSpec, Segment
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.launch import specs as SP
from repro_torch.nn import transformer as T
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


def model_100m():
    """qwen3-family, ~100M params: 12L x d768 x ffn2560, 32k vocab."""
    base = ARCHS["qwen3-0.6b"]
    return dataclasses.replace(
        base, name="qwen3-100m", d_model=768, num_heads=12, num_kv_heads=4,
        head_dim=64, d_ff=2560, vocab_size=32768,
        segments=(Segment((LayerSpec("attn", "dense"),), 12),),
        dtype="float32", tie_embeddings=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", default="artifacts/lm100m_ckpt")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    backend.configure()               # the REPRO_* knobs

    cfg = model_100m()
    n = T.param_count(SP.abstract_params(cfg))      # counted on meta
    print(f"model: {cfg.name} {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq_len}")

    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, branching=4))
    opt = AdamWConfig(lr=6e-4, warmup_steps=20, total_steps=args.steps)
    trainer = Trainer(cfg, opt, TrainerConfig(
        total_steps=args.steps, ckpt_every=100, log_every=args.log_every,
        ckpt_dir=args.ckpt_dir, microbatch=None), pipe, device=args.device)
    trainer.install_signal_handler()
    out = trainer.run()
    first = trainer.history[0]["loss"]
    print(f"loss {first:.3f} -> {out['final_loss']:.3f} "
          f"({out['wall_s']:.0f}s; ckpts in {args.ckpt_dir})")
    assert out["final_loss"] < first, "loss must decrease"
    return {"params": n, "first_loss": first,
            "final_loss": out["final_loss"], "wall_s": out["wall_s"],
            "history": trainer.history}


if __name__ == "__main__":
    main()
