"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--reduced] [--device cpu] [...]``.

Single-device execution of the train step (`train.train_state`), on CUDA
unless ``--device cpu`` is given, with the reference launcher's flags:
resume and periodic asynchronous checkpoints (``--ckpt-dir``), preemption
(SIGTERM), microbatching, and the paper's compression as a first-class
flag (``--qat-bits`` / ``--sparsity`` / ``--clusters`` apply the
`repro_torch.core` QAT forward to every matrix weight). The token
pipeline makes no frames or patches, so the encoder-decoder (whisper-base)
and vision (llama-3.2-vision-11b) models do not train here yet.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.core import pruning as P
from repro_torch.core import quantization as Q
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.train import train_state as TS
from repro_torch.train.optimizer import AdamWConfig, tree_map
from repro_torch.train.trainer import Trainer, TrainerConfig


def make_compression(bits=None, sparsity=0.0, clusters=None):
    """params -> params QAT transform over the weights of two or more
    dimensions with at least 4096 values (the paper's techniques): a
    magnitude mask, per-matrix clustering and fake quantization, each with
    a straight-through gradient. None when no technique is asked for."""
    if bits is None and not sparsity and clusters is None:
        return None
    from repro_torch.core.clustering import cluster_ste

    def transform(params):
        def leaf(w):
            if w.dim() < 2 or w.numel() < 4096:
                return w
            out = w
            if sparsity:
                out = P.apply_mask(out, P.magnitude_mask(out, sparsity))
            if clusters is not None and out.dim() == 2:
                out = cluster_ste(out, clusters, per_input=False)
            if bits is not None:
                out = Q.fake_quant(out, Q.QuantConfig(bits=bits))
            return out
        return tree_map(leaf, params)

    return transform


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--qat-bits", type=int, default=None)
    ap.add_argument("--sparsity", type=float, default=0.0)
    ap.add_argument("--clusters", type=int, default=None)
    ap.add_argument("--log-every", type=int, default=10,
                    help="steps between the records of the run's history")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch]
    if args.reduced:
        cfg = cfg.reduced()
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.global_batch))
    opt = AdamWConfig(lr=args.lr, total_steps=args.steps,
                      warmup_steps=max(args.steps // 20, 1))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                         microbatch=args.microbatch)
    trainer = Trainer(cfg, opt, tcfg, pipe, device=dev)
    compression = make_compression(args.qat_bits, args.sparsity,
                                   args.clusters)
    if compression is not None:
        trainer.step_fn = TS.make_train_step(
            cfg, opt, remat=True, microbatch=args.microbatch,
            compression=compression)
    trainer.install_signal_handler()
    out = trainer.run()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({k: v for k, v in out.items() if k != "history"}))
    return dict(out, trainer=trainer)


if __name__ == "__main__":
    main()
