"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the batched engine on synthetic requests against seeded random
weights of the reduced config (``ArchConfig.reduced``), on CUDA unless
``--device cpu`` is given. Every architecture of the registry serves. As in
the JAX package's launcher, whisper's cross-attention context is the
encoder's output over zero frames, and the vision model's zero patches.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS
from repro_torch.nn import transformer as T
from repro_torch.serve.engine import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=sorted(ARCHS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = ARCHS[args.arch].reduced()
    params = T.init(torch.Generator(device=dev).manual_seed(0), cfg,
                    device=dev)
    eng = ServeEngine(params, cfg, batch=args.batch, max_len=args.max_len,
                      device=dev)
    enc_out = None
    if cfg.encoder is not None:
        frames = torch.zeros((args.batch, cfg.encoder.num_frames,
                              cfg.d_model), device=dev)
        enc_out = T._encoder_forward(params["encoder"], frames, cfg,
                                     remat=False)
    elif cfg.vision is not None:
        enc_out = torch.zeros((args.batch, cfg.vision.num_patches,
                               cfg.d_model), device=dev)
    reqs = [Request(rid=i, prompt=[(7 * i + 3) % cfg.vocab_size,
                                   (11 * i + 5) % cfg.vocab_size],
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    eng.run(reqs, enc_out=enc_out)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.time() - t0
    out = {"arch": cfg.name, "device": str(dev), "requests": len(reqs),
           "tokens": eng.stats.tokens_generated, "steps": eng.stats.steps,
           "tokens_per_s": round(eng.stats.tokens_generated / dt, 1),
           "sample_output": reqs[0].output}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
