"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Runs the batched engine on synthetic requests against seeded random
weights of the reduced config (``ArchConfig.reduced``), on CUDA unless
``--device cpu`` is given. Every attention, local (ring-buffer), Mamba-1
and RG-LRU mixer and every dense and MoE FFN is ported; the architectures
with MLA (deepseek-v2-236b), an encoder (whisper-base) or vision inputs
(llama-3.2-vision-11b) are later slices and raise ``NotImplementedError``.
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
    reqs = [Request(rid=i, prompt=[(7 * i + 3) % cfg.vocab_size,
                                   (11 * i + 5) % cfg.vocab_size],
                    max_new_tokens=args.max_new_tokens)
            for i in range(args.requests)]
    t0 = time.time()
    eng.run(reqs)
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
