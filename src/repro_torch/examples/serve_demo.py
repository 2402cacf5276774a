"""Batched serving demo for a dense, a hybrid (RG-LRU) and an SSM
architecture (reduced configs, random weights): the prompts' prefill
(K5 for attention, K6 for the Mamba scan on the card), greedy decode over
the continuous-batching engine, then the same engine on int8 weights
(kernel K2). The reference's reduced widths are too small for the
quantizer (it leaves leaves under 65536 values in float), so the w8 run
widens d_model to 256 and d_ff to 512.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, backend
from repro_torch.nn import transformer as T
from repro_torch.serve import quantized as QS
from repro_torch.serve.engine import Request, ServeEngine
from repro_torch.train import train_state as TS

ARCH_IDS = ("qwen3-0.6b", "recurrentgemma-9b", "falcon-mamba-7b")


def _requests(n: int, max_new: int):
    return [Request(rid=i, prompt=[1 + i, 2, 3], max_new_tokens=max_new)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=8)
    args = ap.parse_args(argv)
    backend.configure()               # the REPRO_* knobs
    dev = resolve_device(args.device)
    out = {}
    for arch in ARCH_IDS:
        row = {}
        for mode, cfg in (("dense", ARCHS[arch].reduced()),
                          ("w8", ARCHS[arch].reduced(d_model=256,
                                                     d_ff=512))):
            gen = torch.Generator(device=dev).manual_seed(0)
            params = T.init(gen, cfg, device=dev)
            reqs = _requests(args.requests, args.max_new)
            if mode == "dense":
                prompts = torch.tensor([r.prompt for r in reqs[:4]],
                                       device=dev)
                with torch.no_grad():
                    last = TS.make_prefill_step(cfg)(params,
                                                     {"tokens": prompts})
                row["prefill_next"] = last.argmax(-1).tolist()
            else:
                params = QS.quantize_params(params, 8)
            eng = ServeEngine(params, cfg, batch=4, max_len=64, device=dev)
            t0 = time.time()
            with torch.no_grad():
                eng.run(reqs)
            dt = time.time() - t0
            row[mode] = {"tokens": eng.stats.tokens_generated,
                         "seconds": dt,
                         "first": [r.output[0] for r in reqs[:4]],
                         "sample": reqs[0].output}
            print(f"{arch:20s} {mode:5s} {eng.stats.tokens_generated} "
                  f"tokens in {dt:5.2f}s "
                  f"({eng.stats.tokens_generated/dt:7.1f} tok/s, reduced, "
                  f"{dev.type}) sample={reqs[0].output}")
        # the engine's first token of each of the first wave's requests,
        # against the prefill's greedy token on the same prompts
        agree = int(np.sum(np.asarray(row["prefill_next"])
                           == np.asarray(row["dense"]["first"])))
        row["prefill_agrees"] = agree
        print(f"{arch:20s} prefill's next token equals the engine's "
              f"first in {agree}/4 requests")
        out[arch] = row
    return out


if __name__ == "__main__":
    main()
