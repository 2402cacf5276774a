"""Training loop with fault tolerance, the PyTorch counterpart of
`repro.train.trainer`: periodic asynchronous checkpoints
(`ckpt.checkpoint.CheckpointManager`), resume, deterministic data (the
step-indexed `data.tokens.TokenPipeline`), a preemption hook (SIGTERM:
finish the step, checkpoint, stop) and a ``history`` of logged steps.
Runs on CUDA unless the trainer is given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ArchConfig
from repro_torch.data.tokens import TokenPipeline
from repro_torch.train import train_state as TS
from repro_torch.train.optimizer import AdamWConfig


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    log_every: int = 10
    microbatch: Optional[int] = None
    ckpt_dir: Optional[str] = None
    keep_ckpts: int = 3
    straggler_deadline_s: float = 0.0   # >0: skip-slow-batch barrier


class Trainer:
    def __init__(self, cfg: ArchConfig, opt_cfg: AdamWConfig,
                 tcfg: TrainerConfig, pipeline: TokenPipeline, *,
                 extra_batch: Optional[Callable[[int], Dict]] = None,
                 device: DeviceLike = None):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.pipeline = pipeline
        self.extra_batch = extra_batch
        self.device = resolve_device(device)
        self.ckpt = (CheckpointManager(tcfg.ckpt_dir, keep=tcfg.keep_ckpts)
                     if tcfg.ckpt_dir else None)
        self._preempted = False
        # the loop hands each step its state, as the reference's dry run
        # donates it; a checkpoint copies the state to the host first
        self.step_fn = TS.make_train_step(cfg, opt_cfg, remat=True,
                                          microbatch=tcfg.microbatch)
        self.history: List[Dict] = []

    # -- fault tolerance hooks ----------------------------------------------

    def request_preemption(self, *_):
        """SIGTERM handler at scale: finish the step, checkpoint, exit."""
        self._preempted = True

    def install_signal_handler(self):
        signal.signal(signal.SIGTERM, self.request_preemption)

    # -- main loop ------------------------------------------------------------

    def default_generator(self) -> torch.Generator:
        """The generator a run draws its parameters from when given none:
        seed 0 on the trainer's device."""
        return torch.Generator(device=self.device).manual_seed(0)

    def init_or_resume(self, generator: torch.Generator) -> tuple:
        """(state, first step): fresh parameters from ``generator``, or the
        latest checkpoint's state and the step after it."""
        state = TS.init_state(generator, self.cfg, self.opt_cfg,
                              device=self.device)
        start_step = 0
        if self.ckpt is not None:
            restored, meta = self.ckpt.restore(like=state)
            if restored is not None:
                state = restored
                start_step = int(meta["step"]) + 1
        return state, start_step

    def run(self, generator: Optional[torch.Generator] = None) -> Dict:
        generator = generator if generator is not None \
            else self.default_generator()
        state, start = self.init_or_resume(generator)
        t_start = time.time()
        step = start - 1
        for step in range(start, self.tcfg.total_steps):
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipeline.batch_at(step).items()}
            if self.extra_batch is not None:
                batch.update(self.extra_batch(step))
            t0 = time.time()
            state, metrics = self.step_fn(state, batch)
            loss = float(metrics["loss"])       # waits for the step
            dt = time.time() - t0
            if step % self.tcfg.log_every == 0 or \
                    step == self.tcfg.total_steps - 1:
                rec = {"step": step, "loss": loss,
                       "lr": float(metrics["lr"]),
                       "grad_norm": float(metrics["grad_norm"]),
                       "step_s": round(dt, 4)}
                self.history.append(rec)
                print(f"step {step:6d} loss {loss:8.4f} "
                      f"gnorm {rec['grad_norm']:7.3f} {dt*1e3:7.1f} ms",
                      flush=True)
            if self.ckpt is not None and (
                    step % self.tcfg.ckpt_every == 0 and step > 0
                    or self._preempted
                    or step == self.tcfg.total_steps - 1):
                self.ckpt.save(step, state, meta={"step": step, "loss": loss})
            if self._preempted:
                break
        if self.ckpt is not None:
            self.ckpt.wait()
        self.state = state
        return {"history": self.history,
                "final_loss": self.history[-1]["loss"] if self.history else None,
                "wall_s": time.time() - t_start,
                "preempted": self._preempted,
                "last_step": step if self.tcfg.total_steps else -1}
