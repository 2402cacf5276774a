"""Printed-MLP minimization pipeline (the paper, end to end), in PyTorch.

Flow per candidate spec (bits/sparsity/clusters per layer):

  FP32 pretrain (cached per dataset and device)
    -> magnitude masks from pretrained weights (fixed during finetune)
    -> QAT finetune with STE prune/cluster/quant forward   [paper's QKeras QAT]
    -> bespoke "compile": integer weights + shared-product codebooks (numpy)
    -> test accuracy of the compiled arithmetic + printed area (hw_model)

Training is full-batch Adam written out by hand, matching
`repro.core.minimize` operation for operation in float32 (the step counter
is a float32 tensor, so the bias corrections are float32 powers). TF32 is
switched off for the matmuls: the reference trains in full float32.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.printed_mlp import PrintedMLPConfig
from repro_torch.core import clustering as C
from repro_torch.core import hw_model as HW
from repro_torch.core import pruning as P
from repro_torch.core import quantization as Q
from repro_torch.core.compression_spec import ModelMin
from repro_torch.data.uci import dataset_for
from repro_torch.nn import mlp as M


def _np(a) -> np.ndarray:
    """Host numpy view of a tensor or array-like."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def _adam_update(g, m, v, t, lr, b1=0.9, b2=0.999, eps=1e-8):
    """``t`` is a float32 tensor: ``b1 ** t`` is a float32 power, as in the
    reference's scan over ``jnp.arange(epochs, dtype=float32)``."""
    m = b1 * m + (1 - b1) * g
    v = b2 * v + (1 - b2) * torch.square(g)
    mh = m / (1 - torch.pow(b1, t))
    vh = v / (1 - torch.pow(b2, t))
    return -lr * mh / (torch.sqrt(vh) + eps), m, v


def _loss(params, x, y, w_transform):
    """Mean cross-entropy; with population-stacked params (leading P axis)
    the per-candidate means are summed, so each candidate's gradient is
    exactly that of its own loss."""
    p2 = {"layers": tuple(
        {"w": w_transform(i, l["w"]), "b": l["b"]}
        for i, l in enumerate(params["layers"]))}
    logits = M.mlp_forward(p2, x)
    logp = torch.log_softmax(logits, dim=-1)
    yy = y.expand(logp.shape[:-1]).unsqueeze(-1)
    return -torch.gather(logp, -1, yy).squeeze(-1).mean(-1).sum()


def _train(params, x, y, *, epochs: int, lr: float, w_transform):
    """Full-batch Adam over ``epochs``. float32 products run in full float32
    (TF32 off, as the reference's parity needs) inside the loop only: the
    caller's ``allow_tf32`` is put back on the way out."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return _adam_loop(params, x, y, epochs=epochs, lr=lr,
                          w_transform=w_transform)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


def _adam_loop(params, x, y, *, epochs: int, lr: float, w_transform):
    flat = [l[k].detach().clone() for l in params["layers"]
            for k in ("w", "b")]
    m = [torch.zeros_like(f) for f in flat]
    v = [torch.zeros_like(f) for f in flat]
    n_layers = len(params["layers"])
    for e in range(epochs):
        t = torch.full((), e + 1.0, dtype=torch.float32, device=x.device)
        leaves = [f.requires_grad_(True) for f in flat]
        p = {"layers": tuple({"w": leaves[2 * i], "b": leaves[2 * i + 1]}
                             for i in range(n_layers))}
        grads = torch.autograd.grad(_loss(p, x, y, w_transform), leaves)
        with torch.no_grad():
            upd = [_adam_update(g, mi, vi, t, lr)
                   for g, mi, vi in zip(grads, m, v)]
            flat = [f.detach() + u[0] for f, u in zip(flat, upd)]
            m = [u[1] for u in upd]
            v = [u[2] for u in upd]
    return {"layers": tuple({"w": flat[2 * i], "b": flat[2 * i + 1]}
                            for i in range(n_layers))}


def _tensors(x, y, device):
    return (torch.as_tensor(np.asarray(x, np.float32), device=device),
            torch.as_tensor(np.asarray(y, np.int64), device=device))


@functools.lru_cache(maxsize=32)
def _pretrain(cfg: PrintedMLPConfig, epochs: int, lr: float, seed: int,
              device: torch.device):
    xtr, ytr, xte, yte = dataset_for(cfg, seed=seed)
    gen = torch.Generator().manual_seed(seed)
    params = M.mlp_init(gen, cfg.layer_dims, device=device)
    params = _train(params, *_tensors(xtr, ytr, device), epochs=epochs,
                    lr=lr, w_transform=lambda i, w: w)
    return params, (xtr, ytr, xte, yte)


def pretrain(cfg: PrintedMLPConfig, *, epochs: int = 600, lr: float = 5e-3,
             seed: int = 0, device: DeviceLike = None):
    """FP32 baseline training (cached per device). Returns (params on
    ``device``, (numpy data tuple))."""
    return _pretrain(cfg, epochs, lr, seed, resolve_device(device))


# ---------------------------------------------------------------------------
# QAT finetune under a spec
# ---------------------------------------------------------------------------


def _qat_transform(spec: ModelMin, masks):
    def t(i, w):
        lm = spec.layers[i]
        if masks[i] is not None:
            w = P.apply_mask(w, masks[i])
        if lm.clusters is not None:
            w = C.cluster_ste(w, lm.clusters)
        if lm.bits is not None:
            w = Q.fake_quant(w, Q.QuantConfig(bits=lm.bits))
        return w
    return t


def qat_finetune(params0, spec: ModelMin, masks, x, y, *, epochs: int = 150,
                 lr: float = 2e-3, device: DeviceLike = None):
    """params0 and masks: tensors (or numpy masks); x, y: numpy. Runs on
    ``device`` and returns params there."""
    dev = resolve_device(device)
    params0 = {"layers": tuple({k: l[k].to(dev) for k in ("w", "b")}
                               for l in params0["layers"])}
    masks = [None if mk is None else torch.as_tensor(_np(mk), device=dev)
             for mk in masks]
    return _train(params0, *_tensors(x, y, dev), epochs=epochs, lr=lr,
                  w_transform=_qat_transform(spec, masks))


# ---------------------------------------------------------------------------
# bespoke compile + evaluation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CompiledMLP:
    q_layers: List[np.ndarray]           # integer weights (0 = pruned)
    scales: List[float]
    biases: List[np.ndarray]
    clusters: List[Optional[Tuple[np.ndarray, np.ndarray]]]  # (idx, int codebook)
    w_bits: List[int]
    input_bits: int

    def dense_weights(self) -> List[np.ndarray]:
        out = []
        for q, s, cl in zip(self.q_layers, self.scales, self.clusters):
            out.append(q.astype(np.float32) * s)
        return out


def compile_bespoke(params, spec: ModelMin, masks) -> CompiledMLP:
    q_layers, scales, biases, clusters, w_bits = [], [], [], [], []
    for i, layer in enumerate(params["layers"]):
        lm = spec.layers[i]
        bits = lm.bits if lm.bits is not None else 8
        w = np.asarray(_np(layer["w"]), np.float32)
        if masks[i] is not None:
            w = w * np.asarray(_np(masks[i]), np.float32)
        if lm.clusters is not None:
            cb, idx = C.cluster_per_input(torch.from_numpy(w), lm.clusters)
            cb, idx = cb.numpy(), idx.numpy()
            w_rec = np.take_along_axis(cb, idx, axis=1)
            # snap codebooks to the fixed-point grid
            qmax = 2 ** (bits - 1) - 1
            s = max(np.abs(w_rec).max(), 1e-8) / qmax
            cb_q = np.clip(np.round(cb / s), -qmax, qmax).astype(np.int64)
            q = np.take_along_axis(cb_q, idx, axis=1)
            # re-apply pruning zeros (cluster may absorb them)
            if masks[i] is not None:
                q = q * np.asarray(_np(masks[i]), np.int64)
            clusters.append((idx, cb_q))
        else:
            qt, st = Q.quantize_int(torch.from_numpy(w),
                                    Q.QuantConfig(bits=bits))
            q, s = qt.numpy().astype(np.int64), float(st)
            clusters.append(None)
        q_layers.append(q)
        scales.append(float(s))
        biases.append(np.asarray(_np(layer["b"]), np.float32))
        w_bits.append(bits)
    return CompiledMLP(q_layers, scales, biases, clusters, w_bits,
                       spec.input_bits)


def quantize_inputs(c: CompiledMLP, x: np.ndarray) -> np.ndarray:
    """ADC front-end: features in [0, 1] -> unsigned integers on the
    2**input_bits - 1 grid — the same rounding `compiled_accuracy` applies
    before its float emulation, kept integer."""
    levels = (1 << c.input_bits) - 1
    return np.round(np.asarray(x, np.float32) * levels).astype(np.int64)


def integer_biases(c: CompiledMLP) -> List[np.ndarray]:
    """Bias constants on each layer's integer accumulator grid.

    Layer i's integer pre-activation represents the float one through the
    cumulative factor alpha_i = (prod_{j<=i} scale_j) / (2**input_bits - 1)
    (inputs contribute 1/levels, each weight matmul its layer scale), so the
    hardwired bias constant is round(b / alpha_i). ReLU and argmax commute
    with the positive alpha_i, making this the only rounding the bespoke
    integer circuit adds on top of the QAT compile."""
    alpha = 1.0 / ((1 << c.input_bits) - 1)
    out = []
    for i, (s, b) in enumerate(zip(c.scales, c.biases)):
        alpha *= s
        v = np.round(np.asarray(b, np.float64) / alpha)
        if np.abs(v).max(initial=0.0) >= 2.0 ** 62:
            raise OverflowError(
                f"layer {i} bias constant exceeds the 62-bit exact integer "
                f"budget (degenerate scale chain alpha={alpha:.3e})")
        out.append(v.astype(np.int64))
    return out


def integer_forward(c: CompiledMLP, x_int: np.ndarray
                    ) -> Tuple[List[np.ndarray], np.ndarray]:
    """The static QAT forward in exact integer arithmetic — the reference
    semantics the compiled netlist (`repro.circuit`) must reproduce
    bit-for-bit.

    x_int: (B, d_in) integers from `quantize_inputs`. Returns (per-layer
    integer pre-activations [(B, d_out_i) int64], argmax class (B,)).
    """
    b_ints = integer_biases(c)
    a = np.asarray(x_int, np.int64)
    pres: List[np.ndarray] = []
    for i, (q, b) in enumerate(zip(c.q_layers, b_ints)):
        pre = a @ q.astype(np.int64) + b
        pres.append(pre)
        if i < len(c.q_layers) - 1:
            a = np.maximum(pre, 0)
    return pres, np.argmax(pres[-1], axis=1)


def compiled_accuracy(c: CompiledMLP, x: np.ndarray, y: np.ndarray) -> float:
    """Accuracy of the exact bespoke arithmetic: quantized inputs x quantized
    integer weights (float emulation is exact for these ranges)."""
    levels = 2 ** c.input_bits - 1
    h = np.round(np.asarray(x, np.float32) * levels) / levels
    ws = c.dense_weights()
    for i, (w, b) in enumerate(zip(ws, c.biases)):
        h = h @ w + b
        if i < len(ws) - 1:
            h = np.maximum(h, 0.0)
    return float(np.mean(np.argmax(h, axis=1) == y))


def compiled_cost(c: CompiledMLP) -> HW.CircuitCost:
    return HW.mlp_cost(c.q_layers, w_bits=c.w_bits, in_bits=c.input_bits,
                       clusters=c.clusters)


# ---------------------------------------------------------------------------
# spec evaluation + sweeps (Fig. 1)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EvalResult:
    spec: ModelMin
    accuracy: float
    area_mm2: float
    power_mw: float
    n_multipliers: int
    # critical-path length of the compiled netlist in full-adder-stage
    # delays (repro.circuit) — the analytic model cannot produce this;
    # None for results predating the circuit compiler (old caches).
    delay_levels: Optional[int] = None


def make_masks(params0, spec: ModelMin):
    return [P.magnitude_mask(l["w"], lm.sparsity) if lm.sparsity > 0 else None
            for l, lm in zip(params0["layers"], spec.layers)]


def evaluate_spec(cfg: PrintedMLPConfig, spec: ModelMin, *,
                  epochs: int = 150, seed: int = 0,
                  netlist: bool = True,
                  device: DeviceLike = None) -> EvalResult:
    """Serial single-spec evaluation, objective-identical to
    `batch_eval.evaluate_population`: accuracy defaults to the bit-exact
    simulation of the compiled netlist (the printed datapath); pass
    ``netlist=False`` for the analytic float-emulation opt-out.
    Area/power stay on the analytic pricing either way, except for specs
    with approximation genes: those are scored by
    `approx.evaluate_netlist` on their approximated netlist (simulated
    accuracy, structural pricing), whatever ``netlist`` says."""
    dev = resolve_device(device)
    params0, (xtr, ytr, xte, yte) = pretrain(cfg, seed=seed, device=dev)
    masks = make_masks(params0, spec)
    params = qat_finetune(params0, spec, masks, xtr, ytr, epochs=epochs,
                          device=dev)
    compiled = compile_bespoke(params, spec, masks)
    from repro_torch.circuit import compile as CC  # lazy: circuit imports us
    net = CC.compile_netlist(compiled)
    if spec.has_approx:
        # the printed circuit is the approximated netlist — one shared
        # scoring policy with the batched path (`approx.evaluate_netlist`)
        from repro_torch import approx as AX
        return AX.evaluate_netlist(net, compiled, spec, xte, yte, device=dev)
    if netlist:
        from repro_torch import circuit as CIRC
        acc = CIRC.netlist_accuracy(net, compiled, xte, yte, device=dev)
    else:
        acc = compiled_accuracy(compiled, xte, yte)
    cost = compiled_cost(compiled)
    return EvalResult(spec, acc, cost.area_mm2, cost.power_mw,
                      cost.n_multipliers,
                      delay_levels=net.critical_path_levels())


def evaluate_specs(cfg: PrintedMLPConfig, specs: Sequence[ModelMin], *,
                   epochs: int = 150, seed: int = 0, cache=None,
                   device: DeviceLike = None) -> List[EvalResult]:
    """Batched counterpart of `evaluate_spec`: the whole list is QAT-
    finetuned in one batched call on ``device`` and priced in one
    vectorized hw_model call (see `core.batch_eval`). `cache` is an
    optional `batch_eval.EvalCache` for cross-run persistence."""
    from repro_torch.core import batch_eval as BE  # lazy: avoids a cycle
    return BE.evaluate_population(cfg, specs, epochs=epochs, seed=seed,
                                  cache=cache, device=device)


def baseline(cfg: PrintedMLPConfig, *, seed: int = 0,
             device: DeviceLike = None) -> EvalResult:
    """MICRO'20 un-minimized bespoke MLP: dense 8-bit fixed point."""
    n = len(cfg.layer_dims) - 1
    return evaluate_spec(cfg, ModelMin.uniform(n, bits=8), epochs=60,
                         seed=seed, device=device)


# The standalone-technique sweeps of the paper's Fig. 1: one serial
# `evaluate_spec` per point, as the reference runs them.


def quant_sweep(cfg, bits_range=None, *, epochs=150, seed=0,
                device: DeviceLike = None):
    if bits_range is None:
        bits_range = range(2, 8)
    n = len(cfg.layer_dims) - 1
    return [evaluate_spec(cfg, ModelMin.uniform(n, bits=b), epochs=epochs,
                          seed=seed, device=device) for b in bits_range]


def prune_sweep(cfg, sparsities=(0.2, 0.3, 0.4, 0.5, 0.6), *, epochs=150,
                seed=0, device: DeviceLike = None):
    n = len(cfg.layer_dims) - 1
    return [evaluate_spec(
        cfg, ModelMin.uniform(n, bits=8, sparsity=s), epochs=epochs,
        seed=seed, device=device) for s in sparsities]


def cluster_sweep(cfg, ks=(2, 3, 4, 6, 8), *, epochs=150, seed=0,
                  device: DeviceLike = None):
    n = len(cfg.layer_dims) - 1
    return [evaluate_spec(
        cfg, ModelMin.uniform(n, bits=8, clusters=k), epochs=epochs,
        seed=seed, device=device) for k in ks]
