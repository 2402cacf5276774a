"""Analytic bespoke printed-circuit area/power model (simulated EGT flow).

The paper prices designs with Synopsys DC + PrimeTime + the EGT
(Electrolyte-Gated Transistor) library. Those tools are unavailable here, so
this module implements the published *structure* of bespoke-MLP cost
analytically (Mubarik MICRO'20; Armeniakos DATE'22):

* a bespoke constant-coefficient multiplier is a shift-add network whose size
  is (#non-zero CSD digits of the coefficient - 1) adders at (input_bits +
  weight_bits) width — a zero coefficient is free (no multiplier printed),
  a power-of-two coefficient is a wire shift;
* each neuron sums its non-zero products through an adder tree: (operands-1)
  adders at accumulator width; pruning removes operands, shrinking the tree;
* per-input weight clustering shares the product x_i*c across fan-out: the
  row's multiplier count collapses to its #distinct non-zero clusters
  (adder trees are unchanged — sharing saves multipliers, not sums);
* ReLU = comparator+mux, argmax = comparator tree.

Unit calibration: EGT full-adder equivalents. AREA_FA/POWER_FA are set so the
un-minimized 8-bit bespoke MLPs land in the tens-of-cm^2 / ~100 mW range
reported by MICRO'20. Absolute numbers are approximate (documented DESIGN.md
§4); the paper's *relative* claims (5x/2.8x/3.5x/8x) are what EXPERIMENTS.md
validates.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# EGT-scale constants, calibrated so (a) un-minimized 8-bit bespoke MLPs land
# at the tens-of-cm^2 / tens-of-mW magnitudes of MICRO'20 and (b) the
# multiplier/adder area split matches bespoke synthesis (multipliers ~3/4 of
# neuron area -- Armeniakos DATE'22 Fig.3): see EXPERIMENTS.md §Calibration.
AREA_FA_MM2 = 0.60          # printed 1-bit full adder, mm^2
POWER_FA_MW = 0.004         # mW per full-adder equivalent (EGT, ~few Hz duty)
RELU_FA_EQ = 2.0            # comparator+mux per output bit, FA equivalents
ARGMAX_FA_EQ = 1.2          # comparator per bit, FA equivalents
MULT_ROUTING_FACTOR = 2.0   # partial-product generation + shift routing
# overhead per CSD-digit adder: bespoke multipliers dominate printed neuron
# area (~75-85%, Armeniakos DATE'22) -- this factor sets that split


def csd_nonzero_digits(c: int) -> int:
    """Number of non-zero digits in the canonical signed-digit form of |c|.
    This is the count of shift-add/sub terms a bespoke constant multiplier
    needs (Avizienis recoding)."""
    c = abs(int(c))
    count = 0
    while c:
        if c & 1:
            count += 1
            # CSD: runs of 1s become +/- pair -> round to nearest multiple of 4
            c = c + 1 if (c & 3) == 3 else c - 1
        c >>= 1
    return count


def csd_digits(c: int) -> List[Tuple[int, int]]:
    """Full signed-digit recoding of ``c``: [(shift, sign)] with sign in
    {+1, -1} and c == sum(sign << shift). Same Avizienis recurrence as
    `csd_nonzero_digits` — ``len(csd_digits(c)) == csd_nonzero_digits(c)``
    for every c — but keeping the digits, which is what the bespoke circuit
    compiler (`repro_torch.circuit.compile`) materializes as one shift-add
    network per constant coefficient."""
    neg = c < 0
    c = abs(int(c))
    out: List[Tuple[int, int]] = []
    pos = 0
    while c:
        if c & 1:
            if (c & 3) == 3:
                out.append((pos, -1))
                c += 1
            else:
                out.append((pos, 1))
                c -= 1
        c >>= 1
        pos += 1
    return [(p, -s) for p, s in out] if neg else out


def csd_nonzero_digits_vec(q: np.ndarray) -> np.ndarray:
    """Vectorized `csd_nonzero_digits` over an integer tensor of any shape —
    the same Avizienis recoding run on all coefficients at once with array
    bit-twiddling (one pass per bit position instead of one Python call per
    coefficient). Exact integer arithmetic; matches the scalar loop
    bit-for-bit for every |c| < 2**62."""
    c = np.abs(np.asarray(q, np.int64))
    count = np.zeros(c.shape, np.int64)
    while c.any():
        odd = (c & 1) == 1
        count += odd
        run = odd & ((c & 3) == 3)          # mid-run of 1s -> +1 (borrow up)
        c = np.where(run, c + 1, np.where(odd, c - 1, c))
        c >>= 1
    return count


_csd_vec = csd_nonzero_digits_vec


def _used_clusters(idx: np.ndarray, active: np.ndarray, k: int) -> np.ndarray:
    """Which cluster slots each input row actually drives: idx/active
    (..., d_in, d_out) -> bool (..., d_in, k). A slot counts only if some
    surviving (non-pruned) weight references it — one-hot reduction over the
    fan-out axis, no per-row Python loop."""
    onehot = idx[..., None] == np.arange(k, dtype=idx.dtype)
    return np.logical_and(onehot, active[..., None]).any(axis=-2)


@dataclasses.dataclass
class LayerCost:
    n_multipliers: int
    mult_fa: float
    adder_fa: float
    act_fa: float

    @property
    def total_fa(self) -> float:
        return self.mult_fa + self.adder_fa + self.act_fa


@dataclasses.dataclass
class CircuitCost:
    layers: List[LayerCost]
    argmax_fa: float

    @property
    def total_fa(self) -> float:
        return sum(l.total_fa for l in self.layers) + self.argmax_fa

    @property
    def area_mm2(self) -> float:
        return self.total_fa * AREA_FA_MM2

    @property
    def power_mw(self) -> float:
        return self.total_fa * POWER_FA_MW

    @property
    def n_multipliers(self) -> int:
        return sum(l.n_multipliers for l in self.layers)


def layer_cost(q: np.ndarray, *, w_bits: int, in_bits: int,
               cluster_idx: Optional[np.ndarray] = None,
               cluster_codebook_q: Optional[np.ndarray] = None,
               relu: bool = True) -> LayerCost:
    """Cost of one bespoke dense layer.

    q: integer weight matrix (d_in, d_out) on the w_bits grid (0 = pruned).
    cluster_idx/codebook_q: per-input clustering (idx (d_in,d_out),
    integer codebooks (d_in, k)) — multipliers are shared within a row.
    """
    q = np.asarray(q, np.int64)
    d_in, d_out = q.shape
    prod_width = in_bits + w_bits

    # ---- multipliers -------------------------------------------------------
    # each non-zero CSD digit costs one shifted add/sub at product width
    # (the first partial product's routing/shift network included -- a
    # power-of-two coefficient is wiring, not free)
    active = np.abs(q) > 0                                 # (d_in, d_out)
    if cluster_idx is not None:
        cb = np.asarray(cluster_codebook_q, np.int64)
        sel = _used_clusters(np.asarray(cluster_idx), active, cb.shape[1])
        sel &= np.abs(cb) > 0                              # (d_in, k)
        n_mult = int(sel.sum())
        mult_fa = float((_csd_vec(cb) * sel).sum()
                        * prod_width) * MULT_ROUTING_FACTOR
    else:
        n_mult = int(active.sum())
        mult_fa = float(_csd_vec(q).sum()                  # csd(0) == 0
                        * prod_width) * MULT_ROUTING_FACTOR

    # ---- adder trees (per output neuron; sharing does not shrink sums).
    # Tree adders are dominated by the narrow lower levels: width ~ product
    # width (the few wide top-level adders are amortized).
    operands = active.sum(axis=0)                          # (d_out,)
    adder_fa = float((np.maximum(operands - 1, 0) + 1).sum()
                     * prod_width)                          # tree + bias add

    # ---- activation ---------------------------------------------------------
    acc_w = prod_width + math.ceil(math.log2(max(int(operands.max(initial=1)), 2)))
    act_fa = d_out * RELU_FA_EQ * acc_w if relu else 0.0

    return LayerCost(n_multipliers=n_mult, mult_fa=mult_fa,
                     adder_fa=adder_fa, act_fa=act_fa)


def _ceil_log2(m: np.ndarray) -> np.ndarray:
    """Exact integer ceil(log2(m)) for int arrays m >= 1 (frexp exponent of
    m-1 — no float-log rounding)."""
    m = np.asarray(m, np.int64)
    return np.frexp((m - 1).astype(np.float64))[1].astype(np.int64)


def layer_cost_batch(q: np.ndarray, *, w_bits: np.ndarray, in_bits,
                     cluster_idx: Optional[np.ndarray] = None,
                     cluster_codebook_q: Optional[np.ndarray] = None,
                     has_cluster: Optional[np.ndarray] = None,
                     relu: bool = True) -> Dict[str, np.ndarray]:
    """Population-vectorized `layer_cost`: price one layer for P candidates
    in one pass. Matches the scalar path exactly (all intermediates are
    integer until the final FA-equivalent scaling).

    q:            (P, d_in, d_out) integer weights (0 = pruned)
    w_bits:       (P,) per-candidate weight bits (or scalar)
    in_bits:      (P,) per-candidate input bits (or scalar)
    cluster_idx:  (P, d_in, d_out) cluster assignments (padded slots unused)
    cluster_codebook_q: (P, d_in, k_max) integer codebooks
    has_cluster:  (P,) bool — candidates priced with multiplier sharing;
                  the rest fall back to dense pricing (mixed populations).
    Returns dict of (P,) arrays: n_multipliers, mult_fa, adder_fa, act_fa,
    total_fa.
    """
    q = np.asarray(q, np.int64)
    P, d_in, d_out = q.shape
    w_bits = np.broadcast_to(np.asarray(w_bits, np.int64), (P,))
    in_bits = np.broadcast_to(np.asarray(in_bits, np.int64), (P,))
    prod_width = in_bits + w_bits                            # (P,)
    active = np.abs(q) > 0                                   # (P,d_in,d_out)

    n_mult = active.sum(axis=(1, 2)).astype(np.int64)
    csd_sum = (_csd_vec(q)).sum(axis=(1, 2))
    if cluster_idx is not None:
        cb = np.asarray(cluster_codebook_q, np.int64)
        sel = _used_clusters(np.asarray(cluster_idx), active, cb.shape[-1])
        sel &= np.abs(cb) > 0                                # (P,d_in,k)
        has = (np.ones(P, bool) if has_cluster is None
               else np.asarray(has_cluster, bool))
        n_mult = np.where(has, sel.sum(axis=(1, 2)), n_mult)
        csd_sum = np.where(has, (_csd_vec(cb) * sel).sum(axis=(1, 2)),
                           csd_sum)
    mult_fa = (csd_sum * prod_width).astype(np.float64) * MULT_ROUTING_FACTOR

    operands = active.sum(axis=1)                            # (P, d_out)
    adder_fa = ((np.maximum(operands - 1, 0) + 1).sum(axis=1)
                * prod_width).astype(np.float64)

    acc_w = prod_width + _ceil_log2(np.maximum(operands.max(axis=1), 2))
    act_fa = (d_out * RELU_FA_EQ * acc_w if relu
              else np.zeros(P, np.float64))

    return {"n_multipliers": n_mult, "mult_fa": mult_fa,
            "adder_fa": adder_fa, "act_fa": np.asarray(act_fa, np.float64),
            "total_fa": mult_fa + adder_fa + act_fa}


def mlp_cost_batch(q_layers: Sequence[np.ndarray], *, w_bits,
                   in_bits=8,
                   clusters: Optional[Sequence] = None) -> Dict[str, np.ndarray]:
    """Price a whole population of compiled MLPs in one vectorized call.

    q_layers:  per layer, (P, d_in, d_out) integer weights
    w_bits:    per layer, (P,) int arrays (or scalars)
    in_bits:   (P,) per-candidate input bits (or a scalar for all)
    clusters:  per layer, None or (idx (P,d_in,d_out), cb (P,d_in,k),
               has_cluster (P,) bool or None)
    Returns dict of (P,) arrays: total_fa, area_mm2, power_mw,
    n_multipliers — candidate i equals `mlp_cost` on its slices exactly.
    """
    if not isinstance(w_bits, (list, tuple)):
        w_bits = [w_bits] * len(q_layers)
    P = np.asarray(q_layers[0]).shape[0]
    total_fa = np.zeros(P, np.float64)
    n_mult = np.zeros(P, np.int64)
    per_layer = []
    for i, q in enumerate(q_layers):
        cl = clusters[i] if clusters is not None else None
        idx, cbq, has = (cl if cl is not None else (None, None, None))
        lc = layer_cost_batch(
            np.asarray(q), w_bits=w_bits[i], in_bits=in_bits,
            cluster_idx=idx, cluster_codebook_q=cbq, has_cluster=has,
            relu=(i < len(q_layers) - 1))
        per_layer.append(lc)
        total_fa += lc["total_fa"]
        n_mult += lc["n_multipliers"]
    d_out = np.asarray(q_layers[-1]).shape[-1]
    last_bits = np.broadcast_to(np.asarray(w_bits[-1], np.int64), (P,))
    in_bits = np.broadcast_to(np.asarray(in_bits, np.int64), (P,))
    argmax_fa = (d_out - 1) * ARGMAX_FA_EQ * (in_bits + last_bits + 4)
    total_fa = total_fa + argmax_fa
    return {"total_fa": total_fa, "area_mm2": total_fa * AREA_FA_MM2,
            "power_mw": total_fa * POWER_FA_MW, "n_multipliers": n_mult,
            "argmax_fa": np.asarray(argmax_fa, np.float64),
            "layers": per_layer}


def mlp_cost(q_layers: Sequence[np.ndarray], *, w_bits, in_bits: int = 8,
             clusters: Optional[Sequence[Optional[Tuple[np.ndarray, np.ndarray]]]] = None
             ) -> CircuitCost:
    """q_layers: integer weights per layer (d_in, d_out). w_bits: int or
    per-layer list. clusters[i]: None or (idx, codebook_q)."""
    if isinstance(w_bits, int):
        w_bits = [w_bits] * len(q_layers)
    costs = []
    for i, q in enumerate(q_layers):
        cl = clusters[i] if clusters is not None else None
        idx, cbq = (cl if cl is not None else (None, None))
        costs.append(layer_cost(
            np.asarray(q), w_bits=int(w_bits[i]), in_bits=in_bits,
            cluster_idx=idx, cluster_codebook_q=cbq,
            relu=(i < len(q_layers) - 1)))
    # argmax over the final layer outputs
    d_out = np.asarray(q_layers[-1]).shape[1]
    acc_w = in_bits + int(w_bits[-1]) + 4
    argmax_fa = (d_out - 1) * ARGMAX_FA_EQ * acc_w
    return CircuitCost(layers=costs, argmax_fa=argmax_fa)
