"""Lower a compiled (quantized + pruned + clustered) MLP to a bespoke
netlist.

The lowering is the published bespoke recipe (Mubarik MICRO'20; Armeniakos
DATE'22) made explicit, one node at a time:

* **CSD multipliers** — each non-zero integer coefficient becomes a
  shift-add network over the canonical signed-digit recoding
  (`hw_model.csd_digits`, the same Avizienis recurrence the analytic model
  counts): one SHL wire per non-zero digit, digit-1 ADD/SUB gates, at most
  one NEG when every digit is negative. A power-of-two coefficient is pure
  wiring.
* **Pruning-mask elision** — a zero coefficient lowers to *nothing*: no
  product node, no adder-tree operand. The mask is realized by absence.
* **Cluster fan-out sharing** — with per-input clustering, one product
  subnet is built per (input row, distinct non-zero cluster actually
  referenced by a surviving weight); every weight in the row that maps to
  that cluster taps the shared root. This is exactly the `_used_clusters`
  selection `hw_model` prices.
* **Adder trees** — per neuron, a balanced binary ADD tree over its
  surviving products, then one bias ADD against the hardwired integer bias
  (`minimize.integer_biases`). A fully-pruned neuron keeps its bias add
  (the accumulator register is printed regardless), matching the analytic
  `max(operands-1, 0) + 1` count.
* **ReLU** per hidden neuron, **ARGMAX** comparator tree over the logits.

The netlist's integer semantics equal `minimize.integer_forward` exactly
(tested bit-for-bit); its structural cost equals `hw_model.mlp_cost`
layer-by-layer (tested count-for-count).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import hw_model as HW
from repro_torch.core import minimize as MZ
from repro_torch.circuit import ir


def _lower_const_mult(net: ir.Netlist, x: int, coeff: int, *, layer: int,
                      unit: Tuple[int, ...]) -> int:
    """One bespoke constant multiplier: x * coeff as a CSD shift-add
    network. Returns the product root node id. coeff must be non-zero."""
    assert coeff != 0
    digits = HW.csd_digits(int(coeff))
    # lead with a positive digit when one exists so the chain starts as a
    # plain shift; an all-negative recoding (e.g. -5 -> -4 -1) needs one NEG
    lead = next((i for i, (_, s) in enumerate(digits) if s > 0), 0)
    digits = [digits[lead]] + digits[:lead] + digits[lead + 1:]
    tags = dict(role=ir.ROLE_MULT, layer=layer, unit=unit)
    p0, s0 = digits[0]
    node = net.shl(x, p0, **tags)
    if s0 < 0:
        node = net.neg(node, **tags)
    for p, s in digits[1:]:
        term = net.shl(x, p, **tags)
        node = (net.add(node, term, **tags) if s > 0
                else net.sub(node, term, **tags))
    net.nodes[node].product_root = True
    return node


def _tree_sum(net: ir.Netlist, terms: List[int], *, layer: int,
              unit: Tuple[int, ...]) -> Optional[int]:
    """Balanced binary adder tree over ``terms`` (operands - 1 ADDs)."""
    if not terms:
        return None
    tags = dict(role=ir.ROLE_TREE, layer=layer, unit=unit)
    while len(terms) > 1:
        nxt = [net.add(a, b, **tags)
               for a, b in zip(terms[::2], terms[1::2])]
        if len(terms) % 2:
            nxt.append(terms[-1])
        terms = nxt
    return terms[0]


def _lower_layer(net: ir.Netlist, acts: List[int], q: np.ndarray,
                 b_int: np.ndarray,
                 cluster: Optional[Tuple[np.ndarray, np.ndarray]], *,
                 layer: int, relu: bool) -> Tuple[List[int], List[int]]:
    """Lower one dense layer. Returns (activation node ids, pre node ids)."""
    q = np.asarray(q, np.int64)
    d_in, d_out = q.shape
    active = q != 0

    # ---- products: one subnet per active weight, or one per used
    # non-zero cluster with fan-out sharing --------------------------------
    if cluster is not None:
        idx, cb = np.asarray(cluster[0]), np.asarray(cluster[1], np.int64)
        shared: dict = {}
        for j in range(d_in):
            used = np.unique(idx[j][active[j]])
            for m in used:
                if cb[j, m] != 0:
                    shared[(j, int(m))] = _lower_const_mult(
                        net, acts[j], int(cb[j, m]), layer=layer,
                        unit=(j, int(m)))

        def product(j: int, k: int) -> int:
            return shared[(j, int(idx[j, k]))]
    else:
        def product(j: int, k: int) -> int:
            return _lower_const_mult(net, acts[j], int(q[j, k]),
                                     layer=layer, unit=(j, k))

    # ---- per-neuron adder tree + bias add --------------------------------
    pres: List[int] = []
    for k in range(d_out):
        terms = [product(j, k) for j in range(d_in) if active[j, k]]
        root = _tree_sum(net, terms, layer=layer, unit=(k,))
        if root is None:
            root = net.const(0)            # fully-pruned neuron: bias only
        bias = net.const(int(b_int[k]))
        pres.append(net.add(root, bias, role=ir.ROLE_BIAS, layer=layer,
                            unit=(k,)))
    net.layer_pre_ids.append(pres)

    if not relu:
        return pres, pres
    outs = [net.relu(p, role=ir.ROLE_RELU, layer=layer, unit=(k,))
            for k, p in enumerate(pres)]
    return outs, pres


def compile_netlist(c: "MZ.CompiledMLP") -> ir.Netlist:
    """CompiledMLP (integer weights + codebooks + scales from the QAT
    compile) -> bespoke netlist. The returned netlist is validated: args
    in topo order, every width <= 62 bits (exact int64 simulation)."""
    net = ir.Netlist(in_bits=c.input_bits, w_bits=c.w_bits)
    acts = [net.input(j) for j in range(c.q_layers[0].shape[0])]
    b_ints = MZ.integer_biases(c)
    n_layers = len(c.q_layers)
    for i, (q, b) in enumerate(zip(c.q_layers, b_ints)):
        acts, _ = _lower_layer(net, acts, q, b, c.clusters[i], layer=i,
                               relu=(i < n_layers - 1))
    net.output_ids = list(net.layer_pre_ids[-1])
    net.argmax(net.output_ids)
    net.validate()
    from repro_torch.verify.diagnostics import verify_enabled
    if verify_enabled():
        # the compiler's own output contract, beyond structural soundness:
        # microarchitectural conventions hold (strict), the netlist is
        # exact (no TRUNC, no error annotations) and fully live
        from repro_torch.verify.netlist import check_netlist
        check_netlist(net, strict=True, expect_exact=True, expect_dce=True)
    return net


def compile_spec(cfg, spec, *, epochs: int = 150, seed: int = 0,
                 device=None) -> Tuple[ir.Netlist, "MZ.CompiledMLP"]:
    """Convenience end-to-end path: pretrain (cached) -> QAT finetune under
    ``spec`` -> bespoke compile -> netlist. Training runs on ``device``
    (CUDA unless the caller passes ``"cpu"``)."""
    params0, (xtr, ytr, _, _) = MZ.pretrain(cfg, seed=seed, device=device)
    masks = MZ.make_masks(params0, spec)
    params = MZ.qat_finetune(params0, spec, masks, xtr, ytr, epochs=epochs,
                             device=device)
    compiled = MZ.compile_bespoke(params, spec, masks)
    return compile_netlist(compiled), compiled
