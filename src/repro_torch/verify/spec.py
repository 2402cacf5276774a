"""Static lint of compression specs (the GA genome) before evaluation.

A `ModelMin` is cheap to build and expensive to evaluate (a QAT finetune +
bespoke compile per spec), and its JSON serialization is a *persistent
cache key* (`batch_eval.EvalCache`). Two classes of silent failure are
worth catching before any training happens:

* **range/arch illegality** — genes outside the lattice the repo's
  semantics support (bits outside [2, 8], more clusters than a layer has
  outputs to cluster, a genome whose layer count does not match the
  dataset's architecture): these either crash mid-finetune or quietly
  degenerate (k-means with k > n points).
* **keyspace instability** — a spec whose serialization does not
  round-trip byte-for-byte (``to_json -> from_json -> to_json``), or that
  smuggles non-canonical scalar types (a ``np.int64`` bits gene) into the
  JSON. Such specs fracture the cache keyspace: the same point evaluates
  twice under two keys, or two different points collide on one.

`lint_spec` returns `Diagnostic` records; `check_specs` raises. The
batched evaluator runs `check_specs` on every population when the ambient
verify flag (`REPRO_VERIFY`) is on.

Run ``python -m repro_torch.verify.spec`` to lint the GA's whole gene
lattice against every printed-MLP dataset (the static-analysis gate).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.compression_spec import LayerMin, ModelMin
from repro_torch.verify.diagnostics import (ERROR, WARN, Diagnostic,
                                      VerificationError, errors)

# the semantic lattice (mirrors LayerMin.validate / ModelMin.validate, but
# reported instead of asserted, and checked *before* any training)
BITS_RANGE = (2, 8)
SPARSITY_RANGE = (0.0, 0.9)
CLUSTERS_RANGE = (2, 64)
CSD_DROP_RANGE = (0, 8)
LSB_RANGE = (0, 16)
ARGMAX_LSB_RANGE = (0, 16)
INPUT_BITS_RANGE = (1, 16)


def _diag(rule: str, msg: str) -> Diagnostic:
    return Diagnostic(ERROR, rule, msg)


def _check_scalar(out, where: str, name: str, v, lo, hi, *,
                  optional: bool = False, kind=int):
    if v is None:
        if not optional:
            out.append(_diag("range", f"{where}: {name} must be set"))
        return
    if type(v) is not kind and not (kind is float and type(v) is int):
        out.append(_diag(
            "type",
            f"{where}: {name}={v!r} has type {type(v).__name__}, not "
            f"{kind.__name__} — non-canonical scalars serialize "
            "differently and fracture the EvalCache keyspace"))
        return
    if not (lo <= v <= hi):
        out.append(_diag("range",
                         f"{where}: {name}={v} outside [{lo}, {hi}]"))


def lint_spec(spec: ModelMin, cfg=None) -> List[Diagnostic]:
    """Lint one spec. ``cfg`` (a `PrintedMLPConfig`), when given, enables
    the architecture rules (layer count, per-layer cluster capacity)."""
    out: List[Diagnostic] = []
    if not isinstance(spec, ModelMin):
        return [_diag("type", f"not a ModelMin: {type(spec).__name__}")]
    if not spec.layers:
        out.append(_diag("range", "spec has no layers"))
    _check_scalar(out, "model", "input_bits", spec.input_bits,
                  *INPUT_BITS_RANGE)
    _check_scalar(out, "model", "argmax_lsb", spec.argmax_lsb,
                  *ARGMAX_LSB_RANGE)
    for i, l in enumerate(spec.layers):
        w = f"layer[{i}]"
        if not isinstance(l, LayerMin):
            out.append(_diag("type", f"{w}: not a LayerMin: "
                             f"{type(l).__name__}"))
            continue
        _check_scalar(out, w, "bits", l.bits, *BITS_RANGE, optional=True)
        _check_scalar(out, w, "sparsity", l.sparsity, *SPARSITY_RANGE,
                      kind=float)
        _check_scalar(out, w, "clusters", l.clusters, *CLUSTERS_RANGE,
                      optional=True)
        _check_scalar(out, w, "csd_drop", l.csd_drop, *CSD_DROP_RANGE)
        _check_scalar(out, w, "lsb", l.lsb, *LSB_RANGE)

    if cfg is not None and not errors(out):
        dims = cfg.layer_dims
        if len(spec.layers) != len(dims) - 1:
            out.append(_diag(
                "arch",
                f"{len(spec.layers)} layer genes for {cfg.name}'s "
                f"{len(dims) - 1} compressible layers {dims}"))
        else:
            for i, l in enumerate(spec.layers):
                if l.clusters is not None and l.clusters > dims[i + 1]:
                    # degenerate, not illegal: the k-means quietly uses
                    # fewer clusters — the GA's fixed lattice does emit
                    # such genes on small output layers
                    out.append(Diagnostic(
                        WARN, "arch",
                        f"layer[{i}]: {l.clusters} clusters but the layer "
                        f"has only {dims[i + 1]} outputs per input row to "
                        "cluster (k-means degenerates to fewer clusters)"))

    if not errors(out):
        try:
            s1 = spec.to_json()
            s2 = ModelMin.from_json(s1).to_json()
        except (TypeError, ValueError, KeyError) as e:
            out.append(_diag("roundtrip",
                             f"serialization failed: {e!r}"))
        else:
            if s1 != s2:
                out.append(_diag(
                    "roundtrip",
                    "to_json -> from_json -> to_json is not byte-stable "
                    f"({s1!r} vs {s2!r}) — EvalCache keys would drift"))
    return out


def lint_specs(specs: Sequence[ModelMin], cfg=None) -> List[Diagnostic]:
    out: List[Diagnostic] = []
    for i, s in enumerate(specs):
        for d in lint_spec(s, cfg):
            out.append(Diagnostic(d.severity, d.rule,
                                  f"spec[{i}]: {d.message}"))
    return out


def check_specs(specs: Sequence[ModelMin], cfg=None) -> None:
    """Raise `VerificationError` if any spec in the population is illegal
    or keyspace-unstable."""
    bad = errors(lint_specs(specs, cfg))
    if bad:
        raise VerificationError(bad)


def _selftest() -> int:
    """Lint the GA's whole gene lattice against every dataset (CI gate):
    every single-axis choice plus a deterministic random sample of
    combined genomes must lint clean and round-trip byte-stably."""
    import itertools
    import random

    from repro_torch.configs.printed_mlp import PRINTED_MLPS
    from repro_torch.core import ga

    rng = random.Random(0)
    n_err = n_specs = 0
    for cfg in PRINTED_MLPS.values():
        L = len(cfg.layer_dims) - 1
        single = [ModelMin.uniform(L, csd_drop=c, lsb=t, argmax_lsb=a)
                  for c, t, a in itertools.product(
                      ga.CSD_DROP_CHOICES, ga.LSB_CHOICES,
                      ga.ARGMAX_LSB_CHOICES)]
        for axis, choices in (("bits", ga.BITS_CHOICES),
                              ("sparsity", ga.SPARSITY_CHOICES),
                              ("clusters", ga.CLUSTER_CHOICES)):
            single += [ModelMin.uniform(L, **{axis: c}) for c in choices]
        combos = [ModelMin(tuple(LayerMin(rng.choice(ga.BITS_CHOICES),
                                          rng.choice(ga.SPARSITY_CHOICES),
                                          rng.choice(ga.CLUSTER_CHOICES),
                                          rng.choice(ga.CSD_DROP_CHOICES),
                                          rng.choice(ga.LSB_CHOICES))
                                 for _ in range(L)),
                           8, rng.choice(ga.ARGMAX_LSB_CHOICES))
                  for _ in range(200)]
        for s in single + combos:
            n_specs += 1
            for d in lint_spec(s, cfg):
                n_err += d.severity == ERROR
                if d.severity == ERROR:
                    print(f"{cfg.name}: {d}")
    print(f"spec lint: {n_specs} specs over {len(PRINTED_MLPS)} datasets, "
          f"{n_err} error(s)")
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(_selftest())
