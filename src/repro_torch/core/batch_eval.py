"""Batched population evaluation — the GA's hot path, in PyTorch.

This module stacks a whole population's genomes into per-layer arrays
(bits, cluster counts, pruning masks) and QAT-finetunes every candidate at
once as explicit batched tensors — weights ``(P, d_in, d_out)``, one
``torch.matmul`` forward, autograd backward, the same hand-written Adam as
`core.minimize` — against the shared pretrained weights. The trained
weights come to the host once per generation; every candidate is compiled
to its bespoke integer netlist, the whole population is scored in ONE
netlist-simulation kernel launch (`repro_torch.kernels.netlist_sim`) and
priced in one vectorized `hw_model.mlp_cost_batch` call.

The per-candidate spec transforms match the serial static-spec path
operation for operation:

* quantization: integer ``qmax`` built by bit shift, same
  scale/round/clip sequence as `quantization.fake_quant`;
* clustering: `clustering.kmeans_rows` over ``K_MAX`` slots with invalid
  slots at +inf distance — the same routine the static-k path runs;
* "off" genes (bits=None / clusters=None / sparsity=0) select the identity
  through ``torch.where`` and multiply by an all-ones mask.

A persistent on-disk `EvalCache` keyed by (dataset, seed, epochs,
spec.to_json()) makes resumed searches and repeated sweeps free.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile
import warnings
from collections import OrderedDict
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import DeviceLike, resolve_device
from repro_torch.configs.printed_mlp import PrintedMLPConfig
from repro_torch.core import clustering as C
from repro_torch.core import hw_model as HW
from repro_torch.core import minimize as MZ
from repro_torch.core.compression_spec import ModelMin
from repro_torch.nn import mlp as M

# Padded k-means slot count: must cover every cluster count the GA can emit
# (core.ga.CLUSTER_CHOICES tops out at 16).
K_MAX = 16


# ---------------------------------------------------------------------------
# evaluation quarantine
# ---------------------------------------------------------------------------

# Worst-case fitness for quarantined specs: finite (inf would poison
# crowding-distance normalization in NSGA-II) but dominated by every real
# candidate, so a quarantined spec can never reach a Pareto front.
QUARANTINE_AREA_MM2 = 1e9
QUARANTINE_POWER_MW = 1e9
QUARANTINE_DELAY_LEVELS = 10 ** 9


@dataclasses.dataclass
class QuarantineRecord:
    """Structured diagnostic for a spec whose evaluation failed.

    A failing candidate (netlist-sim ``OverflowError`` past the 62-bit
    budget, NaN accuracy out of a diverged QAT finetune, any compile
    exception) is retried once and then quarantined with worst-case
    fitness instead of aborting the whole generation — hours of search
    must not die because one genome broke the toolchain.
    """
    spec_json: str
    stage: str              # "compile" | "score"
    error: str              # exception class name
    message: str
    attempts: int


def _worst_case_result(spec: ModelMin) -> MZ.EvalResult:
    return MZ.EvalResult(spec, 0.0, QUARANTINE_AREA_MM2,
                         QUARANTINE_POWER_MW, 0,
                         delay_levels=QUARANTINE_DELAY_LEVELS)


# Fault-injection hook (repro.search.faults): called as hook(spec, attempt)
# at the top of every candidate-evaluation attempt and may raise. None in
# production — the check is a single attribute load.
_EVAL_FAULT_HOOK: Optional[Callable[[ModelMin, int], None]] = None


def set_eval_fault_hook(hook: Optional[Callable[[ModelMin, int], None]]
                        ) -> Optional[Callable]:
    """Install (or clear, with None) the per-candidate fault hook; returns
    the previous hook so callers can restore it."""
    global _EVAL_FAULT_HOOK
    prev, _EVAL_FAULT_HOOK = _EVAL_FAULT_HOOK, hook
    return prev


# ---------------------------------------------------------------------------
# per-candidate spec transforms (bits / cluster counts as tensors)
# ---------------------------------------------------------------------------


def _padded_kmeans_1d(x: torch.Tensor, k: int, k_max: int, iters: int = 25):
    """`clustering._kmeans_1d` over ``k_max`` centroid slots; slots >= k
    are held at +inf distance, so the valid slots equal the static-k run.
    x: (N,) -> (centroids (k_max,), assign (N,) int32)."""
    kk = torch.full((1,), int(k), dtype=torch.int64, device=x.device)
    cent, a = C.kmeans_rows(x.to(torch.float32)[None], kk, k_max, iters)
    return cent[0], a[0]


def _cluster_dyn(w: torch.Tensor, k: torch.Tensor, k_max: int = K_MAX):
    """Per-input cluster STE with a per-candidate k; k == 0 -> identity.
    w: (..., d_in, d_out); k: w.shape[:-2] integer tensor."""
    wd = w.detach()
    d_in, d_out = w.shape[-2:]
    keff = torch.clamp_min(k, 1)
    rows = keff.reshape(-1, 1).expand(-1, d_in).reshape(-1)
    cent, idx = C.kmeans_rows(wd.reshape(-1, d_out), rows, k_max)
    wq = torch.gather(cent, 1, idx.long()).reshape(w.shape)
    on = (k > 0)[..., None, None]
    return w + torch.where(on, wq - wd, torch.zeros_like(wd))


def _quant_dyn(w: torch.Tensor, bits: torch.Tensor):
    """Symmetric per-tensor fake-quant STE with a per-candidate bit width;
    0 -> identity. w: (..., d_in, d_out); bits: w.shape[:-2]. qmax is built
    by integer shift, so it is the exact grid of `quantization.fake_quant`'s
    python-float 2**(b-1)-1."""
    wd = w.detach()
    beff = torch.clamp_min(bits, 2).to(torch.int32)[..., None, None]
    qmax = (torch.bitwise_left_shift(torch.ones_like(beff), beff - 1)
            - 1).to(torch.float32)
    amax = torch.clamp_min(torch.amax(torch.abs(wd), dim=(-2, -1),
                                      keepdim=True), 1e-8)
    scale = amax / qmax
    fq = torch.clamp(torch.round(wd / scale), -qmax, qmax) * scale
    on = (bits > 0)[..., None, None]
    return w + torch.where(on, fq - wd, torch.zeros_like(wd))


# ---------------------------------------------------------------------------
# population stacking
# ---------------------------------------------------------------------------


def stack_specs(specs: Sequence[ModelMin]) -> Tuple[np.ndarray, np.ndarray]:
    """-> (bits (P, L) int32, clusters (P, L) int32); 0 encodes "off"."""
    bits = np.array([[l.bits or 0 for l in s.layers] for s in specs],
                    np.int32)
    ks = np.array([[l.clusters or 0 for l in s.layers] for s in specs],
                  np.int32)
    return bits, ks


def stack_masks(params0, specs: Sequence[ModelMin]):
    """Magnitude masks from the shared pretrained weights, in both layouts
    the engine needs, from ONE memoized computation per distinct
    (layer, sparsity):

    -> (stacked: per layer (P, d_in, d_out) float32 for the vmapped
        finetune (all-ones when a gene's sparsity is 0),
        serial: per spec, per layer numpy bool mask or None — the exact
        convention `compile_bespoke` / `make_masks` use).
    """
    memo: Dict[Tuple[int, float], Optional[np.ndarray]] = {}

    def mask_for(i, layer, sparsity):
        key = (i, float(sparsity))
        if key not in memo:
            memo[key] = (MZ._np(MZ.P.magnitude_mask(layer["w"],
                                                    sparsity)).astype(bool)
                         if sparsity > 0 else None)
        return memo[key]

    layers = params0["layers"]
    serial = [[mask_for(i, layers[i], s.layers[i].sparsity)
               for i in range(len(layers))] for s in specs]
    stacked = [np.stack([np.ones(layers[i]["w"].shape, np.float32)
                         if row[i] is None else row[i].astype(np.float32)
                         for row in serial])
               for i in range(len(layers))]
    return stacked, serial


# ---------------------------------------------------------------------------
# the batched QAT finetune (one batched train loop for the whole population)
# ---------------------------------------------------------------------------


def _population_finetune(params0, bits, ks, masks, x, y, *,
                         epochs: int, lr: float, k_max: int = K_MAX):
    """QAT-finetune P candidates in one batched train loop.

    params0: shared pretrained params (tensors on the training device);
    bits/ks: (P, L) integer tensors; masks: L tensors (P, d_in_i, d_out_i)
    float32; x (B, F) float32, y (B,) int64. Returns params with a leading
    population axis on every leaf.
    """
    P = bits.shape[0]
    pop = {"layers": tuple(
        {"w": l["w"].expand(P, *l["w"].shape).contiguous(),
         "b": l["b"].expand(P, *l["b"].shape).contiguous()}
        for l in params0["layers"])}

    def t(i, w):
        w = w * masks[i]
        w = _cluster_dyn(w, ks[:, i], k_max)
        return _quant_dyn(w, bits[:, i])

    return MZ._train(pop, x, y, epochs=epochs, lr=lr, w_transform=t)


# ---------------------------------------------------------------------------
# persistent evaluation cache
# ---------------------------------------------------------------------------


def _salvage_entries(text: str) -> Dict[str, Dict]:
    """Best-effort recovery of ``"key": {...}`` pairs from a torn cache
    JSON. Walks the top-level object entry by entry (keys embed escaped
    spec JSON, so this uses the real JSON scanner, not a regex) and stops
    at the first undecodable span — every complete leading entry of a
    truncated file survives."""
    out: Dict[str, Dict] = {}
    decoder = json.JSONDecoder()
    i = text.find("{")
    if i < 0:
        return out
    i += 1
    n = len(text)
    while i < n:
        while i < n and text[i] in ", \t\r\n":
            i += 1
        if i >= n or text[i] != '"':
            break
        try:
            key, i = json.decoder.scanstring(text, i + 1)
            while i < n and text[i] in " \t\r\n":
                i += 1
            if i >= n or text[i] != ":":
                break
            i += 1
            while i < n and text[i] in " \t\r\n":
                i += 1
            val, i = decoder.raw_decode(text, i)
        except (ValueError, IndexError):
            break
        if isinstance(val, dict):
            out[key] = val
    return out


class EvalCache:
    """On-disk cache of spec evaluations with a bounded footprint.

    Same file format and keys as `repro.core.batch_eval.EvalCache`; the
    port's callers give it a file of its own (``{dataset}_torch_evals.json``)
    so float drift between the packages never mixes their entries.

    One JSON file, atomically replaced on flush; keys are
    "dataset|seed=S|epochs=E|spec.to_json()" (suffixed "|netlist" for
    netlist-exact evaluations — a different objective, never mixed with
    analytic entries; approximated specs carry their genes in the spec
    JSON and always live in the netlist keyspace) so resumed searches,
    repeated sweeps and the serial/batched paths all share results.
    ``flush`` re-reads and merges the on-disk file first, so concurrent
    sweep processes sharing a cache file union their entries instead of
    clobbering each other.

    ``max_entries`` caps the cache: every get/put stamps the entry with a
    monotonic access counter, and flush evicts the least-recently-used
    entries beyond the cap — a month of GA sweeps can't grow the file
    without bound. Entries written by pre-cap versions carry no stamp and
    are evicted first. A flush with no new entries and few refreshed
    stamps is a cheap no-op (recency persistence is batched every
    ``TOUCH_FLUSH_EVERY`` hits), so warm fully-cached sweeps don't rewrite
    a multi-MB JSON per generation.
    """

    TOUCH_FLUSH_EVERY = 64

    def __init__(self, path, max_entries: Optional[int] = 100_000):
        self.path = Path(path)
        self.max_entries = max_entries
        self._data: Dict[str, Dict] = self._read()
        self._clock = max((int(e.get("t", 0))
                           for e in self._data.values()), default=0)
        self._dirty = False           # un-persisted put()s
        self._touched = 0             # un-persisted recency stamps

    def _touch(self, entry: Dict) -> Dict:
        self._clock += 1
        entry["t"] = self._clock
        return entry

    def _read(self) -> Dict[str, Dict]:
        if not self.path.exists():
            return {}
        try:
            text = self.path.read_text()
        except OSError as e:
            # unreadable file must not kill a long search — start empty;
            # the next flush atomically replaces it
            warnings.warn(f"EvalCache {self.path} unreadable ({e}); "
                          "starting empty")
            return {}
        try:
            return json.loads(text)
        except json.JSONDecodeError as e:
            # torn/truncated file (crash mid-write on a non-atomic fs,
            # disk-full, fault injection): keep the damaged bytes for the
            # post-mortem and salvage every individually-parseable entry —
            # a multi-day cache must not be discarded over a torn tail
            data = _salvage_entries(text)
            backup = self.path.with_suffix(self.path.suffix + ".corrupt")
            try:
                backup.write_text(text)
            except OSError:
                pass                       # salvage still proceeds
            warnings.warn(f"EvalCache {self.path} corrupt ({e}); salvaged "
                          f"{len(data)} entries, damaged file backed up "
                          f"to {backup}")
            return data

    @staticmethod
    def key(dataset: str, seed: int, epochs: int, spec: ModelMin,
            netlist: bool = False) -> str:
        base = f"{dataset}|seed={seed}|epochs={epochs}|{spec.to_json()}"
        return base + "|netlist" if netlist else base

    def __len__(self):
        return len(self._data)

    def get(self, dataset: str, seed: int, epochs: int, spec: ModelMin,
            netlist: bool = False) -> Optional[MZ.EvalResult]:
        d = self._data.get(self.key(dataset, seed, epochs, spec, netlist))
        if d is None:
            return None
        self._touch(d)                  # LRU: a hit keeps the entry young
        self._touched += 1
        return MZ.EvalResult(ModelMin.from_json(d["spec"]), d["accuracy"],
                             d["area_mm2"], d["power_mw"],
                             d["n_multipliers"],
                             delay_levels=d.get("delay_levels"))

    def put(self, dataset: str, seed: int, epochs: int,
            r: MZ.EvalResult, netlist: bool = False) -> None:
        self._data[self.key(dataset, seed, epochs, r.spec, netlist)] = \
            self._touch({
                "spec": r.spec.to_json(), "accuracy": float(r.accuracy),
                "area_mm2": float(r.area_mm2), "power_mw": float(r.power_mw),
                "n_multipliers": int(r.n_multipliers),
                "delay_levels": (None if r.delay_levels is None
                                 else int(r.delay_levels))})
        self._dirty = True

    def flush(self) -> None:
        # nothing new and too few refreshed stamps to be worth a full
        # re-read/merge/rewrite: skip (recency persistence is best-effort)
        if not self._dirty and self._touched < self.TOUCH_FLUSH_EVERY:
            return
        self._flush_locked()

    def _flush_locked(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        # merge concurrent writers under an flock'd sidecar: entries
        # flushed by another process since our last read survive; on a key
        # conflict ours wins (we hold the fresher evaluation of that
        # spec). The lock serializes read-merge-replace so simultaneous
        # flushes cannot interleave and drop each other's entries.
        with open(self.path.with_suffix(self.path.suffix + ".lock"),
                  "w") as lock:
            try:
                import fcntl
                fcntl.flock(lock, fcntl.LOCK_EX)
            except ImportError:       # non-POSIX: merge without the lock
                pass
            disk = self._read()
            if disk:
                disk.update(self._data)
                self._data = disk
            if (self.max_entries is not None
                    and len(self._data) > self.max_entries):
                # LRU-ish eviction: keep the most recently stamped entries
                keep = sorted(self._data.items(),
                              key=lambda kv: int(kv[1].get("t", 0)),
                              reverse=True)[:self.max_entries]
                self._data = dict(keep)
            fd, tmp = tempfile.mkstemp(dir=str(self.path.parent),
                                       prefix=self.path.name + ".")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(self._data, f)
                os.replace(tmp, self.path)    # atomic publish
                self._dirty = False
                self._touched = 0
            except BaseException:
                os.unlink(tmp)
                raise


# ---------------------------------------------------------------------------
# population evaluation
# ---------------------------------------------------------------------------

# Per-spec packed node tables for the population netlist-sim engine, keyed
# alongside the EvalCache keyspace (EvalCache.key(..., netlist=True) +
# "|pack"): a netlist is a deterministic function of (dataset, seed,
# epochs, spec) in-process, so a GA revisiting a genome whose EvalResult
# was invalidated (or uncached) never re-lays-out its node tables.
# Process-local, LRU-capped (mirroring EvalCache's max_entries): a
# service-style run cycling through many datasets/specs keeps its working
# set and evicts the least-recently-hit tables — entries are a few dense
# KB each.
_PACK_CACHE: "OrderedDict[str, object]" = OrderedDict()
_PACK_CACHE_CAP = 2048


def _packed_netlist_for(key: Optional[str], net, NS):
    if key is not None and key in _PACK_CACHE:
        _PACK_CACHE.move_to_end(key)
        return _PACK_CACHE[key]
    packed = NS.pack_netlist(net)
    if key is not None:
        while len(_PACK_CACHE) >= _PACK_CACHE_CAP:
            _PACK_CACHE.popitem(last=False)
        _PACK_CACHE[key] = packed
    return packed


def _compile_and_price(params_pop, specs, masks_serial, xte, yte, *,
                       netlist: bool = True,
                       quarantine: Optional[List[QuarantineRecord]] = None,
                       pack_key: Optional[Callable[[ModelMin], str]] = None,
                       device: DeviceLike = None) -> List[MZ.EvalResult]:
    """Host-side bespoke compile per candidate + one vectorized pricing
    call for the whole population. ``params_pop``: numpy params with a
    leading population axis. Every candidate is lowered to its bespoke
    netlist (`repro_torch.circuit`) for the critical-path delay; with
    ``netlist=True`` (the default objective) the accuracy is the
    netlist-exact simulation of the printed datapath, all candidates in ONE
    `netlist_sim` launch on ``device``; per-candidate node tables are cached
    under ``pack_key(spec)``, so a GA revisiting genomes repacks nothing.

    Per-candidate fault isolation: a candidate whose compile/score raises
    (or whose accuracy comes back NaN) is retried once and then quarantined
    with worst-case fitness and a :class:`QuarantineRecord` appended to
    ``quarantine``. If the batched launch itself faults, every candidate is
    scored on its own under the same retry-once-then-quarantine contract.
    """
    from repro_torch import circuit as CIRC            # lazy: imports us
    from repro_torch.kernels import netlist_sim as NS

    full: Dict[int, MZ.EvalResult] = {}   # quarantined
    compiled: Dict[int, MZ.CompiledMLP] = {}
    nets: Dict[int, object] = {}          # netlist-exact scoring, deferred
    accs: Dict[int, float] = {}
    delays: Dict[int, int] = {}

    def quarantine_(p: int, stage: str, err: BaseException) -> None:
        rec = QuarantineRecord(specs[p].to_json(), stage, type(err).__name__,
                               str(err), attempts=2)
        if quarantine is not None:
            quarantine.append(rec)
        else:
            warnings.warn(f"spec quarantined ({rec.stage}: {rec.error}: "
                          f"{rec.message}); worst-case fitness assigned")
        full[p] = _worst_case_result(specs[p])

    for p, spec in enumerate(specs):
        err: Optional[BaseException] = None
        stage = "compile"
        for attempt in (1, 2):
            try:
                if _EVAL_FAULT_HOOK is not None:
                    _EVAL_FAULT_HOOK(spec, attempt)
                stage = "compile"
                params_p = {"layers": tuple(
                    {k: l[k][p] for k in ("w", "b")}
                    for l in params_pop["layers"])}
                c = MZ.compile_bespoke(params_p, spec, masks_serial[p])
                net = CIRC.compile_netlist(c)
                stage = "score"
                if netlist:
                    # accuracy deferred: every candidate joins ONE packed
                    # population launch after this loop (an integer argmax
                    # cannot come back NaN)
                    nets[p] = net
                else:
                    acc = MZ.compiled_accuracy(c, xte, yte)
                    if math.isnan(float(acc)):
                        raise FloatingPointError(
                            "NaN accuracy out of compiled forward "
                            "(diverged QAT finetune?)")
                    accs[p] = float(acc)
                compiled[p] = c
                delays[p] = net.critical_path_levels()
                err = None
                break
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:
                err = e
        if err is not None:
            quarantine_(p, stage, err)

    if nets:
        todo_p = sorted(nets)
        try:
            packs = [_packed_netlist_for(
                pack_key(specs[p]) if pack_key else None, nets[p], NS)
                for p in todo_p]
            xq = np.stack([np.asarray(
                MZ.quantize_inputs(compiled[p], xte), np.int64)
                for p in todo_p])
            pop_acc = NS.population_accuracy(NS.pack_population(packs),
                                             xq, yte, device=device)
            for j, p in enumerate(todo_p):
                accs[p] = float(pop_acc[j])
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException:
            for p in todo_p:
                err2: Optional[BaseException] = None
                for _attempt in (1, 2):
                    try:
                        accs[p] = float(CIRC.netlist_accuracy(
                            nets[p], compiled[p], xte, yte, device=device))
                        err2 = None
                        break
                    except (KeyboardInterrupt, SystemExit):
                        raise
                    except BaseException as e:
                        err2 = e
                if err2 is not None:
                    quarantine_(p, "score", err2)
                    del compiled[p]

    # stack per-layer integer weights / codebooks and price the whole
    # population in one hw_model call (pad codebooks to the layer's max k)
    ok = sorted(compiled)
    cost = None
    if ok:
        comp = [compiled[p] for p in ok]
        L = len(comp[0].q_layers)
        q_layers, w_bits, clusters = [], [], []
        for i in range(L):
            q_layers.append(np.stack([c.q_layers[i] for c in comp]))
            w_bits.append(np.array([c.w_bits[i] for c in comp], np.int64))
            has = np.array([c.clusters[i] is not None for c in comp])
            if has.any():
                kmax = max(c.clusters[i][1].shape[1]
                           for c in comp if c.clusters[i] is not None)
                d_in, d_out = comp[0].q_layers[i].shape
                idx = np.zeros((len(comp), d_in, d_out), np.int64)
                cb = np.zeros((len(comp), d_in, kmax), np.int64)
                for p, c in enumerate(comp):
                    if c.clusters[i] is not None:
                        ci, cc = c.clusters[i]
                        idx[p] = ci
                        cb[p, :, :cc.shape[1]] = cc
                clusters.append((idx, cb, has))
            else:
                clusters.append(None)
        in_bits = np.array([c.input_bits for c in comp], np.int64)
        cost = HW.mlp_cost_batch(q_layers, w_bits=w_bits, in_bits=in_bits,
                                 clusters=clusters)

    pos = {p: j for j, p in enumerate(ok)}
    return [full[p] if p in full
            else MZ.EvalResult(spec, accs[p],
                               float(cost["area_mm2"][pos[p]]),
                               float(cost["power_mw"][pos[p]]),
                               int(cost["n_multipliers"][pos[p]]),
                               delay_levels=delays[p])
            for p, spec in enumerate(specs)]


def evaluate_population(cfg: PrintedMLPConfig, specs: Sequence[ModelMin], *,
                        epochs: int = 150, seed: int = 0,
                        cache: Optional[EvalCache] = None,
                        netlist: bool = True,
                        quarantine: Optional[List[QuarantineRecord]] = None,
                        device: DeviceLike = None) -> List[MZ.EvalResult]:
    """Evaluate a population of specs with ONE batched QAT finetune on
    ``device`` (CUDA unless ``"cpu"``), ONE netlist-simulation launch and
    ONE vectorized pricing pass. Order-preserving; duplicates and cache hits
    are evaluated once. Drop-in for ``[evaluate_spec(cfg, s) for s in
    specs]``; ``netlist=False`` scores the float emulation instead.

    A candidate whose compile/score fails is retried once, then quarantined
    with worst-case fitness (never cached) and a :class:`QuarantineRecord`
    appended to ``quarantine``. Specs with approximation genes need
    `repro.approx`, which is not ported yet, and raise.
    """
    specs = list(specs)
    dev = resolve_device(device)
    if any(s.has_approx for s in specs):
        raise NotImplementedError(
            "approximation genes are not supported by repro_torch yet")
    results: Dict[str, MZ.EvalResult] = {}
    todo: List[ModelMin] = []
    queued = set()
    n_hits = 0
    for s in specs:
        k = s.to_json()
        if k in results or k in queued:
            continue
        hit = cache.get(cfg.name, seed, epochs, s, netlist=netlist) \
            if cache else None
        n_hits += hit is not None
        if hit is not None and hit.delay_levels is not None:
            results[k] = hit
        else:
            todo.append(s)
            queued.add(k)

    if todo:
        params0, (xtr, ytr, xte, yte) = MZ.pretrain(cfg, seed=seed,
                                                    device=dev)
        bits, ks = stack_specs(todo)
        stacked, masks_serial = stack_masks(params0, todo)
        trained = _population_finetune(
            params0, torch.as_tensor(bits, device=dev),
            torch.as_tensor(ks, device=dev),
            [torch.as_tensor(m, device=dev) for m in stacked],
            *MZ._tensors(xtr, ytr, dev), epochs=epochs, lr=2e-3)
        trained = M.params_to_numpy(trained)    # one host copy per leaf
        recs: List[QuarantineRecord] = []

        def pack_key(s: ModelMin) -> str:
            return EvalCache.key(cfg.name, seed, epochs, s,
                                 netlist=True) + "|pack"

        priced = _compile_and_price(trained, todo, masks_serial, xte, yte,
                                    netlist=netlist, quarantine=recs,
                                    pack_key=pack_key, device=dev)
        for r in priced:
            results[r.spec.to_json()] = r
            if cache is not None and \
                    all(q.spec_json != r.spec.to_json() for q in recs):
                cache.put(cfg.name, seed, epochs, r, netlist=netlist)
        if recs:
            if quarantine is not None:
                quarantine.extend(recs)
            else:
                warnings.warn(f"{len(recs)} spec(s) quarantined with "
                              "worst-case fitness; pass quarantine=[] to "
                              "collect the structured records")

    # flush on hits too: a get() refreshes the entry's LRU stamp
    if cache is not None and (todo or n_hits):
        cache.flush()

    return [results[s.to_json()] for s in specs]


def make_batch_evaluator(cfg: PrintedMLPConfig, *, epochs: int = 150,
                         seed: int = 0,
                         cache: Optional[EvalCache] = None,
                         netlist: bool = True,
                         include_delay: bool = False,
                         record: Optional[Dict[str, MZ.EvalResult]] = None,
                         quarantine: Optional[List[QuarantineRecord]]
                         = None,
                         device: DeviceLike = None):
    """GA adapter: List[ModelMin] -> List[(1 - accuracy, area_mm2[,
    delay_levels])]. Plug into `run_nsga2(..., batch_evaluate=...)`.

    The accuracy objective is netlist-exact by default (the simulated
    printed datapath, batched through `repro_torch.kernels.netlist_sim`);
    ``netlist=False`` opts out to the analytic float emulation.
    ``include_delay=True`` adds the compiled
    circuit's critical path as a third minimized objective. ``record``, if
    given, collects every EvalResult by spec json — callers (fig2, the
    example) read Pareto-front delay out of it without re-evaluating.
    ``quarantine``, if given, collects
    the `QuarantineRecord`s of failing specs — share the list with
    `run_nsga2(quarantine=...)` / the island runtime so quarantined specs
    surface on the final result.
    """
    def batch_evaluate(specs: Sequence[ModelMin]):
        rs = evaluate_population(cfg, specs, epochs=epochs, seed=seed,
                                 cache=cache, netlist=netlist,
                                 quarantine=quarantine, device=device)
        if record is not None:
            record.update((r.spec.to_json(), r) for r in rs)
        if include_delay:
            return [(1.0 - r.accuracy, r.area_mm2, float(r.delay_levels))
                    for r in rs]
        return [(1.0 - r.accuracy, r.area_mm2) for r in rs]
    return batch_evaluate
