"""Render a run summary from a trace JSONL.

A copy of `repro.obs.report`: both packages write the same records under
the same names, so either report reads either package's trace, and a
trace renders to the same text in both. One addition: where dispatch spans
carry ``device_ms`` (the port's CUDA-event time of a dispatch on the
card), the executables table gains a ``dev_ms`` column; traces without it
render exactly as the reference renders them.

``python -m repro_torch.obs.report <trace.jsonl> [--csv PREFIX]``
reconstructs, from the structured records `repro_torch.obs.trace` wrote
during a search:

* **wall-clock by span** — per span name: calls, total seconds, share,
  and the first-call (jit-compile) vs steady-state split;
* **per-island generation timeline** — every ``island.generation`` span
  grouped by island, with ejections/kills inlined from the ledger;
* **Pareto progress** — a hypervolume proxy per generation from the
  ``ga.front`` events (exact 2-objective hypervolume against a reference
  point derived from the run's own worst front corner; a product proxy
  for 3+ objectives);
* **cache-hit-rate curve** — per fleet round from ``fleet.fit`` events
  (memo hits) and per evaluation batch from ``eval.batch`` (EvalCache
  hits);
* **executables** — the executable observatory rebuilt post-hoc from
  ``prof.executable`` / ``prof.compile`` events and the ``key`` attrs on
  dispatch spans: per static-shape key, dispatch counts, compile
  events/seconds (recompiles are keys compiling more than once),
  FLOPs/bytes from the captured cost analysis — with top-N cuts by
  compile time, FLOPs and dispatch count;
* **padding waste** — packing efficiency of the bucketed executables
  from ``netlist_sim.padding`` / ``eval.padding`` events: real vs padded
  lanes/rows/slots and the waste share each bucket family pays for
  executable reuse;
* **recompiles per generation** — backend-compile events bucketed into
  the ``island.generation`` span intervals, making a recompile storm in
  a warm search visible at a glance;
* **fault/quarantine ledger** — the complete chronological stream of
  ejections, kills, migrations, quarantines, preemptions, checkpoint
  writes and cache salvages (the in-memory rings keep only a tail; the
  trace keeps everything).

``--csv PREFIX`` additionally writes ``PREFIX.spans.csv``,
``PREFIX.generations.csv``, ``PREFIX.cache.csv``, ``PREFIX.ledger.csv``,
``PREFIX.executables.csv`` and ``PREFIX.padding.csv`` for downstream
tooling. Rendering is deterministic for a given trace file, so a
committed trace has a golden report (tested).
"""
from __future__ import annotations

import argparse
import csv
import sys
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.trace import read_trace

# events rendered into the fault/quarantine ledger, in stream order
# (runtime.checkpoint / runtime.resume are *spans* and join the ledger
# from the span stream with their durations)
LEDGER_EVENTS = ("fleet.straggler_ejected", "fleet.killed",
                 "fleet.all_straggle_waived", "fleet.migration",
                 "eval.quarantine", "runtime.preempt", "cache.salvage")


def _attrs(rec: Dict[str, Any]) -> Dict[str, Any]:
    return rec.get("attrs") or {}


# ---------------------------------------------------------------------------
# aggregation
# ---------------------------------------------------------------------------


def span_table(records: Sequence[Dict]) -> List[Dict]:
    """Per span name: calls, total/compile/steady seconds, errors."""
    agg: Dict[str, Dict] = defaultdict(
        lambda: {"calls": 0, "total_s": 0.0, "compile_s": 0.0,
                 "steady_s": 0.0, "errors": 0})
    for r in records:
        if r.get("kind") != "span":
            continue
        a = agg[r["name"]]
        a["calls"] += 1
        dur = float(r.get("dur", 0.0))
        a["total_s"] += dur
        if _attrs(r).get("first"):
            a["compile_s"] += dur
        else:
            a["steady_s"] += dur
        if "error" in r:
            a["errors"] += 1
    rows = [{"name": k, **v} for k, v in agg.items()]
    rows.sort(key=lambda r: (-r["total_s"], r["name"]))
    return rows


def island_timelines(records: Sequence[Dict]) -> Dict[int, List[Dict]]:
    """island -> chronological [{round, generation, dur, error?}]."""
    out: Dict[int, List[Dict]] = defaultdict(list)
    for r in records:
        if r.get("kind") == "span" and r["name"] == "island.generation":
            a = _attrs(r)
            if "island" not in a:
                continue
            out[int(a["island"])].append({
                "round": a.get("round"), "generation": a.get("generation"),
                "ts": r.get("ts"), "dur": float(r.get("dur", 0.0)),
                "error": r.get("error")})
    for isl in out.values():
        isl.sort(key=lambda e: (e["ts"] if e["ts"] is not None else 0.0))
    return dict(sorted(out.items()))


def _hv_2d(points: Sequence[Sequence[float]],
           ref: Sequence[float]) -> float:
    """Exact 2-objective (minimization) hypervolume against ``ref``."""
    pts = sorted({(float(p[0]), float(p[1])) for p in points
                  if p[0] < ref[0] and p[1] < ref[1]})
    hv, prev_y = 0.0, float(ref[1])
    for x, y in pts:                        # x ascending
        if y < prev_y:
            hv += (ref[0] - x) * (prev_y - y)
            prev_y = y
    return hv


def hypervolume_progress(records: Sequence[Dict]) -> List[Dict]:
    """Per ``ga.front`` event: a hypervolume proxy over the recorded first
    front, against a reference point 5% beyond the run's own worst corner
    (so the proxy is comparable within a run, monotone as fronts improve)."""
    fronts = []
    for r in records:
        if r.get("kind") == "event" and r["name"] == "ga.front":
            a = _attrs(r)
            if a.get("front"):
                fronts.append((r.get("ts", 0.0), a))
    if not fronts:
        return []
    k = len(fronts[0][1]["front"][0])
    ref = [1.05 * max(max(float(p[j]) for p in a["front"])
                      for _, a in fronts) + 1e-9 for j in range(k)]
    out = []
    for ts, a in fronts:
        pts = a["front"]
        if k == 2:
            hv = _hv_2d(pts, ref)
        else:                               # 3+ objectives: product proxy
            hv = 1.0
            for j in range(k):
                hv *= max(ref[j] - min(float(p[j]) for p in pts), 0.0)
        out.append({"ts": ts, "island": a.get("island"),
                    "round": a.get("round"),
                    "generation": a.get("generation"),
                    "front_size": len(pts), "hv_proxy": hv,
                    "best_acc": a.get("best_acc"),
                    "min_cost": a.get("min_cost")})
    return out


def cache_curve(records: Sequence[Dict]) -> List[Dict]:
    """Hit-rate per fleet round (memo) and per eval batch (EvalCache)."""
    per_round: Dict[int, Dict[str, int]] = defaultdict(
        lambda: {"requested": 0, "memoized": 0, "fitted": 0})
    batches: List[Dict] = []
    for r in records:
        if r.get("kind") != "event":
            continue
        a = _attrs(r)
        if r["name"] == "fleet.fit" and "round" in a:
            d = per_round[int(a["round"])]
            d["requested"] += int(a.get("requested", 0))
            d["memoized"] += int(a.get("memoized", 0))
            d["fitted"] += int(a.get("fitted", 0))
        elif r["name"] == "eval.batch":
            batches.append({"ts": r.get("ts"),
                            "requested": int(a.get("requested", 0)),
                            "hits": int(a.get("hits", 0)),
                            "evaluated": int(a.get("evaluated", 0))})
    rounds = [{"round": k, **v,
               "hit_rate": (v["memoized"] / v["requested"]
                            if v["requested"] else 0.0)}
              for k, v in sorted(per_round.items())]
    return rounds + [{"batch": i, **b,
                      "hit_rate": (b["hits"] / b["requested"]
                                   if b["requested"] else 0.0)}
                     for i, b in enumerate(batches)]


_EXEC_CAPTURE_FIELDS = ("signature", "flops", "bytes_accessed",
                        "generated_code_size_in_bytes",
                        "argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes")


def executables(records: Sequence[Dict]) -> List[Dict]:
    """Rebuild the executable registry from the trace: ``prof.executable``
    events carry the first-compile capture, ``prof.compile`` events the
    backend-compile accounting, and dispatch spans (any span with a
    ``key`` attr) the per-key dispatch count and wall-clock. Compiles
    with no in-flight dispatch aggregate under key ``(unattributed)``."""
    ex: Dict[str, Dict] = {}

    def rec(key: str, site: Optional[str] = None) -> Dict:
        r = ex.get(key)
        if r is None:
            r = ex[key] = {"key": key, "site": site or "", "dispatches": 0,
                           "total_s": 0.0, "compiles": 0, "compile_s": 0.0,
                           "aot_compiles": 0, "aot_compile_s": 0.0}
        if site and not r["site"]:
            r["site"] = site
        return r

    for r in records:
        a = _attrs(r)
        if r.get("kind") == "span" and "key" in a:
            e = rec(a["key"], r["name"])
            e["dispatches"] += 1
            e["total_s"] += float(r.get("dur", 0.0))
            if "device_ms" in a:
                e["device_ms"] = e.get("device_ms", 0.0) + float(
                    a["device_ms"])
        elif r.get("kind") != "event":
            continue
        elif r["name"] == "prof.compile":
            e = rec(a.get("key") or "(unattributed)", a.get("site"))
            pre = "aot_" if a.get("aot") else ""
            e[pre + "compiles"] += 1
            e[pre + "compile_s"] += float(a.get("seconds", 0.0))
        elif r["name"] == "prof.executable":
            e = rec(a["key"], a.get("site"))
            for f in _EXEC_CAPTURE_FIELDS:
                if f in a:
                    e[f] = a[f]
    rows = sorted(ex.values(),
                  key=lambda e: (-e["compile_s"], -e["dispatches"],
                                 e["key"]))
    return rows


def padding_table(records: Sequence[Dict]) -> List[Dict]:
    """Aggregate padding-waste accounting per bucket family: the netlist
    engines' NOP lanes / repeated candidates / repeated batch rows
    (``netlist_sim.padding``) and the QAT evaluator's population-bucket
    slack (``eval.padding``)."""
    agg: Dict[Tuple[str, str], Dict] = {}
    for r in records:
        if r.get("kind") != "event":
            continue
        a = _attrs(r)
        if r["name"] == "netlist_sim.padding":
            k = ("netlist_sim." + str(a.get("engine")), "lanes")
            d = agg.setdefault(k, {"launches": 0, "used": 0, "total": 0})
            d["launches"] += 1
            d["used"] += int(a.get("lanes_used", 0))
            d["total"] += int(a.get("lanes_total", 0))
            k2 = ("netlist_sim." + str(a.get("engine")), "rows")
            d2 = agg.setdefault(k2, {"launches": 0, "used": 0, "total": 0})
            d2["launches"] += 1
            d2["used"] += int(a.get("rows_real", 0))
            d2["total"] += int(a.get("rows_total", 0))
        elif r["name"] == "eval.padding":
            k = (f"eval.finetune[{a.get('dataset')}]", "specs")
            d = agg.setdefault(k, {"launches": 0, "used": 0, "total": 0})
            d["launches"] += 1
            d["used"] += int(a.get("specs_real", 0))
            d["total"] += int(a.get("specs_total", 0))
    return [{"site": site, "dim": dim, **d,
             "waste_pct": (100.0 * (1.0 - d["used"] / d["total"])
                           if d["total"] else 0.0)}
            for (site, dim), d in sorted(agg.items())]


def recompile_timeline(records: Sequence[Dict]) -> List[Dict]:
    """Dispatch-triggered backend compiles per ``island.generation``
    interval (profiler-initiated AOT captures excluded). Compiles outside
    every generation span (warm-up, checkpoint/resume, report glue) land
    in the ``(outside generations)`` row."""
    gens = []
    for r in records:
        if r.get("kind") == "span" and r["name"] == "island.generation":
            a = _attrs(r)
            ts = float(r.get("ts", 0.0))
            gens.append({"start": ts, "end": ts + float(r.get("dur", 0.0)),
                         "island": a.get("island"),
                         "round": a.get("round"),
                         "generation": a.get("generation"),
                         "compiles": 0, "compile_s": 0.0})
    gens.sort(key=lambda g: g["start"])
    outside = {"island": None, "round": None, "generation": None,
               "compiles": 0, "compile_s": 0.0}
    any_compiles = False
    for r in records:
        if r.get("kind") != "event" or r["name"] != "prof.compile":
            continue
        a = _attrs(r)
        if a.get("aot"):
            continue
        any_compiles = True
        ts = float(r.get("ts", 0.0))
        for g in gens:
            if g["start"] <= ts <= g["end"]:
                g["compiles"] += 1
                g["compile_s"] += float(a.get("seconds", 0.0))
                break
        else:
            outside["compiles"] += 1
            outside["compile_s"] += float(a.get("seconds", 0.0))
    if not any_compiles:
        return []
    rows = [{k: g[k] for k in ("island", "round", "generation", "compiles",
                               "compile_s")} for g in gens]
    rows.append(outside)
    return rows


def ledger(records: Sequence[Dict]) -> List[Dict]:
    out = []
    for r in records:
        if r.get("kind") == "event" and r["name"] in LEDGER_EVENTS:
            out.append({"ts": r.get("ts", 0.0), "name": r["name"],
                        **_attrs(r)})
        elif (r.get("kind") == "span"
              and r["name"] in ("runtime.checkpoint", "runtime.resume")):
            out.append({"ts": r.get("ts", 0.0), "name": r["name"],
                        "dur": r.get("dur"), **_attrs(r)})
    out.sort(key=lambda e: e["ts"])
    return out


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt_attrs(d: Dict[str, Any], skip=("ts",)) -> str:
    parts = []
    for k, v in d.items():
        if k in skip or v is None:
            continue
        if isinstance(v, float):
            v = f"{v:.4g}"
        parts.append(f"{k}={v}")
    return " ".join(parts)


def render(records: Sequence[Dict], damaged: int = 0,
           source: str = "trace") -> str:
    lines: List[str] = []
    spans = span_table(records)
    wall = max((r.get("ts", 0.0) + float(r.get("dur", 0.0))
                for r in records if isinstance(r.get("ts"), (int, float))),
               default=0.0)
    n_span = sum(1 for r in records if r.get("kind") == "span")
    n_event = sum(1 for r in records if r.get("kind") == "event")
    lines.append(f"== repro.obs run report: {source} ==")
    lines.append(f"records: {len(records)} ({n_span} spans, {n_event} "
                 f"events), wall-clock {wall:.3f}s"
                 + (f", {damaged} damaged line(s) skipped" if damaged
                    else ""))

    lines.append("")
    lines.append("-- wall-clock by span --")
    lines.append(f"{'span':<24}{'calls':>7}{'total_s':>10}{'share':>8}"
                 f"{'compile_s':>11}{'steady_s':>10}{'errors':>8}")
    total_all = sum(r["total_s"] for r in spans) or 1.0
    for r in spans:
        lines.append(f"{r['name']:<24}{r['calls']:>7}{r['total_s']:>10.4f}"
                     f"{r['total_s'] / total_all:>8.1%}"
                     f"{r['compile_s']:>11.4f}{r['steady_s']:>10.4f}"
                     f"{r['errors']:>8}")

    tl = island_timelines(records)
    lines.append("")
    lines.append("-- per-island generation timeline --")
    if not tl:
        lines.append("(no island.generation spans)")
    for isl, gens in tl.items():
        ok = [g for g in gens if not g["error"]]
        errs = [g for g in gens if g["error"]]
        tot = sum(g["dur"] for g in gens)
        lines.append(f"island {isl}: {len(ok)} generation(s), "
                     f"{len(errs)} failed, {tot:.4f}s")
        for g in gens:
            tag = f"  r{g['round']} g{g['generation']} {g['dur']*1e3:8.2f}ms"
            if g["error"]:
                tag += f"  !{g['error']}"
            lines.append(tag)

    hv = hypervolume_progress(records)
    lines.append("")
    lines.append("-- pareto progress (hypervolume proxy) --")
    if not hv:
        lines.append("(no ga.front events with front objectives)")
    for h in hv:
        where = (f"island {h['island']} " if h["island"] is not None else "")
        lines.append(f"{where}gen {h['generation']}: hv={h['hv_proxy']:.6g} "
                     f"front={h['front_size']} "
                     f"best_acc={h['best_acc']:.4f} "
                     f"min_cost={h['min_cost']:.4g}"
                     if h["best_acc"] is not None else
                     f"{where}gen {h['generation']}: "
                     f"hv={h['hv_proxy']:.6g} front={h['front_size']}")

    cc = cache_curve(records)
    lines.append("")
    lines.append("-- cache hit rate --")
    if not cc:
        lines.append("(no fleet.fit / eval.batch events)")
    for c in cc:
        if "round" in c:
            lines.append(f"round {c['round']}: {c['memoized']}/"
                         f"{c['requested']} memo hits "
                         f"({c['hit_rate']:.1%}), {c['fitted']} fitted")
        else:
            lines.append(f"batch {c['batch']}: {c['hits']}/{c['requested']} "
                         f"cache hits ({c['hit_rate']:.1%}), "
                         f"{c['evaluated']} evaluated")

    ex = executables(records)
    lines.append("")
    lines.append("-- executables (observatory) --")
    if not ex:
        lines.append("(no profiled dispatches: run with REPRO_TRACE=1)")
    else:
        n_comp = sum(e["compiles"] for e in ex)
        comp_s = sum(e["compile_s"] for e in ex)
        n_disp = sum(e["dispatches"] for e in ex)
        recomp = sum(1 for e in ex if e["compiles"] > 1)
        lines.append(f"{len(ex)} executable key(s), {n_disp} dispatches, "
                     f"{n_comp} backend compile(s) ({comp_s:.3f}s), "
                     f"{recomp} key(s) recompiled")

        dev = any("device_ms" in e for e in ex)

        def _ex_row(e):
            flops = e.get("flops")
            return (f"  {e['site']:<28}{e['dispatches']:>6}"
                    f"{e['compiles']:>5}{e['compile_s']:>9.3f}"
                    f"{e['total_s']:>9.3f}"
                    + (f"{e.get('device_ms', 0.0):>10.3f}" if dev else "")
                    + (f"{flops:>12.3g}" if flops is not None
                       else f"{'-':>12}")
                    + f"  {e['key'][:40]}")

        hdr = (f"  {'site':<28}{'disp':>6}{'comp':>5}{'comp_s':>9}"
               f"{'disp_s':>9}" + (f"{'dev_ms':>10}" if dev else "")
               + f"{'flops':>12}  key")
        for title, keyfn in (
                ("top by compile time", lambda e: -e["compile_s"]),
                ("top by flops", lambda e: -(e.get("flops") or 0.0)),
                ("top by dispatches", lambda e: -e["dispatches"])):
            lines.append(f" {title}:")
            lines.append(hdr)
            for e in sorted(ex, key=keyfn)[:5]:
                lines.append(_ex_row(e))

    pad = padding_table(records)
    lines.append("")
    lines.append("-- padding waste (bucketed-executable overhead) --")
    if not pad:
        lines.append("(no netlist_sim.padding / eval.padding events)")
    else:
        lines.append(f"{'site':<28}{'dim':>6}{'launches':>10}{'used':>12}"
                     f"{'total':>12}{'waste':>8}")
        for p in pad:
            lines.append(f"{p['site']:<28}{p['dim']:>6}{p['launches']:>10}"
                         f"{p['used']:>12}{p['total']:>12}"
                         f"{p['waste_pct']:>7.1f}%")

    rt = recompile_timeline(records)
    lines.append("")
    lines.append("-- recompiles per generation --")
    if not rt:
        lines.append("(no prof.compile events)")
    for row in rt:
        where = ("(outside generations)" if row["generation"] is None else
                 f"island {row['island']} r{row['round']} "
                 f"g{row['generation']}")
        lines.append(f"{where:<28}{row['compiles']:>4} compile(s) "
                     f"{row['compile_s']:>8.3f}s")

    led = ledger(records)
    lines.append("")
    lines.append("-- fault/quarantine ledger --")
    if not led:
        lines.append("(clean run: no faults, checkpoints or quarantines)")
    for e in led:
        extra = _fmt_attrs({k: v for k, v in e.items()
                            if k not in ("ts", "name")})
        lines.append(f"[{e['ts']:10.4f}s] {e['name']}"
                     + (f"  {extra}" if extra else ""))
    lines.append("")
    return "\n".join(lines)


def write_csvs(records: Sequence[Dict], prefix: str) -> List[Path]:
    """PREFIX.spans/.generations/.cache/.ledger .csv — the machine-readable
    mirror of the report sections."""
    out: List[Path] = []

    def dump(name: str, rows: List[Dict]):
        p = Path(f"{prefix}.{name}.csv")
        keys: List[str] = []
        for r in rows:
            for k in r:
                if k not in keys:
                    keys.append(k)
        with open(p, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=keys)
            w.writeheader()
            w.writerows(rows)
        out.append(p)

    dump("spans", span_table(records))
    gens = [{"island": isl, **g}
            for isl, gens in island_timelines(records).items()
            for g in gens]
    dump("generations", gens)
    dump("cache", cache_curve(records))
    dump("ledger", ledger(records))
    dump("executables", executables(records))
    dump("padding", padding_table(records))
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Render a run summary from a repro_torch.obs trace JSONL.")
    ap.add_argument("trace", help="path to the trace .jsonl")
    ap.add_argument("--csv", metavar="PREFIX", default=None,
                    help="also write PREFIX.{spans,generations,cache,"
                         "ledger,executables,padding}.csv")
    args = ap.parse_args(argv)
    records, damaged = read_trace(args.trace)
    print(render(records, damaged, source=args.trace))
    if args.csv:
        for p in write_csvs(records, args.csv):
            print(f"wrote {p}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
