"""Run one benchmark cell once and print its result as the last line of
standard output.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``) names a configuration file
(``bench/configs/<config>.json``) and a traffic mix
(``bench/mixes/<traffic>.json``) whose ``kind`` names the driver
(``bench/drivers/<kind>.py``). The driver sets up the program (the
PyTorch/CUDA port under ``src/repro_torch``), measures it for ``--seconds``
and compares what the timed path produced with the plain reference
(``bench/reference``). With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, each read by
``bench/metrics/<name>.py`` from a profiled stretch after the window.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 3 and prints no result; with JAX or the JAX package loaded after
the window, with code 4.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".bench_cache"


def _environment() -> None:
    """Every build and kernel cache at a fixed place inside the checkout;
    no library loads JAX by itself."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()

    import torch
    from bench.harness import common as C
    from bench.reference.spec import parse

    man = C.manifest()
    cell = C.cell(man, args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    spec = parse(C.load_json(ROOT / conf["file"]), conf["name"])
    mix = C.load_json(C.BENCH / "mixes" / f"{cell['traffic']}.json")
    try:
        lim = C.limits(args.workload)
    except FileNotFoundError as e:
        print(f"no limits: {e}; the run cannot be correct", file=sys.stderr)
        lim = {}
    driver = importlib.import_module(f"bench.drivers.{mix['kind']}")
    torch.set_num_threads(4)
    ctx = C.Context(workload=args.workload, spec=spec, mix=mix,
                    seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda", 0),
                    t_start=T_START, limits=lim)
    out = driver.run(ctx)

    bad = C.forbidden_modules()
    if bad:
        print(f"modules loaded that the port may not use: {bad}",
              file=sys.stderr)
        return 4

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell["chips"],
              "memory_peak_bytes": out.memory_peak_bytes,
              "power_limit": _power_limit()}
    breakdown = None
    metrics = {}
    if args.trace:
        tr = out.obs["trace"]
        device["busy_s"], device["window_s"] = tr.busy_s, tr.window_s
        breakdown = {"device_ops": tr.device_ops(),
                     "idle_gaps": tr.idle_gaps()}
        for m in man["per_layer"]:
            if C.applies(m, args.workload):
                v = C.reader(m["name"]).read(out.obs)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in man["end_to_end"]:
            if C.applies(m, args.workload):
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    line = C.result_line(out, metrics, device, lim, breakdown)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
