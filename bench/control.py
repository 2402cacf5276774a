"""Read the numbers a cell compares, for the program and for its control,
on several seeds in one process (on the card):

    python3 bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10

Each seed runs the cell's driver as ``bench/run.py`` does (set-up, a window
of ``--seconds``, the check), with the control read beside the program:
the reference put in the program's place in the precision below the one
the configuration states (decode: int4 weights for int8; prefill and
training: float8 products for bfloat16). One JSON line per seed, then the
largest program reading and the smallest control reading of each number,
the two readings a limit is set between.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, _environment  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--no-control", action="store_true",
                    help="read the program's numbers alone")
    ap.add_argument("--fault", action="append", default=[],
                    help="plant a fault under the timed path "
                         "(altered, half_batch, unchanged)")
    args = ap.parse_args(argv)
    _environment()
    import torch
    from bench.harness import common as C
    from bench.harness import device as D
    from bench.reference.spec import parse

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    man = C.manifest()
    cell = C.cell(man, args.workload)
    conf = next(c for c in man["configs"] if c["name"] == cell["config"])
    spec = parse(C.load_json(ROOT / conf["file"]), conf["name"])
    mix = C.load_json(C.BENCH / "mixes" / f"{cell['traffic']}.json")
    driver = importlib.import_module(f"bench.drivers.{mix['kind']}")
    dev = torch.device("cuda", 0)
    worst, least = {}, {}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = C.Context(workload=args.workload, spec=spec, mix=mix,
                        seed=seed, seconds=args.seconds, trace=False,
                        device=dev, t_start=time.perf_counter(),
                        control=not args.no_control,
                        faults=frozenset(args.fault))
        out = driver.run(ctx)
        print(json.dumps({"seed": seed, "program": out.checks,
                          "control": out.control, "e2e": out.e2e}),
              flush=True)
        for k, v in out.checks.items():
            worst[k] = max(worst.get(k, v), v)
        for k, v in out.control.items():
            least[k] = min(least.get(k, v), v)
        del out
        D.free(dev)
    print(json.dumps({"program_largest": worst, "control_smallest": least}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
