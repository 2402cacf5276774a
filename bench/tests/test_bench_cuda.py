"""On the card: each cell's control, at the cell's own size, fails the
cell's limits while the program passes them, on three seeds. Run with

    python -m pytest -q -m cuda bench/tests/test_bench_cuda.py

(several minutes a cell: set-up, a short window, the check and the
control's reference for each seed)."""
import json
import subprocess
import sys

import pytest

from bench.harness import common as C

CELLS = [w["name"] for w in C.manifest()["workloads"]]
SEEDS = "2147483659,3000000019,4294967311"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_where_the_program_passes(workload):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    out = subprocess.run(
        [sys.executable, str(C.BENCH / "control.py"), "--workload", workload,
         "--seeds", SEEDS, "--seconds", "5"],
        cwd=C.ROOT, capture_output=True, text=True, timeout=3000)
    assert out.returncode == 0, out.stderr[-4000:]
    last = json.loads(out.stdout.strip().splitlines()[-1])
    lim = C.limits(workload)
    assert C.judge(last["program_largest"], lim), last
    assert any(last["control_smallest"][k] > lim[k] for k in lim), last
