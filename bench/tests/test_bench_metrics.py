"""The per-layer readers on a canned trace, and the result line."""
import json

import pytest

from bench.harness import common as C
from bench.harness.trace import Summary

MS = 1_000_000           # ns


def canned():
    """Two decode steps of 10 ms: K2, a dequantizing kernel, a copy, and
    a gap while the host was in a Python range."""
    dev = [
        ("void (anonymous namespace)::qmm_kernel<__nv_bfloat16, 2, 1, false>"
         "(const __nv_bfloat16*, ...)", 0, 2 * MS),
        ("void at::native::elementwise_kernel<128, 4>(...)", 2 * MS, 6 * MS),
        ("Memcpy DtoH (Device -> Pageable)", 6 * MS, 7 * MS),
        ("void wide::qmm_wide_kernel<false, 128>(...)", 10 * MS, 12 * MS),
        ("void at::native::elementwise_kernel<128, 4>(...)", 12 * MS, 16 * MS),
        ("Memcpy DtoH (Device -> Pageable)", 16 * MS, 17 * MS),
    ]
    host = [("bench.decode_step", 0, 9 * MS), ("aten::copy_", 5 * MS, 9 * MS),
            ("bench.decode_step", 9 * MS, 20 * MS)]
    return Summary(dev, host, 20 * MS * 1e-9)


def obs(kind="decode"):
    return {"kind": kind, "trace": canned(), "traced_steps": 2,
            "k2_bound_s": 1e-3, "window_s": 2.0, "model_flops": 989e12,
            "model_bytes": 3.35e12, "step_times": [0.1] * 19 + [0.3]}


def test_summary_busy_ops_and_gaps():
    tr = canned()
    assert tr.busy_s == pytest.approx(14e-3)
    assert tr.kernel_count() == 6
    ops = tr.device_ops()
    assert ops[0][0].startswith("void at::native::elementwise_kernel")
    assert ops[0][1] == pytest.approx(8e-3)
    gaps = dict(map(tuple, tr.idle_gaps()))
    # 7-10 ms: the middle (8.5 ms) lies in aten::copy_, the innermost op
    assert gaps == {"aten::copy_": pytest.approx(3e-3)}


def test_decode_readers():
    o = obs()
    read = lambda n: C.reader(n).read(o)
    assert read("k2_roofline.decode") == pytest.approx(100 * 1e-3 / 4e-3)
    assert read("launches_per_step.decode") == 2.0
    assert read("device_idle.decode") == pytest.approx(30.0)
    assert read("mfu.decode") == pytest.approx(50.0)
    assert read("mbu.decode") == pytest.approx(50.0)
    assert read("itl_p95_ms.decode") == pytest.approx(100.0)


@pytest.mark.parametrize("name", [m["name"] for m in C.manifest()["per_layer"]])
def test_readers_find_nothing_elsewhere(name):
    mod = C.reader(name)
    other = "train" if mod.KIND != "train" else "decode"
    assert mod.read(obs(other)) is None
    assert mod.read({"kind": mod.KIND}) is None


def test_roofline_silent_without_its_kernels():
    o = obs()
    o["trace"] = Summary([("void other_kernel()", 0, MS)], [], 0.01)
    assert C.reader("k2_roofline.decode").read(o) is None


def test_backward_patterns_take_every_body():
    import re
    mod = C.reader("k5_bwd_roofline.train")
    rx = re.compile("|".join(mod.KERNELS))
    for name in ("void (anonymous namespace)::delta_kernel(Args, int)",
                 "void bwg::dkdv_wgmma_kernel(CUtensorMap)",
                 "void bwg2::dq_wgmma2_kernel(CUtensorMap)",
                 "void (anonymous namespace)::dq_kernel<float, 64>(Args)",
                 "void sum_split_kernel(const float*)"):
        assert rx.search(name), name
    assert not rx.search("void wg::flash_wgmma_kernel<128>(CUtensorMap)")


def test_result_line_keys_and_order():
    out = C.Outcome(e2e={}, attempted=3, failed=0,
                    checks={"logit_gap": 0.01}, obs={},
                    memory_peak_bytes=5)
    line = C.result_line(out, {"setup_s": {"value": 1.0, "unit": "s"}},
                         {"platform": "gpu"}, {"logit_gap": 0.1}, None)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True
    assert line["checks"] == {"logit_gap": {"value": 0.01, "limit": 0.1}}
    json.dumps(line)
    bad = C.result_line(out, {}, {}, {"logit_gap": 0.001}, {"a": []})
    assert bad["correct"] is False and list(bad)[-2:] == ["breakdown",
                                                         "checks"]
    assert C.judge({"a": 1.0}, {"a": 2.0, "b": 1.0}) is False
    assert C.judge({"a": float("nan")}, {"a": 2.0}) is False


def test_nearest_rank():
    assert C.nearest_rank(list(range(1, 101)), 0.95) == 95
    assert C.nearest_rank([3.0], 0.95) == 3.0
