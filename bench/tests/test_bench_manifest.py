"""BENCHMARK.json against the benchmark's contract, and the configuration
files against their sources."""
import json
import math
import re

import pytest

from bench.harness import common as C
from bench.reference.spec import load_config, parse

MAN = C.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E = {m["name"]: m for m in MAN["end_to_end"]}
CELLS = {w["name"]: w for w in MAN["workloads"]}

# DeepSeek-V2's published config.json (the keys the catalog of public
# architectures keeps), which bench/configs/deepseek-v2-l4.json must hold
DEEPSEEK_V2 = {
    "attention_bias": False, "first_k_dense_replace": 1,
    "hidden_act": "silu", "hidden_size": 5120, "intermediate_size": 12288,
    "kv_lora_rank": 512, "max_position_embeddings": 163840,
    "model_type": "deepseek_v2", "moe_intermediate_size": 1536,
    "moe_layer_freq": 1, "n_group": 8, "n_routed_experts": 160,
    "n_shared_experts": 2, "norm_topk_prob": False,
    "num_attention_heads": 128, "num_experts_per_tok": 6,
    "num_hidden_layers": 60, "num_key_value_heads": 128,
    "q_lora_rank": 1536, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
    "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40,
                     "mscale": 0.707, "mscale_all_dim": 0.707,
                     "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 16,
    "scoring_func": "softmax", "seq_aux": True, "tie_word_embeddings": False,
    "topk_group": 3, "topk_method": "group_limited_greedy",
    "v_head_dim": 128, "vocab_size": 102400}


def _is_width(key: str) -> bool:
    # topk_group, the groups a token's experts are drawn from, counts
    # with the experts per token
    return (key.endswith(("_dim", "_rank", "_size")) or "head" in key
            or key in ("num_experts_per_tok", "topk_group",
                       "expansion_factor"))


def test_top_level_keys_and_size():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert len((C.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["command"]) <= 32
    assert MAN["paths"] == ["bench"]
    for word in MAN["command"]:
        assert not word.startswith("/") and ".." not in word
    assert (C.ROOT / MAN["command"][1]).is_file()


def test_names_units_and_fields():
    names = [c["name"] for c in MAN["configs"]]
    names += list(CELLS) + [m["name"] for m in MAN["end_to_end"]]
    names += [m["name"] for m in MAN["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in MAN[group]}) == len(MAN[group])
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
        assert NAME.match(w["traffic"])
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("bench/") and (C.ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_every_cell_reports_what_it_must():
    pairs = {(w["config"], w["traffic"]) for w in MAN["workloads"]}
    assert len(pairs) == len(MAN["workloads"])
    assert {w["config"] for w in MAN["workloads"]} == \
        {c["name"] for c in MAN["configs"]}
    assert "setup_s" in E2E and "workloads" not in E2E["setup_s"]
    for w in CELLS:
        e2e = [m for m in MAN["end_to_end"] if C.applies(m, w)]
        assert len(e2e) >= 2
        assert any(C.applies(m, w) for m in MAN["per_layer"])


def test_moves_point_at_reported_metrics():
    for m in MAN["per_layer"]:
        moved = E2E[m["moves"]]
        for w in m.get("workloads", list(CELLS)):
            assert w in CELLS
            assert C.applies(moved, w), (m["name"], w)
        mod = C.reader(m["name"])
        assert mod.UNIT == m["unit"] and mod.MOVES == m["moves"]


def test_each_kernel_roofline_has_an_mfu_beside_it():
    for m in MAN["per_layer"]:
        if m["name"].split(".")[0].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       for o in MAN["per_layer"]), m["name"]


def test_run_seconds_fits_the_full_check_at_24_cells():
    rs = MAN["run_seconds"]
    assert 1 <= rs <= 51 and rs == int(rs)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)


def test_deepseek_file_holds_every_published_key():
    conf = next(c for c in MAN["configs"] if c["name"] == "deepseek-v2-l4")
    got = load_config("deepseek-v2-l4")
    assert conf["source"] == \
        "https://huggingface.co/deepseek-ai/DeepSeek-V2/blob/main/config.json"
    changed = {k for k, v in DEEPSEEK_V2.items() if got.get(k, object()) != v}
    assert changed == set(conf["reduced"])
    for k in changed:
        assert not _is_width(k), k
    # inside a changed group no width moves
    for k, v in DEEPSEEK_V2.items():
        if isinstance(v, dict) and k in changed:
            for kk, vv in v.items():
                if _is_width(kk):
                    assert got[k][kk] == vv, (k, kk)


@pytest.mark.parametrize("name", ["deepseek-v2-l4", "phi3.5-moe-l2"])
def test_configs_parse_and_keep_the_published_widths(name):
    spec = parse(load_config(name), name)
    cfg = load_config(name)
    assert cfg["hidden_size"] == spec.d_model
    if name == "deepseek-v2-l4":
        assert spec.num_layers == 4 and spec.n_dense == 1
        assert spec.moe.num_experts == 160 and spec.moe.top_k == 6
        assert spec.moe.d_shared == 3072 and spec.head_dim == 192
    else:
        assert spec.num_layers == 2 and spec.moe.num_experts == 16
        assert spec.moe.d_expert == 6400 and spec.num_kv_heads == 8


def test_limits_files_cover_the_cells():
    for w in CELLS:
        path = C.BENCH / "limits" / f"{w}.json"
        assert path.is_file(), path
        lim = json.loads(path.read_text())["limits"]
        assert lim and all(math.isfinite(v) and v >= 0 for v in lim.values())
