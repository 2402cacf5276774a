"""The port's roofline (`repro_torch.roofline`) and LM cost model
(`repro_torch.core.gpu_cost`) against the reference's on the same inputs:
`HWSpec`'s fields, `DepthFit`, `fit_depth`, `Roofline`, `model_flops`,
`collective_bytes` and `spec_cost_seconds` bit for bit (the port's
`HWSpec` built from the reference's TPU values where a comparison needs
them: the port itself holds only the H100's); `lm_layer_shapes` equal on
the same tree. Then `count_step` on small CPU steps: a product's FLOPs,
the bytes it moves, arguments, outputs, aliases and temporaries, the
kernels' meta branches recording their analytic costs, and meta tensors
refused outside a counter."""
import dataclasses

import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro.configs import ARCHS as RARCHS  # noqa: E402
from repro.core import tpu_cost as RTC  # noqa: E402
from repro.core.compression_spec import LayerMin as RLayerMin  # noqa: E402
from repro.core.compression_spec import ModelMin as RModelMin  # noqa: E402
from repro.launch import specs as RSP  # noqa: E402
from repro.roofline import analysis as RRA  # noqa: E402
from repro.roofline import hw as RHW  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.core import gpu_cost as GC  # noqa: E402
from repro_torch.core.compression_spec import LayerMin, ModelMin  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.kernels import quant_matmul as QM  # noqa: E402
from repro_torch.kernels import ssm_scan as SS  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FAO  # noqa: E402
from repro_torch.kernels.quant_matmul import ops as QMO  # noqa: E402
from repro_torch.kernels.ssm_scan import ops as SSO  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.obs import prof as PF  # noqa: E402
from repro_torch.roofline import analysis as RA  # noqa: E402
from repro_torch.roofline import hw as HW  # noqa: E402

V5E = HW.HWSpec(**dataclasses.asdict(RHW.TPU_V5E))


def test_hwspec_fields_and_the_h100():
    assert [f.name for f in dataclasses.fields(HW.HWSpec)] == \
        [f.name for f in dataclasses.fields(RHW.HWSpec)]
    h = HW.H100
    assert (h.peak_flops, h.hbm_bw, h.hbm_bytes) == (989e12, 3.35e12, 80e9)
    assert (h.ici_bw, h.ici_links, h.vmem_bytes) == (25e9, 18, 228 * 1024)
    assert RA.Roofline(1.0, 1.0, 1.0).hw is HW.H100


def _measure(seed):
    r = np.random.default_rng(seed)
    body = r.uniform(1, 1e6, size=(3, 4))
    base = r.uniform(0, 1e3, size=4)
    keys = ("flops", "bytes", "coll_all-gather", "coll_total")

    def measure(repeats):
        v = base + np.asarray(repeats) @ body
        return {k: float(x) for k, x in zip(keys, v)}
    return measure


@pytest.mark.parametrize("seed", [0, 1])
def test_depth_fit_bit_equal(seed):
    m = _measure(seed)
    got, want = RA.fit_depth(m, 3), RRA.fit_depth(m, 3)
    assert got.base == want.base and got.bodies == want.bodies
    for reps in ((1, 1, 1), (28, 1, 3), (96, 4, 12)):
        assert RA.DepthFit(got.base, got.bodies).at(reps) == \
            RRA.DepthFit(want.base, want.bodies).at(reps)
    # integer counts stay integers, so the fit is exact at any size
    fit = RA.fit_depth(lambda r: {"flops": 7 + 3 * r[0] + 2 ** 60 * r[1]}, 2)
    assert fit.at((5, 9)) == {"flops": 7 + 15 + 9 * 2 ** 60}


@pytest.mark.parametrize("terms", [(1e15, 1e12, 0.0), (2e12, 8e12, 5e9),
                                   (1e9, 1e6, 3e12)])
def test_roofline_and_model_flops_bit_equal(terms):
    got = RA.Roofline(*terms, hw=V5E).as_dict()
    want = RRA.Roofline(*terms, hw=RHW.TPU_V5E).as_dict()
    assert got == want
    assert RA.Roofline(*terms, hw=V5E).t_serial == \
        RRA.Roofline(*terms, hw=RHW.TPU_V5E).t_serial
    for kind in ("train", "serve"):
        assert RA.model_flops(596049920, 1048576, kind) == \
            RRA.model_flops(596049920, 1048576, kind)


def test_collective_bytes_equal_the_hlo_parse():
    ops = [("bf16", (8, 128, 256), "all-gather", ""),
           ("f32", (1024,), "all-reduce", "-start"),
           ("bf16", (16, 4096), "reduce-scatter", ""),
           ("s32", (64, 2), "all-to-all", ""),
           ("f32", (3, 5), "collective-permute", "-start"),
           ("bf16", (2, 2), "all-reduce", "")]
    size = {"bf16": 2, "f32": 4, "s32": 4}
    hlo = "\n".join(
        f"  %x{i} = {dt}[{','.join(map(str, dims))}]{{0}} {kind}{start}(%p)"
        for i, (dt, dims, kind, start) in enumerate(ops))
    records = [(kind, int(np.prod(dims)) * size[dt])
               for dt, dims, kind, _ in ops]
    assert RA.collective_bytes(records) == RRA.collective_bytes(hlo)
    assert RA.collective_bytes([]) == {"total": 0}


def _specs(n, seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(4):
        layers = []
        for _ in range(n):
            kind = r.integers(3)
            bits = None if kind == 0 else int(r.choice([2, 4, 8]))
            clusters = int(r.choice([2, 4, 16])) if kind == 2 else None
            layers.append(dict(bits=bits, clusters=clusters,
                               sparsity=float(r.choice([0.0, 0.25, 0.5]))))
        out.append(layers)
    return out


def test_gpu_cost_bit_equal_with_the_same_hwspec():
    rng = np.random.default_rng(3)
    dims = [(int(k), int(n)) for k, n in rng.integers(64, 8192, (6, 2))]
    tshapes = [GC.LayerShape(k, n) for k, n in dims]
    rshapes = [RTC.LayerShape(k, n) for k, n in dims]
    for layers in _specs(len(dims), 0):
        t = ModelMin(tuple(LayerMin(**l) for l in layers))
        r = RModelMin(tuple(RLayerMin(**l) for l in layers))
        for ts, rs, tl, rl in zip(tshapes, rshapes, t.layers, r.layers):
            assert GC.layer_weight_bytes(ts, tl) == \
                RTC.layer_weight_bytes(rs, rl)
        for bt in (1, 64):
            assert GC.spec_cost_seconds(tshapes, t, batch_tokens=bt,
                                        hw=V5E) == \
                RTC.spec_cost_seconds(rshapes, r, batch_tokens=bt)
        on_card = GC.spec_cost_seconds(tshapes, t)
        assert on_card["t_mem"] == on_card["bytes"] / HW.H100.hbm_bw


def test_lm_layer_shapes_equal_on_the_same_tree():
    cfg = ARCHS["qwen3-0.6b"].reduced(vocab_size=512, d_model=128,
                                      num_heads=4, num_kv_heads=2,
                                      head_dim=32, d_ff=512)
    rcfg = RARCHS["qwen3-0.6b"].reduced(vocab_size=512, d_model=128,
                                        num_heads=4, num_kv_heads=2,
                                        head_dim=32, d_ff=512)
    got = GC.lm_layer_shapes(SP.abstract_params(cfg))
    want = RTC.lm_layer_shapes(RSP.abstract_params(rcfg))
    # the reference prints a tuple index as "[i]" in these names
    want = {k.replace("[", "").replace("]", ""): v for k, v in want.items()}
    assert {k: (v.K, v.N) for k, v in got.items()} == \
        {k: (v.K, v.N) for k, v in want.items()}
    assert sorted(got) == sorted(want) and len(got) >= 4


# ---------------------------------------------------------------------------
# count_step
# ---------------------------------------------------------------------------


def test_count_step_flops_bytes_and_memory():
    x = torch.ones((8, 16))
    w = torch.ones((16, 32))
    acc = torch.zeros((8, 32))

    def step(x, w, acc):
        y = x @ w                       # 2 * 8 * 16 * 32 FLOPs
        acc.add_(y)                     # written in place and returned
        return acc, y.sum()

    c = RA.count_step(step, x, w, acc)
    assert RA.cost_dict(c)["flops"] == 2 * 8 * 16 * 32
    # mm reads x and w and writes y; add_ reads acc and y, writes acc;
    # sum reads y (its 0-dim result counts nothing)
    assert RA.cost_dict(c)["bytes"] == 4 * (8 * 16 + 16 * 32 + 8 * 32
                                            + 3 * 8 * 32 + 8 * 32)
    mem = RA.memory_dict(c)
    assert mem["argument_bytes"] == 4 * (8 * 16 + 16 * 32 + 8 * 32)
    assert mem["alias_bytes"] == 4 * 8 * 32
    assert mem["output_bytes"] == 4 * 8 * 32 + 4
    assert mem["temp_bytes"] == 4 * 8 * 32 + 4          # y and the sum
    assert mem["code_bytes"] == 0
    assert c.counter.flops_by_op == {"mm": 2 * 8 * 16 * 32}


def test_count_step_peak_sees_frees():
    def step(x):
        for _ in range(4):
            x = x * 2.0                 # each product frees the last
        return x

    x = torch.ones(1000, device="meta")
    mem = RA.memory_dict(RA.count_step(step, x))
    assert mem["temp_bytes"] == 2 * 4000
    assert mem["output_bytes"] == 4000 and mem["alias_bytes"] == 0


def _meta(*shapes, dtype=torch.bfloat16):
    return [torch.empty(s, dtype=dtype, device="meta") for s in shapes]


def test_meta_branches_record_the_kernels_costs():
    B, T, H, KV, hd = 2, 256, 8, 2, 64
    q, k, v = _meta((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd))
    for t in (q, k, v):
        t.requires_grad_(True)

    def attention(q, k, v):
        o = FA.flash_attention(q, k, v, causal=True)
        (g,) = torch.autograd.grad(o.float().sum(), (q,))
        return o, g

    c = RA.count_step(attention, q, k, v)
    fl, by = FAO.cost(B, T, T, H, KV, hd, 2)
    bfl, bby = FAO.bwd_cost(B, T, T, H, KV, hd, 2)
    assert c.counter.kernels == {
        "flash_attention": {"launches": 1, "flops": fl, "bytes": by},
        "flash_attention_bwd": {"launches": 1, "flops": bfl,
                                "bytes": bby}}
    o, g = c.result
    assert (o.shape, o.dtype, o.device.type) == (q.shape, q.dtype, "meta")
    assert g.shape == q.shape

    x, = _meta((16, 512))
    w = torch.empty((512, 1024), dtype=torch.int8, device="meta")
    s = torch.empty(1024, device="meta")
    c = RA.count_step(QM.quant_matmul, x, w, s)
    fl, by = QMO.cost(16, 512, 1024, 2)
    assert c.counter.kernels == {"quant_matmul": {"launches": 1,
                                                  "flops": fl, "bytes": by}}
    assert c.result.shape == (16, 1024) and c.counter.flops == fl

    Bs, Ts, d, N = 1, 64, 256, 16
    u, B_, C_ = _meta((Bs, Ts, d), (Bs, Ts, N), (Bs, Ts, N))
    dt, A, D = _meta((Bs, Ts, d), (d, N), (d,), dtype=torch.float32)
    u.requires_grad_(True)

    def scan(u, dt, B_, C_, A, D):
        y = SS.ssm_scan(u, dt, B_, C_, A, D)
        return torch.autograd.grad(y.float().sum(), (u,))[0]

    c = RA.count_step(scan, u, dt, B_, C_, A, D)
    fl, by = SSO.cost(Bs, Ts, d, N, 2)
    bfl, bby, _ = SSO.bwd_cost(Bs, Ts, d, N, 2)
    assert c.counter.kernels == {
        "ssm_scan": {"launches": 1, "flops": fl, "bytes": by},
        "ssm_scan_bwd": {"launches": 1, "flops": bfl, "bytes": bby}}


def test_meta_tensors_refused_outside_a_counter():
    q, = _meta((1, 16, 2, 64))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        FA.flash_attention(q, q, q)
    x, = _meta((4, 64))
    with pytest.raises(ValueError, match="count_step"):
        QM.quant_matmul(x, torch.empty((64, 64), dtype=torch.int8,
                                       device="meta"),
                        torch.empty(64, device="meta"))
    assert not PF.watching()


def test_launch_hook_reports_to_every_watcher():
    """The counter and any other watcher hear of the same launch through
    `obs.prof`'s one hook; the meta branch is open only while one
    watches."""
    heard = []

    def listen(*rec):
        heard.append(rec)

    x, = _meta((16, 512))
    w = torch.empty((512, 1024), dtype=torch.int8, device="meta")
    s = torch.empty(1024, device="meta")
    PF.watch(listen)
    try:
        assert PF.watching()
        c = RA.count_step(QM.quant_matmul, x, w, s)
    finally:
        PF.unwatch(listen)
    fl, by = QMO.cost(16, 512, 1024, 2)
    assert heard == [("quant_matmul", fl, by, "quant_matmul")]
    assert c.counter.kernels["quant_matmul"]["flops"] == fl
    assert not PF.watching()
    with pytest.raises(ValueError, match="count_step"):
        QM.quant_matmul(x, w, s)
