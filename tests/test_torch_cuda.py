"""Card-only tests of the port's CUDA kernels: K1 (netlist_sim) against
its plain PyTorch version and the numpy oracle, bit for bit; K2
(quant_matmul: its decode body and, from `wgmma_min_m` rows of bf16 x,
its large-M body), K3 (clustered_matmul), K4 (block_sparse_matmul), K5
(flash_attention) and K6 (ssm_scan) against their plain versions within the
bounds stated beside them (`quant_matmul_tolerance`,
`clustered_matmul_tolerance`, `block_sparse_matmul_tolerance`,
`flash_attention_tolerance` through `flash_attention_bound`,
`ssm_scan_tolerance`), alone and inside the
model; the backward kernels of K5 and K6 against their plain versions
(`flash_attention_bwd_tolerance`, `ssm_scan_bwd_tolerance`), gradients
through autograd and a train step through the kernels; K2-K4 refusing a
gradient; K5 with a window against the banded path, the ring-buffer
decode against the windowed forward, a recurrent w8 decode through K2 and
the MoE layer on the card against the CPU; K5 on MLA's padded v and on
the encoder's and cross attention's shapes, and the MLA, whisper and
vision prefills and w8 decodes through K5 and K2; K2's expert body
(`quant_matmul_experts`) at deepseek-v2's and phi3.5-moe's stack shapes
and inside the MoE layer. They import no
JAX (the machine with the card has none) and skip without a CUDA device;
on the card run them without the JAX-importing conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import circuit
from repro_torch.configs import ARCHS
from repro_torch.core import minimize as MZ
from repro_torch.core import clustering as CL
from repro_torch.core import pruning as PR
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import block_sparse_matmul as BS
from repro_torch.kernels import clustered_matmul as CM
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import netlist_sim as NS
from repro_torch.kernels import quant_matmul as QM
from repro_torch.kernels import ssm_scan as SS
from repro_torch.kernels.block_sparse_matmul import ops as BSO
from repro_torch.kernels.clustered_matmul import ops as CMO
from repro_torch.kernels.flash_attention import ops as FAO
from repro_torch.kernels.netlist_sim import ops as NSO
from repro_torch.kernels.quant_matmul import ops as QMO
from repro_torch.kernels.ssm_scan import ops as SSO
from repro_torch.configs.base import SSMConfig
from repro_torch.nn import attention as A
from repro_torch.nn import ssm as S
from repro_torch.nn import transformer as T
from repro_torch.serve import quantized as QS


def _net(dims, bits, seed, sparsity=0.0, clusters=None):
    r = np.random.default_rng(seed)
    q_layers, scales, biases, cls = [], [], [], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        qmax = 2 ** (bits - 1) - 1
        if clusters:
            cb = r.integers(-qmax, qmax + 1, (d_in, clusters)).astype(
                np.int64)
            idx = r.integers(0, clusters, (d_in, d_out))
            q = np.take_along_axis(cb, idx, axis=1)
            cls.append((idx, cb))
        else:
            q = r.integers(-qmax, qmax + 1, (d_in, d_out)).astype(np.int64)
            cls.append(None)
        q = q * (r.random((d_in, d_out)) >= sparsity)
        q_layers.append(q)
        scales.append(float(r.uniform(0.002, 0.02)))
        biases.append(r.normal(0, 0.3, d_out).astype(np.float32))
    c = MZ.CompiledMLP(q_layers, scales, biases, cls,
                       [bits] * len(q_layers), 8)
    return circuit.compile_netlist(c)


# name: (netlists, B, n_in, the body the shape takes): every population
# whose table fits in 227 KB takes the shared-memory body; "whitewine"
# is the search's shape (eight 11-10-7 candidates, 1223 test samples,
# tiles of 16 with a ragged last one), "ragged_batch" a tile of 16 with 3
# samples in the last, "one_sample" a tile of one live sample; "past_smem"
# (15100 int64 slots) is over 227 KB at one sample and takes the
# global-scratch body
CASES = {
    "mixed": (lambda: [_net(d, 5, i) for i, d in enumerate(
        [(7, 3, 3), (7, 28, 3), (7, 14, 14, 3)])], 300, 7, "smem"),
    "many_levels": (lambda: [_net((11,) + (10,) * 6 + (7,), 2, s,
                                  sparsity=0.2) for s in (1, 2)], 129, 11,
                    "smem"),
    "int64": (lambda: [_net((11, 12, 12, 7), 8, 3),
                       _net((11, 10, 7), 8, 4, clusters=4)], 77, 11, "smem"),
    "ragged_batch": (lambda: [_net((5, 6, 3), 4, 2)], NSO.BLOCK + 3, 5,
                     "smem"),
    "one_sample": (lambda: [_net((5, 6, 3), 4, 2)], 1, 5, "smem"),
    "whitewine": (lambda: [_net((11, 10, 7), b, i, sparsity=sp)
                           for i, (b, sp) in enumerate(
                               [(8, 0.0), (6, 0.2), (4, 0.4), (3, 0.1),
                                (8, 0.5), (5, 0.0), (2, 0.3), (7, 0.6)])],
                  1223, 11, "smem"),
    "past_smem": (lambda: [_net((16, 40, 40, 10), 8, 9)], 100, 16,
                  "global"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_netlist_sim_kernel_matches_plain_and_oracle(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make, B, n_in, body = CASES[case]
    pop = NS.pack_population(make())
    if case in ("int64", "past_smem"):
        assert NSO.lane_dtype(pop) == torch.int64
    lane = 4 if NSO.lane_dtype(pop) == torch.int32 else 8
    tile = NSO.smem_tile(pop.n_candidates, pop.n_slots, B, lane,
                         *NSO.device_limits(torch.device("cuda")))
    assert (tile is not None) == (body == "smem")
    if case in ("whitewine", "ragged_batch"):
        assert B % tile != 0                      # a ragged last tile
    x = np.random.default_rng(B).integers(0, 2 ** 4, (B, n_in))
    reset_launches()
    got = NS.simulate_population(pop, x, engine="cuda", device="cuda")
    torch.cuda.synchronize()
    assert LAUNCHES["netlist_sim"] == 1
    assert LAUNCHES["netlist_sim_smem"] == int(body == "smem")
    plain = NS.simulate_population(pop, x, engine="levels", device="cuda")
    oracle = NS.simulate_population_ref(pop, x)
    for out in (plain, oracle):
        np.testing.assert_array_equal(got["amx"], out["amx"])
        np.testing.assert_array_equal(got["argmax"], out["argmax"])


@pytest.mark.cuda
def test_netlist_sim_wrapper_never_falls_back_on_cuda(monkeypatch):
    """On a CUDA tensor the wrapper launches one of the kernel's two
    bodies, as the shape says, or raises; it never runs the plain version
    instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    small = NS.pack_population([_net((5, 6, 3), 4, 2)])
    large = NS.pack_population([_net((16, 40, 40, 10), 8, 9)])
    xs = torch.zeros((1, 4, 5), dtype=torch.int64, device="cuda")
    xl = torch.zeros((1, 4, 16), dtype=torch.int64, device="cuda")

    def forbidden(*a, **k):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(NSO, "simulate_levels", forbidden)
    for pop, x, smem in ((small, xs, 1), (large, xl, 0)):
        reset_launches()
        amx, cls = NS.netlist_sim(pop, x)
        torch.cuda.synchronize()
        assert amx.is_cuda and cls.is_cuda
        assert (LAUNCHES["netlist_sim"], LAUNCHES["netlist_sim_smem"]) == \
            (1, smem)

    def broken(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr("repro_torch.kernels.build.load", broken)
    for pop, x in ((small, xs), (large, xl)):
        with pytest.raises(RuntimeError, match="nvcc"):
            NS.netlist_sim(pop, x)


# ---------------------------------------------------------------------------
# K1 on approximated netlists, and the Simulator on the card
# ---------------------------------------------------------------------------


def clamp_net(ir, width: int):
    """A hand-built classifier whose three logits are TRUNCs at the clamp
    (shift ``width - 1``) of ``width``-bit words: each logit is 0 or
    -2^(width-1), so the comparator sees ties on most samples (int32 lanes
    at width 32, int64 at 62)."""
    s = width - 9                           # 8-bit ADC lanes: 9 signed bits
    net = ir.Netlist(in_bits=8, w_bits=[8])
    x0, x1, x2 = (net.input(i) for i in range(3))
    a = net.neg(net.shl(x0, s))
    b = net.sub(net.shl(x1, s), net.shl(x2, s))
    c = net.sub(net.shl(x2, s), net.shl(x0, s))
    logits = [net.trunc(v, width - 1) for v in (a, b, c)]
    assert all(net.nodes[v].width == width for v in (a, b, c))
    net.layer_pre_ids = [logits]
    net.output_ids = list(logits)
    net.argmax(logits)
    net.validate()
    return net


def _approx(net, csd, lsb, am):
    from repro_torch import approx
    L = net.n_layers
    return approx.approximate(net, approx.ApproxParams((csd,) * L,
                                                       (lsb,) * L, am))


# name: (netlists, B, n_in): TRUNC slots, comparator operands that are not
# the logits, ties, shifts at the clamp, int64 lanes, ragged tiles, and
# exact netlists packed beside approximated ones
APPROX_CASES = {
    "whitewine_mixed": (lambda: [
        _net((11, 10, 7), 8, 0), _approx(_net((11, 10, 7), 6, 1), 1, 2, 0),
        _approx(_net((11, 10, 7), 4, 2, sparsity=0.4), 6, 16, 8),
        _net((11, 10, 7), 5, 3, sparsity=0.2),
        _approx(_net((11, 10, 7), 8, 4), 0, 0, 24)], 1223, 11),
    "argmax_ties": (lambda: [_approx(_net((7, 8, 4), 8, 7), 1, 2, 24)],
                    NSO.BLOCK + 3, 7),
    "int64": (lambda: [_approx(_net((11, 12, 12, 7), 8, 3), 0, 0, 4),
                       _net((11, 10, 7), 8, 4, clusters=4)], 77, 11),
    "clamp_width32": (lambda: [clamp_net(circuit.ir, 32)], 300, 3),
    "clamp_width62": (lambda: [clamp_net(circuit.ir, 62)], 97, 3),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(APPROX_CASES))
def test_netlist_sim_kernel_on_approximated_netlists(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make, B, n_in = APPROX_CASES[case]
    pop = NS.pack_population(make())
    assert (pop.op == int(circuit.Op.TRUNC)).any()
    if case in ("int64", "clamp_width62"):
        assert NSO.lane_dtype(pop) == torch.int64
    x = np.random.default_rng(B).integers(0, 256, (B, n_in))
    reset_launches()
    got = NS.simulate_population(pop, x, engine="cuda", device="cuda")
    torch.cuda.synchronize()
    assert (LAUNCHES["netlist_sim"], LAUNCHES["netlist_sim_smem"]) == (1, 1)
    plain = NS.simulate_population(pop, x, engine="levels", device="cuda")
    oracle = NS.simulate_population_ref(pop, x)
    for out in (plain, oracle):
        np.testing.assert_array_equal(got["amx"], out["amx"])
        np.testing.assert_array_equal(got["argmax"], out["argmax"])
    amx = oracle["amx"]
    ties = (amx == amx.max(axis=-1, keepdims=True)).sum(axis=-1) > 1
    if case in ("argmax_ties", "clamp_width32", "clamp_width62",
                "whitewine_mixed"):
        assert ties.any()


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(APPROX_CASES))
def test_simulator_on_cuda_matches_cpu(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make, B, n_in = APPROX_CASES[case]
    x = np.random.default_rng(B + 1).integers(0, 256, (B, n_in))
    for net in make():
        cpu = circuit.Simulator(net, device="cpu").run(x)
        sim = circuit.Simulator(net, device="cuda")
        assert sim.device.type == "cuda"
        got = sim.run(x)
        for a, b in zip(got["pre"], cpu["pre"]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(got["argmax"], cpu["argmax"])
        k1 = NS.simulate_population(NS.pack_population([net]), x,
                                    engine="cuda", device="cuda")
        np.testing.assert_array_equal(got["argmax"], k1["argmax"][0])


# ---------------------------------------------------------------------------
# K2 and K5
# ---------------------------------------------------------------------------


@pytest.fixture()
def card():
    """A CUDA device with float32 products in full float32: TF32 off for
    matmuls and cuDNN, set here and restored after the test."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda", torch.cuda.current_device())
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.mark.cuda
@pytest.mark.parametrize("flag", [True, False])
def test_search_leaves_the_callers_tf32_flag(card, flag):
    """The QAT finetunes of a search run with TF32 off and put the caller's
    ``allow_tf32`` back: a small search on the card ends with the flag as
    the caller set it (the card fixture restores it after the test)."""
    from repro_torch import paper
    torch.backends.cuda.matmul.allow_tf32 = flag
    out = paper.run("seeds", population=4, generations=2, epochs=8,
                    device=card)
    assert torch.backends.cuda.matmul.allow_tf32 is flag
    assert out["pareto_front"]

# (M, K, N): qwen3-0.6b's 7 weight shapes at the decode batch of 8 (q, k/v,
# o, gate/up, down), a ragged shape, N not a multiple of 4 (byte loads),
# more rows than one block; falcon-mamba-7b's in_proj, x_proj, dt_proj
# (float32 input in the model), out_proj and untied LM head
QMM_SHAPES = [(8, 1024, 2048), (8, 1024, 1024), (8, 2048, 1024),
              (8, 1024, 3072), (8, 3072, 1024), (5, 1000, 3000),
              (7, 130, 50), (17, 64, 96), (8, 4096, 16384), (8, 8192, 288),
              (8, 256, 8192), (8, 8192, 4096), (8, 4096, 65024)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", QMM_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_matmul_kernel_matches_plain(card, shape, dtype):
    M, K, N = shape
    g = torch.Generator(device=card).manual_seed(M + K + N)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    w = torch.randint(-127, 128, (K, N), generator=g, device=card,
                      dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    reset_launches()
    got = QM.quant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul"] == 1
    ref = QM.quant_matmul_ref(x, w, s)
    assert got.dtype == x.dtype and got.shape == (M, N)
    tol = QM.quant_matmul_tolerance(x, w, s, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


# name: (B, T, S, H, KV, hd, causal, window, softcap, dtype)
FLASH_CASES = {
    "prefill_bf16": (4, 1024, 1024, 16, 8, 128, True, 0, 0.0, "bfloat16"),
    "prefill_f32": (1, 1024, 1024, 16, 8, 128, True, 0, 0.0, "float32"),
    "ragged_t": (2, 1000, 1000, 4, 2, 128, True, 0, 0.0, "float32"),
    "window": (1, 700, 700, 4, 1, 64, True, 256, 0.0, "bfloat16"),
    "softcap": (2, 300, 300, 8, 2, 128, True, 0, 30.0, "float32"),
    "non_causal_padded": (2, 200, 333, 4, 4, 64, False, 0, 0.0, "float32"),
    "head_dim_16": (2, 77, 77, 4, 2, 16, True, 0, 0.0, "float32"),
    "head_dim_256": (1, 130, 130, 2, 1, 256, True, 0, 50.0, "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_attention_kernel_matches_plain(card, case):
    B, Tq, S, H, KV, hd, causal, window, cap, dtype = FLASH_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + S + hd)
    dt = DTYPES[dtype]
    q = torch.randn((B, Tq, H, hd), generator=g, device=card).to(dt)
    k = torch.randn((B, S, KV, hd), generator=g, device=card).to(dt)
    v = torch.randn((B, S, KV, hd), generator=g, device=card).to(dt)
    kw = dict(causal=causal, window=window, softcap=cap)
    reset_launches()
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    ref = FA.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == dt and got.shape == (B, Tq, H, hd)
    tol = FA.flash_attention_bound(q, k, v, ref, **kw)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


# name: (B, T, S, H, KV, hd, causal, window, softcap), all bf16 through the
# wgmma body: each head_dim with ragged T (not a multiple of the 128-query
# block or the 64-key tile), non-causal S padded past the last tile, a
# window, a softcap, and GQA groups of 1, 2 and 8
WGMMA_CASES = {
    "hd64_t1000_g2": (2, 1000, 1000, 4, 2, 64, True, 0, 0.0),
    "hd64_t77_g1": (2, 77, 77, 4, 4, 64, True, 0, 0.0),
    "hd64_s333_g8": (1, 200, 333, 8, 1, 64, False, 0, 0.0),
    "hd128_t1000_g2": (1, 1000, 1000, 16, 8, 128, True, 0, 0.0),
    "hd128_t77_g8": (3, 77, 77, 8, 1, 128, True, 0, 0.0),
    "hd128_s333_g1": (2, 130, 333, 4, 4, 128, False, 0, 0.0),
    "hd128_window_softcap_g2": (1, 700, 700, 8, 4, 128, True, 256, 30.0),
    "hd256_t1000_g2": (1, 1000, 1000, 4, 2, 256, True, 0, 50.0),
    "hd256_t77_g1": (2, 77, 77, 2, 2, 256, True, 0, 0.0),
    "hd256_s333_g8": (1, 150, 333, 8, 1, 256, False, 0, 0.0),
    "hd256_window_g2": (1, 600, 600, 4, 2, 256, True, 100, 0.0),
    # recurrentgemma-9b's local layers (MQA, G = 16, window 2048) and
    # gemma2-2b's (8/4 heads, window 4096, softcap 50), past the window
    "hd256_g16_window_2048": (1, 2500, 2500, 16, 1, 256, True, 2048, 0.0),
    "hd256_gemma2_window_4096_softcap_50": (1, 4200, 4200, 8, 4, 256, True,
                                            4096, 50.0),
    # whisper-base's encoder (8/8 heads of 64 over 1500 frames, non-causal)
    # and cross attention at prefill (1024 queries) and decode (one query);
    # llama-3.2-vision's cross attention over 1601 patches (32/8 heads of
    # 128) at prefill and decode
    "hd64_whisper_encoder_s1500": (4, 1500, 1500, 8, 8, 64, False, 0, 0.0),
    "hd64_whisper_cross_t1024_s1500": (4, 1024, 1500, 8, 8, 64, False, 0,
                                       0.0),
    "hd64_whisper_cross_t1_s1500": (8, 1, 1500, 8, 8, 64, False, 0, 0.0),
    "hd128_vision_cross_t1024_s1601": (4, 1024, 1601, 32, 8, 128, False, 0,
                                       0.0),
    "hd128_vision_cross_t1_s1601": (8, 1, 1601, 32, 8, 128, False, 0, 0.0),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_CASES))
def test_flash_attention_wgmma_body_matches_plain(card, case):
    B, Tq, S, H, KV, hd, causal, window, cap = WGMMA_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + S + hd + H)
    q, k, v = (torch.randn(shape, generator=g, device=card).to(
        torch.bfloat16) for shape in ((B, Tq, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd)))
    kw = dict(causal=causal, window=window, softcap=cap)
    assert FA.takes_wgmma(q, k, v)
    reset_launches()
    got = FA.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == 1
    assert LAUNCHES["flash_attention_wgmma"] == 1
    ref = FA.flash_attention_plain(q, k, v, **kw)
    assert got.dtype == torch.bfloat16 and got.shape == (B, Tq, H, hd)
    tol = FA.flash_attention_bound(q, k, v, ref, **kw)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_flash_attention_bodies_by_type_head_dim_and_alignment(card):
    """bf16 at head_dim 64/128/256 with TMA-readable strides takes the wgmma
    body; float32, head_dim 32 and a view whose token stride is not a
    multiple of 16 bytes take the CUDA-core body, and still agree."""
    g = torch.Generator(device=card).manual_seed(5)

    def qkv(hd, dt, pad=0):
        full = torch.randn((1, 90, 4, hd + pad), generator=g,
                           device=card).to(dt)
        return full[..., :hd], full[:, :, :2, :hd], full[:, :, 2:, :hd]

    for hd, dt, pad, wgmma in ((128, torch.bfloat16, 0, True),
                               (128, torch.float32, 0, False),
                               (32, torch.bfloat16, 0, False),
                               (64, torch.bfloat16, 4, False)):
        q, k, v = qkv(hd, dt, pad)
        q = q.contiguous() if pad == 0 else q
        assert FA.takes_wgmma(q, k, v) == wgmma
        reset_launches()
        got = FA.flash_attention(q, k, v)
        torch.cuda.synchronize()
        assert (LAUNCHES["flash_attention"],
                LAUNCHES["flash_attention_wgmma"]) == (1, int(wgmma))
        ref = FA.flash_attention_plain(q, k, v)
        tol = FA.flash_attention_bound(q, k, v, ref)
        assert bool(((got.float() - ref.float()).abs() <= tol).all())


def ssm_inputs(g, B, T, d, N, dtype, device):
    """u, B_, C_ in ``dtype``; dt = softplus(normal - 1), A = -(1..N) times
    a log-normal factor (the S4D-real range the model starts from), D, all
    float32."""
    def normal(*shape):
        return torch.randn(shape, generator=g, device=device)

    u = normal(B, T, d).to(dtype)
    dt = torch.nn.functional.softplus(normal(B, T, d) - 1.0)
    B_, C_ = normal(B, T, N).to(dtype), normal(B, T, N).to(dtype)
    A = -torch.arange(1, N + 1, device=device, dtype=torch.float32) \
        * torch.exp(0.3 * normal(d, N))
    return u, dt, B_, C_, A, normal(d)


# name: (B, T, d, N, dtype): falcon-mamba-7b's prefill shape, a ragged T
# (not a multiple of the 32 staged steps), a ragged d (not a multiple of the
# block's 64 channels), a smaller state, one step; then every state
# that the lanes split unevenly (N 1, 3, 5) at T 1, 63 and 65, each at a d
# that is no multiple of the block's channels (odd ones take the staging of
# one element a copy), in both types
SSM_CASES = {
    "prefill_bf16": (4, 1024, 8192, 16, "bfloat16"),
    "prefill_f32": (1, 1024, 8192, 16, "float32"),
    "ragged_t_333": (2, 333, 512, 16, "float32"),
    "ragged_d_1000": (2, 200, 1000, 16, "bfloat16"),
    "state_4": (3, 130, 256, 4, "float32"),
    "one_step": (2, 1, 300, 16, "bfloat16"),
}
SSM_CASES.update({
    f"state_{N}_t{T}_{dtype}": (2, T, 200 + 40 * N + T, N, dtype)
    for N in (1, 3, 5) for T in (1, 63, 65)
    for dtype in ("bfloat16", "float32")})


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSM_CASES))
def test_ssm_scan_kernel_matches_plain(card, case):
    B, Tq, d, N, dtype = SSM_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + d + N)
    args = ssm_inputs(g, B, Tq, d, N, DTYPES[dtype], card)
    reset_launches()
    got = SS.ssm_scan(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == 1
    ref = SS.ssm_scan_ref(*args)
    assert got.dtype == args[0].dtype and got.shape == (B, Tq, d)
    tol = SS.ssm_scan_tolerance(*args, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_ssm_scan_never_falls_back_on_cuda(card, monkeypatch):
    """On CUDA tensors K6's wrapper launches its kernel or raises: mixed
    types are checked, a state beyond 16 values and non-contiguous inputs
    are refused, and a missing build is an error."""
    monkeypatch.setattr(SSO, "ssm_scan_ref", lambda *a: pytest.fail(
        "plain version ran on a CUDA tensor"))
    g = torch.Generator(device=card).manual_seed(0)
    u, dt, B_, C_, A, D = ssm_inputs(g, 2, 8, 64, 16, torch.bfloat16, card)
    assert SS.ssm_scan(u, dt, B_, C_, A, D).is_cuda
    with pytest.raises(TypeError, match="float32"):
        SS.ssm_scan(u, dt.to(torch.bfloat16), B_, C_, A, D)
    with pytest.raises(ValueError, match="contiguous"):
        SS.ssm_scan(u.transpose(0, 1).contiguous().transpose(0, 1), dt, B_,
                    C_, A, D)
    wide = ssm_inputs(g, 1, 4, 64, 32, torch.float32, card)
    with pytest.raises(ValueError, match="state"):
        SS.ssm_scan(*wide)

    def broken(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr("repro_torch.kernels.build.load", broken)
    monkeypatch.setattr(SSO, "_FNS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        SS.ssm_scan(u, dt, B_, C_, A, D)


@pytest.mark.cuda
def test_lm_wrappers_never_fall_back_on_cuda(card, monkeypatch):
    """On CUDA tensors K2's and K5's wrappers launch their kernels or
    raise; they never run the plain versions instead."""
    def forbidden(*a, **k):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(QMO, "quant_matmul_ref", forbidden)
    monkeypatch.setattr(FAO, "flash_attention_ref", forbidden)
    x = torch.ones((2, 64), device=card)
    w = torch.ones((64, 8), dtype=torch.int8, device=card)
    assert QM.quant_matmul(x, w, torch.ones(8, device=card)).is_cuda
    q = torch.ones((1, 8, 2, 64), device=card)
    assert FA.flash_attention(q, q, q).is_cuda

    def broken(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr("repro_torch.kernels.build.load", broken)
    monkeypatch.setattr(QMO, "_FNS", {})
    monkeypatch.setattr(FAO, "_FNS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        QM.quant_matmul(x, w, torch.ones(8, device=card))
    with pytest.raises(RuntimeError, match="nvcc"):
        FA.flash_attention(q, q, q)


QUANT_CFG = dict(vocab_size=512, d_model=256, num_heads=4, num_kv_heads=2,
                 head_dim=64, d_ff=512)


@pytest.mark.cuda
def test_prefill_goes_through_k5(card, monkeypatch):
    cfg = ARCHS["qwen3-0.6b"].reduced(**QUANT_CFG)
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=card)
    reset_launches()
    got, _ = T.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    monkeypatch.setattr(A, "flash_attention", FA.flash_attention_plain)
    want, _ = T.forward(params, {"tokens": tokens}, cfg)
    # float32 end to end: two layers of reordered sums
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_bf16_prefill_goes_through_the_wgmma_body(card, monkeypatch):
    cfg = ARCHS["qwen3-0.6b"].reduced(**dict(QUANT_CFG, head_dim=128,
                                             dtype="bfloat16"))
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 300), device=card)
    reset_launches()
    got, _ = T.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["flash_attention"] == cfg.num_layers
    assert LAUNCHES["flash_attention_wgmma"] == cfg.num_layers
    monkeypatch.setattr(A, "flash_attention", FA.flash_attention_plain)
    want, _ = T.forward(params, {"tokens": tokens}, cfg)
    # one bf16 rounding (2^-8 relative) of the residual stream a layer
    rel = float((got.double() - want.double()).norm() / want.double().norm())
    assert rel <= cfg.num_layers * 2.0 ** -8, rel


@pytest.mark.cuda
def test_quantized_decode_goes_through_k2(card, monkeypatch):
    cfg = ARCHS["qwen3-0.6b"].reduced(**QUANT_CFG)
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    qp = QS.quantize_params(params, bits=8)
    tokens = torch.randint(0, cfg.vocab_size, (8, 6), device=card)
    logits = {}
    for variant in ("kernel", "plain"):
        if variant == "plain":
            monkeypatch.setattr("repro_torch.nn.layers.quant_matmul",
                                QM.quant_matmul_ref)
        state = T.init_decode_state(cfg, 8, 16, torch.float32, device=card)
        reset_launches()
        out = []
        for t in range(tokens.shape[1]):
            lg, state = T.decode_step(qp, state, tokens[:, t:t + 1], cfg)
            out.append(lg)
        torch.cuda.synchronize()
        logits[variant] = torch.cat(out, 1)
        expect = 7 * cfg.num_layers * tokens.shape[1]
        assert LAUNCHES["quant_matmul"] == (expect if variant == "kernel"
                                            else 0)
    torch.testing.assert_close(logits["kernel"], logits["plain"], rtol=1e-4,
                               atol=1e-4)


# falcon-mamba-7b at d_model 256, N 16, dt_rank 64: every dense product of
# a layer is large enough to quantize
MAMBA_CFG = dict(d_model=256, ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                            dt_rank=64))


@pytest.mark.cuda
def test_prefill_goes_through_k6(card, monkeypatch):
    cfg = ARCHS["falcon-mamba-7b"].reduced(**MAMBA_CFG)
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=card)
    reset_launches()
    got, _ = T.forward(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == cfg.num_layers
    monkeypatch.setattr(S, "ssm_scan", SS.ssm_scan_ref)
    want, _ = T.forward(params, {"tokens": tokens}, cfg)
    # float32 end to end: two layers of reordered sums
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_quantized_mamba_decode_goes_through_k2(card, monkeypatch):
    cfg = ARCHS["falcon-mamba-7b"].reduced(**MAMBA_CFG)
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    qp = QS.quantize_params(params, bits=8)
    tokens = torch.randint(0, cfg.vocab_size, (8, 6), device=card)
    logits = {}
    for variant in ("kernel", "plain"):
        if variant == "plain":
            monkeypatch.setattr("repro_torch.nn.layers.quant_matmul",
                                QM.quant_matmul_ref)
        state = T.init_decode_state(cfg, 8, 16, torch.float32, device=card)
        reset_launches()
        out = []
        for t in range(tokens.shape[1]):
            lg, state = T.decode_step(qp, state, tokens[:, t:t + 1], cfg)
            out.append(lg)
        torch.cuda.synchronize()
        logits[variant] = torch.cat(out, 1)
        # in_proj, x_proj, dt_proj, out_proj a layer, and the LM head
        expect = (4 * cfg.num_layers + 1) * tokens.shape[1]
        assert LAUNCHES["quant_matmul"] == (expect if variant == "kernel"
                                            else 0)
        assert LAUNCHES["ssm_scan"] == 0
    torch.testing.assert_close(logits["kernel"], logits["plain"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K3 and K4
# ---------------------------------------------------------------------------


# (M, K, N, C): qwen3-0.6b's gate/up and q shapes at the decode batch of 8,
# the JAX test's ragged shape, N not a multiple of 4 (single index loads),
# more clusters than int8 holds (int32 only), a prefill-sized M
CMM_CASES = {
    "decode_gate": (8, 1024, 3072, 16),
    "decode_q": (8, 1024, 2048, 16),
    "ragged": (20, 70, 40, 3),
    "n_not_4": (5, 130, 50, 7),
    "c_300": (8, 256, 96, 300),
    "m_1000": (1000, 1024, 256, 16),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case,idx_dtype", [
    (c, i) for c in sorted(CMM_CASES) for i in ("int8", "int32")
    if i == "int32" or CMM_CASES[c][3] <= 128])   # int8 holds 128 clusters
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_clustered_matmul_kernel_matches_plain(card, case, idx_dtype, dtype):
    M, K, N, C = CMM_CASES[case]
    g = torch.Generator(device=card).manual_seed(M + K + N + C)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    idx = torch.randint(0, C, (K, N), generator=g, device=card).to(
        getattr(torch, idx_dtype))
    cb = torch.randn((K, C), generator=g, device=card)
    reset_launches()
    got = CM.clustered_matmul(x, idx, cb)
    torch.cuda.synchronize()
    assert LAUNCHES["clustered_matmul"] == 1
    ref = CM.clustered_matmul_ref(x, idx, cb)
    assert got.dtype == x.dtype and got.shape == (M, N)
    tol = CM.clustered_matmul_tolerance(x, idx, cb, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


# (M, K, N, C, idx dtype): the split-K layout at M = 1, 8, 33 and 4096 (one
# cluster of 1 block for large M), K shorter than a full split (chunks past
# the end contribute nothing), N ragged, 1024 and 3072, C from 2 to 128 in
# int8 and 256 and 4096 in int32 (fewer rows staged at a time)
SPLIT_K_CASES = {
    "m1_n1024_c2": (1, 1024, 1024, 2, "int8"),
    "m8_n3072_c16": (8, 1024, 3072, 16, "int8"),
    "m8_k3072_n1024_c16": (8, 3072, 1024, 16, "int8"),
    "m8_k900_n1000_c16": (8, 900, 1000, 16, "int8"),
    "m33_n1000_c128": (33, 1024, 1000, 128, "int8"),
    "m8_k200_n3072_c128": (8, 200, 3072, 128, "int8"),
    "m4096_n3072_c16": (4096, 1024, 3072, 16, "int8"),
    "m8_n1024_c256_i32": (8, 1024, 1024, 256, "int32"),
    "m33_k300_n1000_c4096_i32": (33, 300, 1000, 4096, "int32"),
    "m1_n3072_c256_i32": (1, 512, 3072, 256, "int32"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPLIT_K_CASES))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_clustered_matmul_split_k_matches_plain(card, case, dtype):
    M, K, N, C, idx_dtype = SPLIT_K_CASES[case]
    g = torch.Generator(device=card).manual_seed(M + K + N + C)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    idx = torch.randint(0, C, (K, N), generator=g, device=card).to(
        getattr(torch, idx_dtype))
    cb = torch.randn((K, C), generator=g, device=card)
    reset_launches()
    got = CM.clustered_matmul(x, idx, cb)
    torch.cuda.synchronize()
    assert LAUNCHES["clustered_matmul"] == 1
    ref = CM.clustered_matmul_ref(x, idx, cb)
    assert got.dtype == x.dtype and got.shape == (M, N)
    tol = CM.clustered_matmul_tolerance(x, idx, cb, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    again = CM.clustered_matmul(x, idx, cb)    # a fixed summation order
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", ["int8", "int32"])
def test_clustered_matmul_unaligned_index_view(card, idx_dtype):
    """An idx view that starts off a 16-byte boundary takes the kernel's
    single-index loads and agrees with the plain version."""
    g = torch.Generator(device=card).manual_seed(3)
    M, K, N, C = 8, 512, 1024, 16
    x = torch.randn((M, K), generator=g, device=card).to(torch.bfloat16)
    flat = torch.randint(0, C, (K * N + 1,), generator=g, device=card).to(
        getattr(torch, idx_dtype))
    idx = flat[1:].view(K, N)
    assert idx.is_contiguous() and idx.data_ptr() % 16 != 0
    cb = torch.randn((K, C), generator=g, device=card)
    got = CM.clustered_matmul(x, idx, cb)
    ref = CM.clustered_matmul_ref(x, idx, cb)
    tol = CM.clustered_matmul_tolerance(x, idx, cb, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_clustered_matmul_on_per_input_codebooks(card):
    """K3 over `cluster_per_input`'s codebooks, indices stored int8, equals
    the product with the reconstructed weight."""
    g = torch.Generator(device=card).manual_seed(1)
    w = torch.randn((256, 384), generator=g, device=card) * 0.05
    x = torch.randn((8, 256), generator=g, device=card).to(torch.bfloat16)
    cb, idx = CL.cluster_per_input(w, 16)
    got = CM.clustered_matmul(x, idx.to(torch.int8), cb)
    dense = (x.float() @ CL.reconstruct_per_input(cb, idx)).to(x.dtype)
    tol = CM.clustered_matmul_tolerance(x, idx, cb, dense)
    assert bool(((got.float() - dense.float()).abs() <= tol).all())


# (M, K, N, bk, bn, live share): the decode shapes in 128 x 128 tiles at
# three live shares, smaller tiles than the 32-column strip, a ragged M
BSMM_CASES = {
    "decode_gate_half": (8, 1024, 3072, 128, 128, 0.5),
    "decode_down_tenth": (8, 3072, 1024, 128, 128, 0.1),
    "decode_o_full": (8, 2048, 1024, 128, 128, 1.0),
    "tiles_32": (8, 1024, 1024, 32, 32, 0.5),
    "tiles_16": (13, 256, 160, 16, 16, 0.5),
    "tiles_16x48": (8, 128, 96, 16, 48, 0.4),
    "m_1000": (1000, 1024, 256, 128, 128, 0.5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BSMM_CASES))
@pytest.mark.parametrize("mask_dtype", ["bool", "int32"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_sparse_matmul_kernel_matches_plain(card, case, mask_dtype,
                                                  dtype):
    M, K, N, bk, bn, live = BSMM_CASES[case]
    g = torch.Generator(device=card).manual_seed(M + K + N + bk + bn)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    w = torch.randn((K, N), generator=g, device=card).to(DTYPES[dtype])
    bm = torch.rand((K // bk, N // bn), generator=g, device=card) < live
    bm[0, 0] = False                 # a dead tile with non-zero weights
    bm[:, -1] = False                # an all-dead column strip
    bm = bm.to(getattr(torch, mask_dtype))
    reset_launches()
    got = BS.block_sparse_matmul(x, w, bm, block_k=bk, block_n=bn)
    torch.cuda.synchronize()
    assert LAUNCHES["block_sparse_matmul"] == 1
    ref = BS.block_sparse_matmul_ref(x, w, bm, block_k=bk, block_n=bn)
    assert got.dtype == x.dtype and got.shape == (M, N)
    assert torch.count_nonzero(got[:, N - bn:]) == 0
    tol = BS.block_sparse_matmul_tolerance(x, w, bm, ref, block_k=bk,
                                           block_n=bn)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_block_sparse_matmul_on_block_mask(card):
    """K4 over `block_mask`'s tiles equals the product with
    `apply_mask(w, block_mask(w))`."""
    g = torch.Generator(device=card).manual_seed(2)
    w = torch.randn((512, 384), generator=g, device=card)
    x = torch.randn((8, 512), generator=g, device=card)
    full = PR.block_mask(w, 0.5, block=(128, 128))
    tiles = full[::128, ::128].contiguous()
    got = BS.block_sparse_matmul(x, w, tiles)
    dense = x @ PR.apply_mask(w, full)
    tol = BS.block_sparse_matmul_tolerance(x, w, tiles, dense, block_k=128,
                                           block_n=128)
    assert bool(((got - dense).abs() <= tol).all())


@pytest.mark.cuda
def test_compressed_wrappers_never_fall_back_on_cuda(card, monkeypatch):
    """On CUDA tensors K3's and K4's wrappers launch their kernels or
    raise: they never run the plain versions, refuse non-contiguous inputs,
    and a missing build is an error."""
    def forbidden(*a, **k):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(CMO, "clustered_matmul_ref", forbidden)
    monkeypatch.setattr(BSO, "block_sparse_matmul_ref", forbidden)
    x = torch.ones((2, 64), device=card)
    idx = torch.zeros((64, 8), dtype=torch.int8, device=card)
    cb = torch.ones((64, 4), device=card)
    w = torch.ones((64, 32), device=card)
    bm = torch.ones((2, 1), dtype=torch.bool, device=card)
    assert CM.clustered_matmul(x, idx, cb).is_cuda
    assert BS.block_sparse_matmul(x, w, bm, block_k=32, block_n=32).is_cuda
    with pytest.raises(ValueError, match="contiguous"):
        CM.clustered_matmul(x, idx.t().contiguous().t(), cb)
    with pytest.raises(ValueError, match="contiguous"):
        BS.block_sparse_matmul(x, torch.ones((64, 64), device=card),
                               torch.ones((2, 2), dtype=torch.bool,
                                          device=card).t(),
                               block_k=32, block_n=32)

    def broken(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr("repro_torch.kernels.build.load", broken)
    monkeypatch.setattr(CMO, "_FNS", {})
    monkeypatch.setattr(BSO, "_FNS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        CM.clustered_matmul(x, idx, cb)
    with pytest.raises(RuntimeError, match="nvcc"):
        BS.block_sparse_matmul(x, w, bm, block_k=32, block_n=32)


# ---------------------------------------------------------------------------
# K2 and K4 redesigned: split-K clusters, cp.async staging, mma.sync for bf16
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 33])
@pytest.mark.parametrize("shape", QMM_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_matmul_split_k_at_decode_rows(card, M, shape, dtype):
    """Every (K, N) of QMM_SHAPES at M = 1, 8, 16 and 33 (one, two and
    eight n-tiles of 8 rows a block): within the bound, the tensor-core
    body for bf16, and two calls equal bit for bit (a fixed summation
    order across the cluster)."""
    _, K, N = shape
    g = torch.Generator(device=card).manual_seed(M + 3 * K + N)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    w = torch.randint(-127, 128, (K, N), generator=g, device=card,
                      dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    reset_launches()
    got = QM.quant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul"] == 1
    assert LAUNCHES["quant_matmul_mma"] == int(dtype == "bfloat16")
    ref = QM.quant_matmul_ref(x, w, s)
    tol = QM.quant_matmul_tolerance(x, w, s, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    assert torch.equal(got, QM.quant_matmul(x, w, s))


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 16, 33])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_matmul_unaligned_weight_and_x_views(card, M, dtype):
    """w_q and x views that start off a 16-byte boundary are staged by
    single loads and agree with the plain version."""
    g = torch.Generator(device=card).manual_seed(M + 11)
    K, N = 1024, 1024
    flat_w = torch.randint(-127, 128, (K * N + 1,), generator=g, device=card,
                           dtype=torch.int8)
    w = flat_w[1:].view(K, N)
    flat_x = torch.randn((M * K + 1,), generator=g, device=card).to(
        DTYPES[dtype])
    x = flat_x[1:].view(M, K)
    assert w.data_ptr() % 16 != 0 and x.data_ptr() % 16 != 0
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    got = QM.quant_matmul(x, w, s)
    ref = QM.quant_matmul_ref(x, w, s)
    tol = QM.quant_matmul_tolerance(x, w, s, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


def _bsmm_mask(g, K, N, bk, bn, live, device):
    """A (K/bk, N/bn) mask: uniform at a live share, or "skewed" (the first
    quarter of the column strips fully live, the rest at 1/6, about 37%
    live), always with the last strip all dead."""
    kt, nt = K // bk, N // bn
    if live == "skewed":
        bm = torch.rand((kt, nt), generator=g, device=device) < 1 / 6
        bm[:, :max(1, nt // 4)] = True
    else:
        bm = torch.rand((kt, nt), generator=g, device=device) < live
    bm[:, -1] = False
    return bm


# (M, K, N, (bk, bn), live): every tile at M = 8 and four live shares, the
# other M at two tiles, M = 4096 at two tiles
BSMM_SPLIT_CASES = [(8, 1024, 1024, t, live)
                    for t in ((128, 128), (32, 32), (16, 16), (8, 128))
                    for live in (1.0, 0.5, 0.1, "skewed")] + [
    (M, 1024, 1024, t, 0.5) for M in (1, 16, 33)
    for t in ((128, 128), (16, 16))] + [
    (4096, 1024, 1024, (128, 128), 0.5), (4096, 1024, 1024, (8, 128), 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BSMM_SPLIT_CASES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_sparse_matmul_split_live_steps(card, case, dtype):
    """The live k16 steps shared across a cluster: within the bound, an
    all-dead strip of non-zero weights exactly zero, the tensor-core body
    for bf16, and two calls equal bit for bit."""
    M, K, N, (bk, bn), live = case
    g = torch.Generator(device=card).manual_seed(M + bk + bn)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    w = torch.randn((K, N), generator=g, device=card).to(DTYPES[dtype])
    bm = _bsmm_mask(g, K, N, bk, bn, live, card)
    reset_launches()
    got = BS.block_sparse_matmul(x, w, bm, block_k=bk, block_n=bn)
    torch.cuda.synchronize()
    assert LAUNCHES["block_sparse_matmul"] == 1
    assert LAUNCHES["block_sparse_matmul_mma"] == int(dtype == "bfloat16")
    ref = BS.block_sparse_matmul_ref(x, w, bm, block_k=bk, block_n=bn)
    assert torch.count_nonzero(got[:, N - bn:]) == 0
    tol = BS.block_sparse_matmul_tolerance(x, w, bm, ref, block_k=bk,
                                           block_n=bn)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    again = BS.block_sparse_matmul(x, w, bm, block_k=bk, block_n=bn)
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 8), (24, 4), (2, 3)], ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_block_sparse_matmul_tiles_off_the_copy_width(card, tile, dtype):
    """Tiles whose rows are not whole 16-byte pieces (bn of 3 or 4 bf16)
    or not whole k16 steps (bk 8, 24 or 2) take the single-load staging
    or zero-filled rows inside a step, and agree with the plain version."""
    bk, bn = tile
    K, N = 48 * bk, 40 * bn
    g = torch.Generator(device=card).manual_seed(bk * 100 + bn)
    x = torch.randn((8, K), generator=g, device=card).to(DTYPES[dtype])
    w = torch.randn((K, N), generator=g, device=card).to(DTYPES[dtype])
    bm = _bsmm_mask(g, K, N, bk, bn, 0.3, card)
    got = BS.block_sparse_matmul(x, w, bm, block_k=bk, block_n=bn)
    ref = BS.block_sparse_matmul_ref(x, w, bm, block_k=bk, block_n=bn)
    tol = BS.block_sparse_matmul_tolerance(x, w, bm, ref, block_k=bk,
                                           block_n=bn)
    assert torch.count_nonzero(got[:, N - bn:]) == 0
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


# ---------------------------------------------------------------------------
# repaired faults: F2 (K3's out-of-range index), F3 (K5 at head_dim 192)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("idx_dtype", ["int8", "int32"])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_clustered_matmul_out_of_range_index_weighs_zero(card, idx_dtype,
                                                        dtype):
    """Indices C and -1 give weight 0 in the kernel, as in the plain version
    and the Pallas kernel."""
    g = torch.Generator(device=card).manual_seed(7)
    M, K, N, C = 8, 256, 128, 4
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    idx = torch.randint(0, C, (K, N), generator=g, device=card)
    idx[::3, 0] = C
    idx[1::3, 0] = -1
    idx[::5, 7] = C + 1
    idx = idx.to(getattr(torch, idx_dtype))
    cb = torch.randn((K, C), generator=g, device=card)
    got = CM.clustered_matmul(x, idx, cb)
    ref = CM.clustered_matmul_ref(x, idx, cb)
    keep = (idx >= 0) & (idx < C)
    dense = torch.gather(cb, 1, idx.long().clamp(0, C - 1)) * keep
    assert torch.equal(ref, (x.float() @ dense).to(x.dtype))
    tol = CM.clustered_matmul_tolerance(x, idx, cb, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("T_len", [512, 333])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_head_dim_192(card, T_len, dtype):
    """nemotron-4-340b's head_dim 192 at its head counts (96 q, 8 KV),
    causal, T = 512 and a ragged 333: bf16 through the wgmma body (3 TMA
    boxes of 64 a row), float32 through the CUDA-core body."""
    g = torch.Generator(device=card).manual_seed(T_len)
    dt = DTYPES[dtype]
    q = torch.randn((1, T_len, 96, 192), generator=g, device=card).to(dt)
    k = torch.randn((1, T_len, 8, 192), generator=g, device=card).to(dt)
    v = torch.randn((1, T_len, 8, 192), generator=g, device=card).to(dt)
    wgmma = dt == torch.bfloat16
    assert FA.takes_wgmma(q, k, v) == wgmma
    reset_launches()
    got = FA.flash_attention(q, k, v)
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention"],
            LAUNCHES["flash_attention_wgmma"]) == (1, int(wgmma))
    ref = FA.flash_attention_plain(q, k, v)
    tol = FA.flash_attention_bound(q, k, v, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


# ---------------------------------------------------------------------------
# the executable observatory on the card: every wrapper traced and untraced
# ---------------------------------------------------------------------------


def _traced_cases(device):
    """site -> a thunk calling one kernel wrapper on the card at a small
    shape (arguments made once, so both laps see the same inputs)."""
    g = torch.Generator(device=device).manual_seed(11)

    def normal(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g, device=device).to(dtype)

    bf = torch.bfloat16
    qm = (normal(8, 256, dtype=bf),
          torch.randint(-127, 128, (256, 384), generator=g, device=device,
                        dtype=torch.int8),
          normal(384).abs() + 0.01)
    cm = (normal(8, 256, dtype=bf),
          torch.randint(0, 16, (256, 384), generator=g, device=device,
                        dtype=torch.int8), normal(256, 16))
    mask = torch.rand((2, 3), generator=g, device=device) < 0.5
    mask[0, 0] = True
    bs = (normal(8, 256, dtype=bf), normal(256, 384, dtype=bf), mask)
    fa = (normal(2, 128, 4, 64, dtype=bf), normal(2, 128, 2, 64, dtype=bf),
          normal(2, 128, 2, 64, dtype=bf))
    ss = ssm_inputs(g, 2, 64, 256, 16, bf, device)
    fa_o, fa_lse = FA.flash_attention_with_lse(*fa)
    fa_do, ss_dy = normal(2, 128, 4, 64, dtype=bf), normal(2, 64, 256,
                                                          dtype=bf)
    _, ss_states = SS.ssm_scan_with_states(*ss)
    rng = np.random.default_rng(5)
    smem_pop = NS.pack_population(CASES["mixed"][0]())
    smem_x = torch.as_tensor(rng.integers(0, 16, (smem_pop.n_candidates,
                                                  300, 7)), device=device)
    glob_pop = NS.pack_population(CASES["past_smem"][0]())
    glob_x = torch.as_tensor(rng.integers(0, 16, (1, 100, 16)),
                             device=device)
    qme = (normal(4, 6, 256, dtype=bf),
           torch.randint(-127, 128, (4, 256, 384), generator=g,
                         device=device, dtype=torch.int8),
           normal(384).abs() + 0.01)
    return {
        "kernels.quant_matmul": lambda: QM.quant_matmul(*qm),
        "kernels.quant_matmul_experts": lambda: QM.quant_matmul_experts(
            *qme),
        "kernels.clustered_matmul": lambda: CM.clustered_matmul(*cm),
        "kernels.block_sparse_matmul": lambda: BS.block_sparse_matmul(
            *bs, block_k=128, block_n=128),
        "kernels.flash_attention": lambda: FA.flash_attention(*fa),
        "kernels.ssm_scan": lambda: SS.ssm_scan(*ss),
        "kernels.flash_attention_bwd": lambda: FA.flash_attention_bwd(
            *fa, fa_o, fa_do, fa_lse)[0],
        "kernels.ssm_scan_bwd": lambda: SS.ssm_scan_bwd(*ss, ss_dy,
                                                        ss_states)[0],
        "kernels.netlist_sim.smem": lambda: NS.netlist_sim(smem_pop,
                                                           smem_x)[0],
        "kernels.netlist_sim.global": lambda: NS.netlist_sim(glob_pop,
                                                             glob_x)[0],
    }


TRACED_SITES = ["kernels.quant_matmul", "kernels.quant_matmul_experts",
                "kernels.clustered_matmul",
                "kernels.block_sparse_matmul", "kernels.flash_attention",
                "kernels.ssm_scan", "kernels.flash_attention_bwd",
                "kernels.ssm_scan_bwd", "kernels.netlist_sim.smem",
                "kernels.netlist_sim.global"]


def _as_bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else t


@pytest.mark.cuda
@pytest.mark.parametrize("site", TRACED_SITES)
def test_kernel_wrapper_traced_equals_untraced_and_is_recorded(card, site,
                                                               tmp_path):
    """Tracing a wrapper leaves its output bit for bit; its registry record
    has one dispatch, CUDA-event ms, the kernel's analytic (non-zero)
    operations and bytes, the library's size, and no recompile."""
    from repro_torch.obs import prof as PF
    from repro_torch.obs import trace as TR
    call = _traced_cases(card)[site]
    prev, TR._tracer = TR._tracer, None
    try:
        base = call().clone()
        torch.cuda.synchronize()
    finally:
        TR._tracer = prev
    PF.reset()
    reset_launches()
    with TR.capture(tmp_path / "t.jsonl"):
        traced = call()
    assert sum(LAUNCHES.values()) >= 1
    assert torch.equal(_as_bits(base), _as_bits(traced))
    recs = [r for r in PF.REGISTRY.executables.values()
            if r["site"] == site]
    assert len(recs) == 1, PF.REGISTRY.executables
    (rec,) = recs
    assert rec["dispatches"] == 1 and rec["device_ms"] > 0
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert rec["generated_code_size_in_bytes"] > 0
    assert rec["output_size_in_bytes"] > 0 and "error" not in rec
    assert all(r["compiles"] <= 1
               for r in PF.REGISTRY.executables.values())
    PF.reset()


@pytest.mark.cuda
def test_cuda_state_round_trips_through_checkpoints(card, tmp_path):
    from repro_torch.ckpt import CheckpointManager
    g = torch.Generator(device=card).manual_seed(2)
    state = {"w": torch.randn((64, 33), generator=g, device=card).to(
        torch.bfloat16),
        "step": torch.randint(-2 ** 62, 2 ** 62, (5,), generator=g,
                              device=card, dtype=torch.int64)}
    mgr = CheckpointManager(tmp_path, async_write=True)
    mgr.save(1, state, meta={"k": 1}, block=True)
    mgr.wait()
    like = {"w": torch.empty(0, device=card),
            "step": torch.empty(0, device=card)}
    got, meta = mgr.restore(like=like)
    assert meta == {"k": 1}
    for k in state:
        assert got[k].device == state[k].device
        assert got[k].dtype == state[k].dtype
        assert torch.equal(_as_bits(got[k]), _as_bits(state[k]))


# ---------------------------------------------------------------------------
# the backward kernels of K5 and K6, and gradients on the card
# ---------------------------------------------------------------------------

# name: (B, T, S, H, KV, hd, causal, window, softcap, dtype): every head_dim
# in both types where the tiles differ (64-row tiles to hd 128, 32-row ones
# at 192 and 256), ragged T and S, non-causal S past T, windows, softcaps,
# GQA groups of 1 to 8
BWD_CASES = {
    "hd16_f32_g2": (2, 50, 50, 4, 2, 16, True, 0, 0.0, "float32"),
    "hd32_f32_softcap": (1, 77, 77, 4, 1, 32, True, 0, 30.0, "float32"),
    "hd64_bf16_noncausal": (2, 100, 150, 4, 2, 64, False, 0, 0.0,
                            "bfloat16"),
    "hd128_bf16_g2": (2, 300, 300, 16, 8, 128, True, 0, 0.0, "bfloat16"),
    "hd128_f32_window": (1, 200, 200, 4, 2, 128, True, 64, 0.0, "float32"),
    "hd192_bf16_g6": (1, 130, 130, 12, 2, 192, True, 0, 0.0, "bfloat16"),
    "hd256_bf16_window_softcap": (1, 300, 300, 8, 4, 256, True, 100, 50.0,
                                  "bfloat16"),
    "hd256_f32_g8": (1, 70, 70, 8, 1, 256, True, 0, 0.0, "float32"),
    # the training shapes of the later families at small T: the vision
    # cross layers (hd 128, non-causal over 1601 patches), whisper's cross
    # attention (hd 64 over 1500 frames), recurrentgemma-9b's local layers
    # (hd 256, MQA: one kv head for 16) and MLA's (hd 192, a kv head a head)
    "hd128_bf16_noncausal_cross": (2, 64, 1601, 32, 8, 128, False, 0, 0.0,
                                   "bfloat16"),
    "hd64_bf16_noncausal_cross": (2, 70, 1500, 8, 8, 64, False, 0, 0.0,
                                  "bfloat16"),
    "hd256_bf16_mqa_g16_window": (1, 300, 300, 16, 1, 256, True, 128, 0.0,
                                  "bfloat16"),
    "hd192_bf16_g1": (1, 200, 200, 16, 16, 192, True, 0, 0.0, "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(BWD_CASES))
def test_flash_attention_bwd_kernel_matches_plain(card, case):
    """K5's lse and its backward kernel against their plain versions within
    `flash_attention_lse_tolerance` and `flash_attention_bwd_tolerance`;
    autograd through `flash_attention` gives the kernel's gradients; a
    rerun is equal to the bit (no atomics)."""
    B, Tq, S, H, KV, hd, causal, window, cap, dtype = BWD_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + S + hd)
    dt = DTYPES[dtype]
    q, do = (torch.randn((B, Tq, H, hd), generator=g, device=card).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=card).to(dt)
            for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap)
    o, lse = FA.flash_attention_with_lse(q, k, v, **kw)
    lse_ref = FA.flash_attention_lse_plain(q, k, v, **kw)
    assert bool(((lse - lse_ref).abs() <= FA.flash_attention_lse_tolerance(
        q, k, lse_ref, softcap=cap)).all())
    _check_flash_bwd(q, k, v, do, kw, FA.takes_wgmma_bwd(q, k, v, o, do))


def _check_flash_bwd(q, k, v, do, kw, wgmma):
    """K5's backward on these inputs: the body the counters name, the
    gradients within `flash_attention_bwd_tolerance` of the plain
    version's, a rerun equal to the bit, autograd's gradients equal to the
    kernel's."""
    o, lse = FA.flash_attention_with_lse(q, k, v, **kw)
    reset_launches()
    got = FA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention_bwd"],
            LAUNCHES["flash_attention_bwd_wgmma"]) == (1, int(wgmma))
    ref = FA.flash_attention_bwd_plain(q, k, v, o, do, lse, **kw)
    for a, b, tol in zip(got, ref, FA.flash_attention_bwd_tolerance(
            q, k, v, o, do, lse, ref, **kw)):
        assert a.dtype == q.dtype and a.shape == b.shape
        assert bool(((a.float() - b.float()).abs() <= tol).all())
    again = FA.flash_attention_bwd(q, k, v, o, do, lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # leaves with the views' strides, so that autograd takes the same body
    qq, kk, vv = (torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                                      device=x.device).copy_(x)
                  .requires_grad_(True) for x in (q, k, v))
    out = FA.flash_attention(qq, kk, vv, **kw)
    assert out.grad_fn is not None
    out.backward(do)
    assert all(torch.equal(x.grad, y) for x, y in zip((qq, kk, vv), got))


# name: (B, T, H, KV, hd, window, softcap, views), bf16 and causal, all
# through the backward's wgmma body: head_dim 64 and 128, GQA groups of 1,
# 2 and 4, T not a multiple of the 64-row tiles, a window, a softcap, and
# q, k, v as strided views TMA still reads (q a head slice of a wider
# tensor, k and v halves of one fused tensor)
WGMMA_BWD_CASES = {
    "hd64_g2_t100": (2, 100, 4, 2, 64, 0, 0.0, False),
    "hd64_g4_window_softcap": (1, 333, 8, 2, 64, 50, 30.0, False),
    "hd64_g1_views": (2, 130, 4, 4, 64, 0, 0.0, True),
    "hd128_g2_t1000": (1, 1000, 16, 8, 128, 0, 0.0, False),
    "hd128_g4_t77": (3, 77, 8, 2, 128, 0, 0.0, False),
    "hd128_g2_window": (1, 700, 8, 4, 128, 256, 0.0, False),
    "hd128_g4_softcap_views": (2, 300, 8, 2, 128, 0, 50.0, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA_BWD_CASES))
def test_flash_attention_bwd_wgmma_body_matches_plain(card, case):
    B, Tq, H, KV, hd, window, cap, views = WGMMA_BWD_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + H + hd)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(
            torch.bfloat16)

    if views:
        q = randn(B, Tq, H + 2, hd)[:, :, 1:H + 1]
        kv = randn(B, Tq, 2 * KV, hd)
        k, v = kv[:, :, :KV], kv[:, :, KV:]
    else:
        q, k, v = randn(B, Tq, H, hd), randn(B, Tq, KV, hd), \
            randn(B, Tq, KV, hd)
    do = randn(B, Tq, H, hd)
    kw = dict(causal=True, window=window, softcap=cap)
    assert FA.takes_wgmma_bwd(q, k, v, q, do)
    _check_flash_bwd(q, k, v, do, kw, True)


# name: (B, T, S, H, KV, hd, causal, window, softcap, v's own head_dim or
# None, views), bf16, all through the backward's two-warpgroup wgmma body:
# head_dim 192 and 256, causal and not, a window, a softcap, GQA groups of
# 1, 2 and 16, one KV head for 16 (the head split over blocks), T not a
# multiple of the 64-row tiles, S beside T, MLA's v zero-padded from 128,
# and strided views TMA still reads
WGMMA2_BWD_CASES = {
    "hd192_g1_mla_padded_v": (1, 333, 333, 16, 16, 192, True, 0, 0.0, 128,
                              False),
    "hd192_g2_noncausal_cross": (2, 100, 257, 8, 4, 192, False, 0, 0.0,
                                 None, False),
    "hd192_g16_kv1_softcap_split": (1, 200, 200, 16, 1, 192, True, 0, 30.0,
                                    None, False),
    "hd256_g2_softcap_t1000": (1, 1000, 1000, 8, 4, 256, True, 0, 50.0,
                               None, False),
    "hd256_g2_window_softcap": (1, 700, 700, 8, 4, 256, True, 256, 50.0,
                                None, False),
    "hd256_g16_kv1_window_split": (1, 1000, 1000, 16, 1, 256, True, 512,
                                   0.0, None, False),
    "hd256_g1_noncausal_views": (2, 130, 130, 4, 4, 256, False, 0, 0.0,
                                 None, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(WGMMA2_BWD_CASES))
def test_flash_attention_bwd_two_warpgroup_body_matches_plain(card, case):
    """K5's backward at head_dim 192 and 256 through the two-warpgroup
    wgmma body, within `flash_attention_bwd_tolerance` of the plain
    version, a rerun equal to the bit, each launch counted in both
    counters; the one-KV-head cases split their 16 heads over blocks
    (`bwd_head_split` > 1)."""
    B, Tq, S, H, KV, hd, causal, window, cap, vd, views = \
        WGMMA2_BWD_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + S + H + hd)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=card).to(
            torch.bfloat16)

    if views:
        q = randn(B, Tq, H + 2, hd)[:, :, 1:H + 1]
        kv = randn(B, S, 2 * KV, hd)
        k, v = kv[:, :, :KV], kv[:, :, KV:]
    else:
        q, k, v = randn(B, Tq, H, hd), randn(B, S, KV, hd), \
            randn(B, S, KV, hd)
    do = randn(B, Tq, H, hd)
    if vd is not None:       # as `attend` pads MLA's v: zero columns of o
        v[..., vd:] = 0
        do[..., vd:] = 0
    kw = dict(causal=causal, window=window, softcap=cap)
    assert FA.takes_wgmma_bwd(q, k, v, q, do)
    sms = torch.cuda.get_device_properties(card).multi_processor_count
    if KV == 1:
        assert FA.bwd_head_split(S, B, H, KV, sms) > 1
    _check_flash_bwd(q, k, v, do, kw, True)


@pytest.mark.cuda
def test_flash_attention_bwd_bodies_by_type_head_dim_and_alignment(card):
    """The backward takes its wgmma body for bf16 at head_dim 64, 128, 192
    and 256 with TMA-readable strides, and its CUDA-core body for float32
    (at 256 too), head_dim 32, and a view whose head stride is not a
    multiple of 16 bytes; every one within the bound."""
    g = torch.Generator(device=card).manual_seed(9)

    def qkv(hd, dt, pad=0):
        full = torch.randn((1, 90, 6, hd + pad), generator=g,
                           device=card).to(dt)
        return (full[:, :, :2, :hd], full[:, :, 2:4, :hd],
                full[:, :, 4:, :hd], full[:, :, :2, :hd].contiguous())

    for hd, dt, pad, wgmma in ((64, torch.bfloat16, 0, True),
                               (128, torch.bfloat16, 0, True),
                               (128, torch.float32, 0, False),
                               (32, torch.bfloat16, 0, False),
                               (192, torch.bfloat16, 0, True),
                               (256, torch.bfloat16, 0, True),
                               (256, torch.float32, 0, False),
                               (64, torch.bfloat16, 4, False),
                               (256, torch.bfloat16, 4, False)):
        q, k, v, do = qkv(hd, dt, pad)
        assert FA.takes_wgmma_bwd(q, k, v, q, do) == wgmma
        _check_flash_bwd(q, k, v, do, dict(causal=True), wgmma)


@pytest.mark.cuda
def test_flash_attention_bwd_matches_autograd_of_the_plain_forward(card):
    """In float32 the kernel's gradient also agrees with autograd of the
    plain forward (the gradient the reference takes of its jnp
    attention), within the same bound."""
    g = torch.Generator(device=card).manual_seed(5)
    q, do = (torch.randn((2, 90, 8, 64), generator=g, device=card)
             for _ in range(2))
    k, v = (torch.randn((2, 90, 2, 64), generator=g, device=card)
            for _ in range(2))
    kw = dict(causal=True, window=40, softcap=30.0)
    qq, kk, vv = (x.clone().requires_grad_(True) for x in (q, k, v))
    FA.flash_attention(qq, kk, vv, **kw).backward(do)
    qp, kp, vp = (x.clone().requires_grad_(True) for x in (q, k, v))
    FA.flash_attention_plain(qp, kp, vp, **kw).backward(do)
    o, lse = FA.flash_attention_with_lse(q, k, v, **kw)
    want = (qp.grad, kp.grad, vp.grad)
    for a, b, tol in zip((qq.grad, kk.grad, vv.grad), want,
                         FA.flash_attention_bwd_tolerance(q, k, v, o, do, lse,
                                                          want, **kw)):
        assert bool(((a - b).abs() <= tol).all())


# name: (B, T, d, N, dtype): falcon-mamba-7b's training width, ragged T
# (chunks of 16), ragged d (blocks of 32 channels), small states, one step
SSM_BWD_CASES = {
    "falcon_train_bf16": (2, 1024, 8192, 16, "bfloat16"),
    "ragged_t_333_f32": (2, 333, 256, 16, "float32"),
    "ragged_d_1000_bf16": (1, 200, 1000, 16, "bfloat16"),
    "state_3_f32": (3, 65, 70, 3, "float32"),
    "one_step_bf16": (2, 1, 40, 16, "bfloat16"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SSM_BWD_CASES))
def test_ssm_scan_bwd_kernel_matches_plain(card, case):
    """K6's backward kernel against `ssm_scan_bwd_plain` within
    `ssm_scan_bwd_tolerance`; autograd through `ssm_scan` gives the
    kernel's gradients; a rerun is equal to the bit."""
    B, Tq, d, N, dtype = SSM_BWD_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + d + N)
    args = ssm_inputs(g, B, Tq, d, N, DTYPES[dtype], card)
    dy = torch.randn((B, Tq, d), generator=g, device=card).to(DTYPES[dtype])
    _, states = SS.ssm_scan_with_states(*args)
    reset_launches()
    got = SS.ssm_scan_bwd(*args, dy, states)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan_bwd"] == 1
    ref = SS.ssm_scan_bwd_plain(*args, dy)
    for a, b, tol in zip(got, ref, SS.ssm_scan_bwd_tolerance(*args, dy,
                                                             ref)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert bool(((a.float() - b.float()).abs() <= tol).all())
    again = SS.ssm_scan_bwd(*args, dy, states)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    leaves = [x.clone().requires_grad_(True) for x in args]
    y = SS.ssm_scan(*leaves)
    assert y.grad_fn is not None
    y.backward(dy)
    assert all(torch.equal(x.grad, w) for x, w in zip(leaves, got))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["falcon_train_bf16", "ragged_t_333_f32",
                                  "state_3_f32", "one_step_bf16"])
def test_ssm_scan_bwd_reads_the_forwards_states(card, case):
    """K6's forward stores its chunk-start states when asked and leaves y
    unchanged to the bit; the states lie within ssm_scan_tolerance's state
    bound (16 eps E_t, its magnitude recurrence) of the plain version's;
    the backward reading them launches no forward, repeats itself to the
    bit, and stays within `ssm_scan_bwd_tolerance` of the plain version."""
    B, Tq, d, N, dtype = SSM_BWD_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + d + N + 1)
    args = ssm_inputs(g, B, Tq, d, N, DTYPES[dtype], card)
    dy = torch.randn((B, Tq, d), generator=g, device=card).to(DTYPES[dtype])
    reset_launches()
    y, states = SS.ssm_scan_with_states(*args)
    torch.cuda.synchronize()
    assert LAUNCHES["ssm_scan"] == 1
    assert torch.equal(y, SS.ssm_scan(*args))
    assert states.shape == (B, -(-Tq // 16), d, 16)
    want = SS.ssm_scan_states_plain(*args, 16, 16)
    eps = torch.finfo(torch.float32).eps
    uf, dtf, bf = args[0].float(), args[1], args[2].float().abs()
    H = torch.zeros((B, d, N), device=card)
    E = torch.zeros_like(H)
    bound = torch.zeros_like(want)
    for t in range(Tq):
        if t % 16 == 0:
            bound[:, t // 16, :, :N] = 16 * eps * E
        e = torch.exp(dtf[:, t, :, None] * args[4][None])
        inc = (dtf[:, t] * uf[:, t]).abs()[..., None] * bf[:, t, None, :]
        E = e * E + H + inc
        H = e * H + inc
    assert bool(((states - want).abs() <= bound).all())
    reset_launches()
    got = SS.ssm_scan_bwd(*args, dy, states)
    torch.cuda.synchronize()
    assert (LAUNCHES["ssm_scan"], LAUNCHES["ssm_scan_bwd"]) == (0, 1)
    again = SS.ssm_scan_bwd(*args, dy, states)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    ref = SS.ssm_scan_bwd_plain(*args, dy)
    for a, b, tol in zip(got, ref, SS.ssm_scan_bwd_tolerance(*args, dy,
                                                             ref)):
        assert bool(((a.float() - b.float()).abs() <= tol).all())


@pytest.mark.cuda
def test_kernels_without_a_backward_refuse_a_gradient(card):
    """K2, K3 and K4 have no backward kernel: on CUDA they raise when grad
    mode is on and an input requires grad, and run under no_grad."""
    x = torch.ones((2, 64), device=card, requires_grad=True)
    w8 = torch.ones((64, 8), dtype=torch.int8, device=card)
    idx = torch.zeros((64, 8), dtype=torch.int8, device=card)
    cb = torch.ones((64, 4), device=card)
    w = torch.ones((64, 32), device=card)
    bm = torch.ones((2, 1), dtype=torch.bool, device=card)
    calls = {"quant_matmul": lambda a: QM.quant_matmul(
        a, w8, torch.ones(8, device=card)),
        "clustered_matmul": lambda a: CM.clustered_matmul(a, idx, cb),
        "block_sparse_matmul": lambda a: BS.block_sparse_matmul(
            a, w, bm, block_k=32, block_n=32)}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match=f"{name} has no backward"):
            call(x)
        with torch.no_grad():
            assert call(x).is_cuda
        assert call(x.detach()).grad_fn is None


@pytest.mark.cuda
def test_k5_and_k6_outputs_always_carry_a_gradient(card):
    """Under grad mode with an input that requires grad, K5's and K6's
    outputs have a grad_fn whatever input requires it; without one they
    launch the forward alone (no lse)."""
    g = torch.Generator(device=card).manual_seed(3)
    q = torch.randn((1, 16, 4, 64), generator=g, device=card)
    k = torch.randn((1, 16, 2, 64), generator=g, device=card)
    for i in range(3):
        xs = [q, k, k.clone()]
        xs[i] = xs[i].clone().requires_grad_(True)
        assert FA.flash_attention(*xs).grad_fn is not None
    assert FA.flash_attention(q, k, k).grad_fn is None
    args = ssm_inputs(g, 1, 20, 64, 16, torch.bfloat16, card)
    for i in range(6):
        xs = list(args)
        xs[i] = xs[i].clone().requires_grad_(True)
        assert SS.ssm_scan(*xs).grad_fn is not None
    assert SS.ssm_scan(*args).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_train_step_through_the_kernels_matches_plain(card, arch,
                                                      monkeypatch):
    """One train step of a small model, float32, through K5 and its
    backward (or K6 and its backward) against the same step through the
    plain versions: float32 end to end, two layers of reordered sums, so
    loss and grad_norm within 1e-4 relative and the parameters within
    1e-5 + 2.2 lr (Adam moves a parameter by about lr whatever its
    gradient's size, and a gradient within rounding of 0 can flip it)."""
    from repro_torch.train import train_state as TS
    from repro_torch.train.optimizer import AdamWConfig, tree_leaves
    cfg = ARCHS[arch].reduced(**QUANT_CFG) if arch == "qwen3-0.6b" \
        else ARCHS[arch].reduced(d_model=256)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1)

    def state():
        # the step writes the state it is handed: each run draws its own
        return TS.init_state(torch.Generator(device=card).manual_seed(0),
                             cfg, opt, device=card)

    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 100),
                                     device=card)}
    step = TS.make_train_step(cfg, opt, remat=True)
    reset_launches()
    s1, m1 = step(state(), batch)
    torch.cuda.synchronize()
    L = cfg.num_layers
    if arch == "qwen3-0.6b":
        assert (LAUNCHES["flash_attention"],
                LAUNCHES["flash_attention_bwd"]) == (2 * L, L)
        monkeypatch.setattr(A, "flash_attention", FA.flash_attention_plain)
    else:
        assert (LAUNCHES["ssm_scan"], LAUNCHES["ssm_scan_bwd"]) == (2 * L, L)
        monkeypatch.setattr(S, "ssm_scan", SS.ssm_scan_ref)
    s2, m2 = step(state(), batch)
    for key in ("loss", "grad_norm"):
        assert abs(float(m1[key]) - float(m2[key])) <= 1e-4 * abs(
            float(m2[key]))
    for a, b in zip(tree_leaves(s1.params), tree_leaves(s2.params)):
        assert float((a - b).abs().max()) <= 1e-5 + 2.2 * opt.lr


# ---------------------------------------------------------------------------
# the hybrid and MoE slice: the ring buffer, RG-LRU, MoE
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hd256_g16_window_2048",
                                  "hd256_gemma2_window_4096_softcap_50",
                                  "hd256_window_g2"])
def test_flash_attention_matches_the_banded_path(card, case):
    """K5 with a window against `attention.attend_local_banded`, the JAX
    package's banded path, within the bound stated for its plain
    version."""
    B, Tq, S, H, KV, hd, causal, window, cap = WGMMA_CASES[case]
    g = torch.Generator(device=card).manual_seed(Tq + window)
    q, k, v = (torch.randn(shape, generator=g, device=card).to(
        torch.bfloat16) for shape in ((B, Tq, H, hd), (B, S, KV, hd),
                                      (B, S, KV, hd)))
    kw = dict(causal=True, window=window, softcap=cap)
    got = FA.flash_attention(q, k, v, **kw)
    banded = A.attend_local_banded(q, k, v, window=window, softcap=cap)
    tol = FA.flash_attention_bound(q, k, v, banded, **kw)
    assert bool(((got.float() - banded.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gemma2-2b", "recurrentgemma-9b"])
def test_ring_decode_matches_the_windowed_forward(card, name):
    """Reduced depth, float32, window 16: 40 decode steps through the ring
    buffer (RG-LRU's step-by-step state too) against the last-position
    logits of the cache-free forward, whose local layers run K5 with the
    window; float32 end to end, a few layers of reordered sums."""
    cfg = ARCHS[name].reduced()
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    tok = torch.randint(0, cfg.vocab_size, (2, 40), device=card)
    state = T.init_decode_state(cfg, 2, 40, torch.float32, device=card)
    reset_launches()
    for t in range(40):
        logits, state = T.decode_step(params, state, tok[:, t:t + 1], cfg)
        if t in (16, 27, 39):
            want, _ = T.forward(params, {"tokens": tok[:, :t + 1]}, cfg)
            torch.testing.assert_close(logits[:, 0], want[:, -1], rtol=1e-4,
                                       atol=1e-4)
    torch.cuda.synchronize()
    n_attn = sum(s.mixer in ("attn", "local") for seg in cfg.segments
                 for s in seg.pattern for _ in range(seg.repeats))
    assert LAUNCHES["flash_attention"] == 3 * n_attn


@pytest.mark.cuda
def test_w8_recurrent_decode_goes_through_k2(card, monkeypatch):
    """recurrentgemma-9b at d_model and lru_width 256: K2 takes w_x,
    w_gate, w_out and the MLP (6 a recurrent layer) and the attention and
    MLP products (7 a local one); w_a and w_i are read dequantized. The
    logits equal those through K2's plain version (float32)."""
    from repro_torch.configs.base import RGLRUConfig
    cfg = ARCHS["recurrentgemma-9b"].reduced(
        **dict(QUANT_CFG, num_kv_heads=1, head_dim=128,
               rglru=RGLRUConfig(lru_width=256)))
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    qp = QS.quantize_params(params, bits=8)
    tokens = torch.randint(0, cfg.vocab_size, (8, 20), device=card)
    n_rec = sum(s.mixer == "rec" for seg in cfg.segments
                for s in seg.pattern for _ in range(seg.repeats))
    logits = {}
    for variant in ("kernel", "plain"):
        if variant == "plain":
            monkeypatch.setattr("repro_torch.nn.layers.quant_matmul",
                                QM.quant_matmul_ref)
        state = T.init_decode_state(cfg, 8, 32, torch.float32, device=card)
        reset_launches()
        out = []
        for t in range(tokens.shape[1]):
            lg, state = T.decode_step(qp, state, tokens[:, t:t + 1], cfg)
            out.append(lg)
        torch.cuda.synchronize()
        logits[variant] = torch.cat(out, 1)
        expect = (6 * n_rec + 7 * (cfg.num_layers - n_rec)) * 20
        assert LAUNCHES["quant_matmul"] == (expect if variant == "kernel"
                                            else 0)
    torch.testing.assert_close(logits["kernel"], logits["plain"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dispatch", ["global", "per_sample"])
def test_moe_layer_on_the_card_matches_the_cpu(card, dispatch):
    """phi3.5-moe's MoE layer (reduced, float32) on the card against the
    same layer on the CPU: routing ids and kept slots equal, the output
    within 1e-5 (float32 products of 64 terms, reordered)."""
    import dataclasses
    from repro_torch.nn import moe as MO
    base = ARCHS["phi3.5-moe-42b-a6.6b"].reduced()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, dispatch=dispatch, capacity_factor=0.5))
    params = T.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    p_cpu = T._take(params["segments"][0][0]["moe"], 0)
    p_card = T.map_tree(lambda _, t: t.to(card), p_cpu)
    x = torch.randn((3, 40, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    r_cpu = MO.route_tokens(p_cpu, x.reshape(120, -1), cfg)
    r_card = MO.route_tokens(p_card, x.reshape(120, -1).to(card), cfg)
    for key in ("topi", "st", "slot", "keep"):
        assert torch.equal(r_card[key].cpu(), r_cpu[key]), key
    want, aux_cpu = MO.moe_apply(p_cpu, x, cfg)
    got, aux_card = MO.moe_apply(p_card, x.to(card), cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert abs(float(aux_card) - float(aux_cpu)) <= 1e-6 * float(aux_cpu)


# ---------------------------------------------------------------------------
# MLA, the whisper encoder and cross attention
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("T_len", [1024, 333])
def test_attend_pads_mla_v_through_k5(card, T_len):
    """deepseek-v2's prefill attention: q and k at head_dim 192, v at 128
    (128/128 heads), bf16. `attention.attend` pads v with zero columns to
    192 for one K5 launch through the wgmma body and slices the output;
    held against K5's plain version on the unpadded v."""
    g = torch.Generator(device=card).manual_seed(T_len)
    q, k = (torch.randn((1, T_len, 128, 192), generator=g, device=card).to(
        torch.bfloat16) for _ in range(2))
    v = torch.randn((1, T_len, 128, 128), generator=g, device=card).to(
        torch.bfloat16)
    reset_launches()
    got = A.attend(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (LAUNCHES["flash_attention"],
            LAUNCHES["flash_attention_wgmma"]) == (1, 1)
    ref = FA.flash_attention_plain(q, k, v)
    assert got.shape == v.shape[:2] + (128, 128) == ref.shape
    tol = FA.flash_attention_bound(q, k, v, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


def _encdec_cfg(name, quant=False):
    """Reduced float32 configs whose K5 head_dim is one of the kernel's;
    with ``quant`` every product of the decode quantizes."""
    from repro_torch.configs.base import EncoderConfig, MLAConfig
    if name == "deepseek-v2-236b":
        mla = (MLAConfig(128, 128, 64, 64, 64) if quant
               else MLAConfig(32, 32, 48, 16, 32))
        extra = dict(d_model=512, num_heads=8, num_kv_heads=8, d_ff=256,
                     vocab_size=512) if quant else {}
        return ARCHS[name].reduced(mla=mla, **extra)
    kw = dict(head_dim=64)
    if quant:
        kw.update(vocab_size=512, d_model=256, d_ff=256)
    if name == "whisper-base":
        kw.update(num_kv_heads=4, encoder=EncoderConfig(2, 96))
        if quant:
            kw.update(max_position_embeddings=256)
    return ARCHS[name].reduced(**kw)


def _open_gates(params):
    """Every cross_gate at 0.5 (init leaves them 0, which drops the cross
    sublayer)."""
    return T.map_tree(lambda path, t: torch.full_like(t, 0.5)
                      if "cross_gate" in path else t, params)


def _context(cfg, B, device):
    g = torch.Generator(device=device).manual_seed(3)
    if cfg.encoder is not None:
        return "frames", torch.randn((B, cfg.encoder.num_frames, cfg.d_model),
                                     generator=g, device=device)
    if cfg.vision is not None:
        return "patches", torch.randn((B, cfg.vision.num_patches,
                                       cfg.d_model), generator=g,
                                      device=device)
    return None, None


ENCDEC = ["deepseek-v2-236b", "whisper-base", "llama-3.2-vision-11b"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENCDEC)
def test_mla_and_cross_prefill_goes_through_k5(card, monkeypatch, name):
    """One K5 launch a layer (MLA with v padded), one a cross layer and one
    an encoder layer; the logits against the same forward on K5's plain
    version (float32 end to end: a few layers of reordered sums)."""
    cfg = _encdec_cfg(name)
    params = _open_gates(T.init(torch.Generator(device=card).manual_seed(0),
                                cfg, device=card))
    tokens = torch.randint(0, cfg.vocab_size, (2, 100), device=card)
    batch = {"tokens": tokens}
    key, ctx = _context(cfg, 2, card)
    if key:
        batch[key] = ctx
    reset_launches()
    got, _ = T.forward(params, batch, cfg)
    torch.cuda.synchronize()
    n_cross = sum(s.mixer == "cross" for s in cfg.layer_specs())
    n_enc = cfg.encoder.num_layers if cfg.encoder is not None else 0
    assert LAUNCHES["flash_attention"] == cfg.num_layers + n_cross + n_enc
    monkeypatch.setattr(A, "flash_attention", FA.flash_attention_plain)
    want, _ = T.forward(params, batch, cfg)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


# K2 launches a decode step of `_encdec_cfg(name, quant=True)`: deepseek's
# dense layer 4 MLA products (w_kr, 512 x 64 in one repeat, stays dense)
# and 3 FFN, each MoE layer 5 MLA and the shared expert's 3 (the router's
# 4 columns do not quantize), the LM head; whisper's decoder layers 4
# self, 4 cross, 2 MLP; the vision model's 7 a layer and 4 more a cross
# layer; all plus the LM head
W8_STEP_LAUNCHES = {"deepseek-v2-236b": 7 + 2 * 8 + 1,
                    "whisper-base": 2 * 10 + 1,
                    "llama-3.2-vision-11b": 10 * 7 + 2 * 4 + 1}
# launches of K2's expert body a step: deepseek's 2 MoE layers, 3 products
# each on their w8 stacks (4 experts, 512 x 64 and 64 x 512)
W8_STEP_EXPERT_LAUNCHES = {"deepseek-v2-236b": 2 * 3}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ENCDEC)
def test_mla_and_cross_w8_decode_goes_through_k2(card, monkeypatch, name):
    """The w8 decode at batch 8 over the context (whisper: the encoder's
    output), K2's launches counted, the logits equal to those through K2's
    plain version (float32)."""
    cfg = _encdec_cfg(name, quant=True)
    params = _open_gates(T.init(torch.Generator(device=card).manual_seed(0),
                                cfg, device=card))
    key, ctx = _context(cfg, 8, card)
    if key == "frames":
        ctx = T._encoder_forward(params["encoder"], ctx, cfg, remat=False)
    qp = QS.quantize_params(params, bits=8)
    tokens = torch.randint(0, cfg.vocab_size, (8, 6), device=card)
    logits = {}
    for variant in ("kernel", "plain"):
        if variant == "plain":
            monkeypatch.setattr("repro_torch.nn.layers.quant_matmul",
                                QM.quant_matmul_ref)
            monkeypatch.setattr("repro_torch.nn.moe.quant_matmul_experts",
                                QM.quant_matmul_experts_ref)
        state = T.init_decode_state(cfg, 8, 16, torch.float32, device=card)
        if key:
            state["enc_out"] = ctx
        reset_launches()
        out = []
        for t in range(tokens.shape[1]):
            lg, state = T.decode_step(qp, state, tokens[:, t:t + 1], cfg)
            out.append(lg)
        torch.cuda.synchronize()
        logits[variant] = torch.cat(out, 1)
        expect = W8_STEP_LAUNCHES[name] * tokens.shape[1]
        assert LAUNCHES["quant_matmul"] == (expect if variant == "kernel"
                                            else 0)
        experts = W8_STEP_EXPERT_LAUNCHES.get(name, 0) * tokens.shape[1]
        assert LAUNCHES["quant_matmul_experts"] == (
            experts if variant == "kernel" else 0)
    torch.testing.assert_close(logits["kernel"], logits["plain"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# the planning path: the kernels' meta branches and count_step on the card
# ---------------------------------------------------------------------------


def _kernel_cases(dev):
    """name -> (fn, args): K5 forward and backward through autograd, K2,
    K6 forward and backward, at small model shapes on ``dev``."""
    g = torch.Generator(device="cpu").manual_seed(0)

    def t(*shape, dtype=torch.bfloat16, grad=False):
        x = torch.randn(shape, generator=g).to(dtype).to(dev)
        return x.requires_grad_(grad)

    def k5(q, k, v):
        o = FA.flash_attention(q, k, v, causal=True)
        return torch.autograd.grad(o.float().sum(), (q, k, v))

    def k6(u, dt, B_, C_, A, D):
        y = SS.ssm_scan(u, dt, B_, C_, A, D)
        return torch.autograd.grad(y.float().sum(), (u, dt))

    w = torch.randint(-127, 128, (512, 384), generator=g,
                      dtype=torch.int8).to(dev)
    return {
        "k5": (k5, (t(2, 256, 8, 64, grad=True), t(2, 256, 2, 64, grad=True),
                    t(2, 256, 2, 64, grad=True))),
        "k2": (QM.quant_matmul, (t(16, 512), w,
                                 t(384, dtype=torch.float32).abs())),
        "k2_experts": (QM.quant_matmul_experts, (
            t(4, 6, 512), torch.stack([w] * 4),
            t(384, dtype=torch.float32).abs())),
        "k6": (k6, (t(1, 64, 256, grad=True),
                    t(1, 64, 256, dtype=torch.float32, grad=True).abs(),
                    t(1, 64, 16), t(1, 64, 16),
                    -t(256, 16, dtype=torch.float32).abs(),
                    t(256, dtype=torch.float32))),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k5", "k2", "k2_experts", "k6"])
def test_meta_branch_records_the_cost_of_the_cuda_launch(card, case):
    from repro_torch.roofline import analysis as RA
    fn, args = _kernel_cases(card)[case]
    reset_launches()
    on_card = RA.count_step(fn, *args)
    torch.cuda.synchronize()
    launched = {k: v for k, v in LAUNCHES.items() if v}
    meta_args = [a.detach().to("meta").requires_grad_(a.requires_grad)
                 for a in args]
    reset_launches()
    on_meta = RA.count_step(fn, *meta_args)
    assert not any(LAUNCHES.values())       # the meta branch launches none
    assert on_card.counter.kernels == on_meta.counter.kernels
    assert on_card.counter.flops == on_meta.counter.flops
    for name, rec in on_card.counter.kernels.items():
        assert launched[name] == rec["launches"]
    assert on_card.counter.kernels


@pytest.mark.cuda
@pytest.mark.parametrize("arch,kind", [("qwen3-0.6b", "train"),
                                       ("qwen3-0.6b", "decode"),
                                       ("falcon-mamba-7b", "prefill")])
def test_count_step_on_the_card_equals_the_meta_count(card, arch, kind):
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun as D
    from repro_torch.roofline import analysis as RA
    cfg = ARCHS[arch].reduced(d_model=256, d_ff=512, num_heads=4,
                              num_kv_heads=2, head_dim=64, dtype="bfloat16")
    shape = ShapeConfig("tiny", 128, 2, kind)
    bits = 8 if kind == "decode" else None
    step, args = D.lower_cell(cfg, shape, serve_bits=bits)
    meta = RA.count_step(step, *args)
    step, args = D.lower_cell(cfg, shape, serve_bits=bits, device=card)
    real = RA.count_step(step, *args)
    torch.cuda.synchronize()
    assert real.counter.flops == meta.counter.flops > 0
    assert real.counter.kernels == meta.counter.kernels
    assert real.counter.kernels
    assert RA.memory_dict(real)["temp_bytes"] == \
        RA.memory_dict(meta)["temp_bytes"]


# ---------------------------------------------------------------------------
# K2's packed-int4 bodies: two 4-bit weights a byte
# ---------------------------------------------------------------------------

# QMM_SHAPES and ragged widths: N odd (its last high nibble 0), ceil(N/2)
# no multiple of 16 (single-byte staging), a K not a multiple of a step
QMM_INT4_SHAPES = QMM_SHAPES + [(8, 1024, 1001), (8, 1000, 34),
                                (16, 333, 4097), (3, 77, 65)]


def _int4_inputs(card, M, K, N, dtype, seed):
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    q = torch.randint(-7, 8, (K, N), generator=g, device=card,
                      dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    return x, q, QM.pack_int4(q), s


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 8, 33])
@pytest.mark.parametrize("shape", QMM_INT4_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_matmul_int4_body_matches_plain(card, M, shape, dtype):
    """The packed body at M = 1, 8 and 33 (one and eight n-tiles a block)
    against the plain version on the same packed payload, within
    `quant_matmul_tolerance`; the int4 body taken (and the mma one for
    bf16), two calls equal to the bit, and the int8 body on the unpacked
    values within the same bound."""
    _, K, N = shape
    x, q, packed, s = _int4_inputs(card, M, K, N, dtype, M + 5 * K + N)
    assert packed.shape == (K, (N + 1) // 2) and packed.dtype == torch.uint8
    reset_launches()
    got = QM.quant_matmul(x, packed, s)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul"] == LAUNCHES["quant_matmul_int4"] == 1
    assert LAUNCHES["quant_matmul_mma"] == int(dtype == "bfloat16")
    assert got.dtype == x.dtype and got.shape == (M, N)
    ref = QM.quant_matmul_ref(x, packed, s)
    tol = QM.quant_matmul_tolerance(x, packed, s, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    assert torch.equal(got, QM.quant_matmul(x, packed, s))
    via_int8 = QM.quant_matmul(x, q, s)
    assert bool(((via_int8.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quant_matmul_int4_unaligned_payload(card, dtype):
    """A packed payload view off a 16-byte boundary is staged by single
    loads and agrees with the plain version."""
    g = torch.Generator(device=card).manual_seed(17)
    M, K, N = 8, 1024, 2048
    flat = torch.randint(0, 256, (K * N // 2 + 1,), generator=g,
                         device=card, dtype=torch.uint8)
    w = flat[1:].view(K, N // 2)
    assert w.data_ptr() % 16 != 0
    x = torch.randn((M, K), generator=g, device=card).to(DTYPES[dtype])
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    got = QM.quant_matmul(x, w, s)
    ref = QM.quant_matmul_ref(x, w, s)
    tol = QM.quant_matmul_tolerance(x, w, s, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-0.6b", "falcon-mamba-7b"])
def test_w4_decode_goes_through_the_int4_body(card, arch, monkeypatch):
    """The w4 decode of the reduced models: every K2 launch through the
    packed body, the logits equal to K2's plain version's within float32
    reordering (1e-4), as the w8 tests hold them."""
    cfg = ARCHS[arch].reduced(**(QUANT_CFG if arch == "qwen3-0.6b"
                                 else MAMBA_CFG))
    params = T.init(torch.Generator(device=card).manual_seed(0), cfg,
                    device=card)
    qp = QS.quantize_params(params, bits=4)
    tokens = torch.randint(0, cfg.vocab_size, (8, 6), device=card)
    logits = {}
    for variant in ("kernel", "plain"):
        if variant == "plain":
            monkeypatch.setattr("repro_torch.nn.layers.quant_matmul",
                                QM.quant_matmul_ref)
        state = T.init_decode_state(cfg, 8, 16, torch.float32, device=card)
        reset_launches()
        out = []
        for t in range(tokens.shape[1]):
            lg, state = T.decode_step(qp, state, tokens[:, t:t + 1], cfg)
            out.append(lg)
        torch.cuda.synchronize()
        logits[variant] = torch.cat(out, 1)
        if variant == "kernel":
            assert LAUNCHES["quant_matmul"] > 0
            assert LAUNCHES["quant_matmul_int4"] == LAUNCHES["quant_matmul"]
    torch.testing.assert_close(logits["kernel"], logits["plain"], rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# K2's large-M body (wgmma): bf16 x from wgmma_min_m rows
# ---------------------------------------------------------------------------

def _wide_shapes(packed):
    """(M, K, N) the large-M body takes: the vision and whisper cross K/V
    projections, the threshold and M = 1000 at qwen3-0.6b's gate/up
    (1024, 3072), a ragged N (int8 1040; packed 1023, odd, 512 bytes a
    row) and a ragged M (777)."""
    first = QMO.wgmma_min_m(packed)
    return [(12808, 4096, 1024), (12000, 512, 512), (first, 1024, 3072),
            (1000, 1024, 3072), (first, 512, 1023 if packed else 1040),
            (777, 1024, 1024)]


WIDE_CASES = [(packed, i) for packed in (False, True) for i in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("packed,case", WIDE_CASES,
                         ids=[f"{'packed' if p else 'int8'}-{i}"
                              for p, i in WIDE_CASES])
def test_quant_matmul_wgmma_body_matches_plain(card, packed, case):
    """The large-M body against the plain version within the unchanged
    `quant_matmul_tolerance`, one launch counted in
    ``LAUNCHES["quant_matmul_wgmma"]`` a call, equal to the bit on a rerun;
    an x view off a 16-byte boundary takes the decode body, and so does
    one row fewer than the threshold."""
    M, K, N = _wide_shapes(packed)[case]
    g = torch.Generator(device=card).manual_seed(M + 7 * K + N)
    x = torch.randn((M, K), generator=g, device=card).to(torch.bfloat16)
    q = torch.randint(-8 if packed else -127, 8 if packed else 128, (K, N),
                      generator=g, device=card, dtype=torch.int8)
    w = QM.pack_int4(q) if packed else q
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    assert QMO.body_for(M, K, N, x.dtype, packed, True) == "wgmma"
    reset_launches()
    got = QM.quant_matmul(x, w, s)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul"] == LAUNCHES["quant_matmul_wgmma"] == 1
    assert LAUNCHES["quant_matmul_mma"] == 0
    assert LAUNCHES["quant_matmul_int4"] == int(packed)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    ref = QM.quant_matmul_ref(x, w, s)
    tol = QM.quant_matmul_tolerance(x, w, s, ref)
    assert bool(((got.float() - ref.float()).abs() <= tol).all())
    assert torch.equal(got, QM.quant_matmul(x, w, s))
    assert LAUNCHES["quant_matmul_wgmma"] == 2
    flat = torch.empty(M * K + 8, dtype=x.dtype, device=card)
    xu = flat[1:1 + M * K].view(M, K)
    xu.copy_(x)
    reset_launches()
    got_u = QM.quant_matmul(xu, w, s)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul_mma"] == 1
    assert LAUNCHES["quant_matmul_wgmma"] == 0
    assert bool(((got_u.float() - ref.float()).abs() <= tol).all())
    if M == QMO.wgmma_min_m(packed):
        reset_launches()
        QM.quant_matmul(x[1:], w, s)
        assert LAUNCHES["quant_matmul_wgmma"] == 0
        assert LAUNCHES["quant_matmul_mma"] == 1


# ---------------------------------------------------------------------------
# K2's expert body: an MoE layer's expert products in one launch
# ---------------------------------------------------------------------------

# name: (E, C, K, N, bits, x dtype): deepseek-v2's gate/up (5120, 1536) and
# down (1536, 5120) stacks at the decode's C = 6 and the cache fill's 192
# (three 64-row tiles a block); phi3.5-moe's (4096, 6400) at batch 128's
# C = 20; ragged C, K and N (byte loads of x and of the payload, an odd N
# packed); float32 x on the CUDA cores over two row tiles under a split-K
# cluster; a lone expert, whose 24 or 96 strips take a cluster (the tiles
# of C = 192 one after the other in it)
EXPERT_CASES = {
    f"deepseek_{name}_c{C}_int{bits}": (160, C, K, N, bits, "bfloat16")
    for name, K, N in (("gate", 5120, 1536), ("down", 1536, 5120))
    for C in (6, 192) for bits in (8, 4)}
EXPERT_CASES.update({
    "phimoe_c20_int8": (16, 20, 4096, 6400, 8, "bfloat16"),
    "phimoe_c20_int4": (16, 20, 4096, 6400, 4, "bfloat16"),
    "ragged_bf16_int8": (7, 70, 1000, 777, 8, "bfloat16"),
    "ragged_bf16_int4": (7, 70, 1000, 777, 4, "bfloat16"),
    "ragged_f32_int8": (5, 13, 512, 300, 8, "float32"),
    "ragged_f32_int4": (5, 13, 512, 301, 4, "float32"),
    "split_f32_int8": (2, 100, 2048, 256, 8, "float32"),
    "one_expert_c6": (1, 6, 5120, 1536, 8, "bfloat16"),
    "one_expert_c192": (1, 192, 5120, 1536, 8, "bfloat16"),
})


def _expert_inputs(card, E, C, K, N, bits, dtype, seed):
    """x (E, C, K), the stack's payload (int8, or uint8 two 4-bit values a
    byte) and one scale vector for every expert."""
    g = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((E, C, K), generator=g, device=card).to(DTYPES[dtype])
    top = 127 if bits == 8 else 7
    q = torch.randint(-top, top + 1, (E, K, N), generator=g, device=card,
                      dtype=torch.int8)
    s = (torch.rand((N,), generator=g, device=card) + 0.1) * 0.01
    return x, (q if bits == 8 else QM.pack_int4(q)), s


def _experts_within_tolerance(got, x, w, s):
    """Each expert's product within `quant_matmul_tolerance` of the plain
    version (one expert at a time: the bound's float32 stack would be 5 GB
    at deepseek-v2's shape)."""
    ref = QM.quant_matmul_experts_ref(x, w, s)
    for e in range(x.shape[0]):
        tol = QM.quant_matmul_tolerance(x[e], w[e], s, ref[e])
        assert bool(((got[e].float() - ref[e].float()).abs() <= tol).all()), e


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(EXPERT_CASES))
def test_quant_matmul_experts_matches_plain(card, case):
    """K2's expert body against its plain version, expert by expert within
    `quant_matmul_tolerance`; one launch, counted in
    ``quant_matmul_experts`` (and ``quant_matmul_mma`` for bf16 x,
    ``quant_matmul_int4`` for a packed payload), none in ``quant_matmul``;
    equal to the bit on a rerun."""
    E, C, K, N, bits, dtype = EXPERT_CASES[case]
    x, w, s = _expert_inputs(card, E, C, K, N, bits, dtype, E + C + K + N)
    reset_launches()
    got = QM.quant_matmul_experts(x, w, s)
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul_experts"] == 1
    assert LAUNCHES["quant_matmul"] == 0
    assert LAUNCHES["quant_matmul_mma"] == int(dtype == "bfloat16")
    assert LAUNCHES["quant_matmul_int4"] == int(bits == 4)
    assert got.dtype == x.dtype and got.shape == (E, C, N)
    _experts_within_tolerance(got, x, w, s)
    again = QM.quant_matmul_experts(x, w, s)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_quant_matmul_experts_never_falls_back_on_cuda(card, monkeypatch):
    """On CUDA tensors the wrapper launches the kernel and never runs its
    plain version; the inputs it cannot take raise."""
    def forbidden(*a, **k):
        raise AssertionError("plain version used on CUDA")

    monkeypatch.setattr(QMO, "quant_matmul_experts_ref", forbidden)
    x, w, s = _expert_inputs(card, 2, 3, 64, 32, 8, "bfloat16", 1)
    assert QM.quant_matmul_experts(x, w, s).is_cuda
    torch.cuda.synchronize()
    with pytest.raises(ValueError):
        QM.quant_matmul_experts(x.transpose(1, 2).contiguous()
                                .transpose(1, 2), w, s)
    with pytest.raises(ValueError):
        QM.quant_matmul_experts(x, w[:1], s)
    with pytest.raises(TypeError):
        QM.quant_matmul_experts(x.half(), w, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_quantized_moe_layer_takes_one_expert_launch_a_product(card,
                                                               monkeypatch,
                                                               dtype):
    """phi3.5-moe's MoE layer (reduced) with w8 stacks on the card: one
    launch of K2's expert body a product, three a layer, no dequantized
    stack; float32 equal to the same layer through the plain version
    within the layer's float32 reordering (1e-5), bf16 finite."""
    import dataclasses
    from repro_torch.nn import layers as L
    from repro_torch.nn import moe as MO
    cfg = ARCHS["phi3.5-moe-42b-a6.6b"].reduced(dtype=dtype)
    p = MO.moe_init(torch.Generator(device=card).manual_seed(2), cfg,
                    cfg.dtype, device=card)
    # the layer's stacks at w8 as `serve.quantized` stores them: one scale
    # a column over every expert and row
    for k, w in list(p["experts"].items()):
        scale = w.float().abs().amax(dim=(0, 1)).clamp_min(1e-12) / 127
        p["experts"][k] = {"q": torch.round(w.float() / scale).to(
            torch.int8), "scale": scale}
    real = L.real
    monkeypatch.setattr(L, "real", lambda leaf, dt: (
        pytest.fail("a stack was dequantized") if L.is_qleaf(leaf)
        else real(leaf, dt)))
    x = torch.randn((2, 24, cfg.d_model),
                    generator=torch.Generator(device=card).manual_seed(3),
                    device=card).to(L.torch_dtype(dtype))
    reset_launches()
    got, _ = MO.moe_apply(p, x, dataclasses.replace(cfg))
    torch.cuda.synchronize()
    assert LAUNCHES["quant_matmul_experts"] == 3
    assert LAUNCHES["quant_matmul_mma"] == 3 * int(dtype == "bfloat16")
    assert bool(torch.isfinite(got).all())
    if dtype == "float32":
        monkeypatch.setattr(MO, "quant_matmul_experts",
                            QM.quant_matmul_experts_ref)
        want, _ = MO.moe_apply(p, x, cfg)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
