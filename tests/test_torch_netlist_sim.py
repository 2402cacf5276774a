"""The port's population netlist simulation against the numpy oracle and
the reference's engines (`repro.kernels.netlist_sim`: ``levels`` and the
Pallas kernel in interpret mode), mirroring the cases of
``tests/test_netlist_sim.py``. Everything here is integer: bit-exact or
wrong. On CPU tensors the kernel wrapper runs its plain version, so the
CUDA kernel's launch count must stay 0; the kernel itself is checked
against the plain version by the card-only tests at the bottom."""
import jax

if not hasattr(jax.experimental, "enable_x64"):
    # jax >= 0.9 moved the name to jax.enable_x64; the reference imports it
    # from jax.experimental (circuit/simulate.py, kernels/netlist_sim/ops.py)
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from repro import circuit as RCIRC  # noqa: E402
from repro.core import minimize as RMZ  # noqa: E402
from repro.kernels import netlist_sim as RNS  # noqa: E402
from repro_torch import circuit as TCIRC  # noqa: E402
from repro_torch.circuit import ir as TIR  # noqa: E402
from repro_torch.configs.printed_mlp import PRINTED_MLPS  # noqa: E402
from repro_torch.core import minimize as TMZ  # noqa: E402
from repro_torch.kernels import LAUNCHES, reset_launches  # noqa: E402
from repro_torch.kernels import netlist_sim as TNS  # noqa: E402


def synth(dims, bits=5, *, sparsity=0.0, clusters=None, seed=0,
          in_bits=8):
    """Random integer weights on the quantization grid, as both packages'
    CompiledMLP (same numpy arrays), and the two packages' netlists."""
    r = np.random.default_rng(seed)
    q_layers, scales, biases, cls, w_bits = [], [], [], [], []
    for d_in, d_out in zip(dims[:-1], dims[1:]):
        qmax = 2 ** (bits - 1) - 1
        if clusters:
            cb = r.integers(-qmax, qmax + 1, (d_in, clusters)).astype(
                np.int64)
            idx = r.integers(0, clusters, (d_in, d_out))
            q = np.take_along_axis(cb, idx, axis=1)
            q = q * (r.random((d_in, d_out)) >= sparsity)
            cls.append((idx, cb))
        else:
            q = r.integers(-qmax, qmax + 1, (d_in, d_out)).astype(np.int64)
            q[r.random((d_in, d_out)) < sparsity] = 0
            cls.append(None)
        q_layers.append(q)
        scales.append(float(r.uniform(0.002, 0.02)))
        biases.append(r.normal(0, 0.3, d_out).astype(np.float32))
        w_bits.append(bits)
    args = (q_layers, scales, biases, cls, w_bits, in_bits)
    c_r, c_t = RMZ.CompiledMLP(*args), TMZ.CompiledMLP(*args)
    return RCIRC.compile_netlist(c_r), TCIRC.compile_netlist(c_t), c_t


def _check_all_engines(rnets, tnets, x, *, pallas=True, **kw):
    """Port levels / port wrapper (CPU) == oracle == reference engines."""
    rpop, tpop = RNS.pack_population(rnets), TNS.pack_population(tnets)
    for f in ("op", "arg_a", "arg_b", "shift", "val", "level_ptr",
              "input_pos", "argmax_pos", "n_nodes"):
        np.testing.assert_array_equal(getattr(tpop, f), getattr(rpop, f))
    assert tpop.max_width == rpop.max_width
    oracle = TNS.simulate_population_ref(tpop, x)
    ref_oracle = RNS.simulate_population_ref(rpop, x)
    np.testing.assert_array_equal(oracle["amx"], ref_oracle["amx"])
    reset_launches()
    outs = [TNS.simulate_population(tpop, x, engine="levels", device="cpu",
                                    **kw),
            TNS.simulate_population(tpop, x, device="cpu", **kw),
            RNS.simulate_population(rpop, x, engine="levels")]
    if pallas:
        outs.append(RNS.simulate_population(rpop, x, engine="pallas",
                                            interpret=True))
    assert LAUNCHES["netlist_sim"] == 0       # CPU tensors: plain version
    for out in outs:
        np.testing.assert_array_equal(out["amx"], oracle["amx"])
        np.testing.assert_array_equal(out["argmax"], oracle["argmax"])
    return tpop, oracle


def test_mixed_size_padded_population_bit_exact():
    nets = [synth(d, 5, seed=i) for i, d in enumerate(
        [(7, 3, 3), (7, 28, 3), (7, 14, 14, 3), (7, 5, 3)])]
    sizes = [len(n[1]) for n in nets]
    assert max(sizes) / min(sizes) > 3     # genuinely mixed-size launch
    x = np.random.default_rng(7).integers(0, 2 ** 4, (23, 7))
    _check_all_engines([n[0] for n in nets], [n[1] for n in nets], x)


def test_many_waves_bit_exact():
    nets = [synth((6, 9, 4), 4, seed=s, clusters=3) for s in (0, 1)]
    x = np.random.default_rng(8).integers(0, 2 ** 4, (11, 6))
    tpop, oracle = _check_all_engines([n[0] for n in nets],
                                      [n[1] for n in nets], x, window=8)
    sched = TNS.ops._global_schedule(tpop, 8)
    assert sched.OP.shape[0] > int(tpop.n_levels.max())   # multi-wave


def test_batch_not_a_block_multiple_bit_exact():
    _, tnet, _ = synth((5, 6, 3), 4, seed=2, sparsity=0.3)
    rnet = synth((5, 6, 3), 4, seed=2, sparsity=0.3)[0]
    for B in (1, TNS.ops.BLOCK - 1, TNS.ops.BLOCK + 1, 3 * TNS.ops.BLOCK + 5):
        x = np.random.default_rng(B).integers(0, 2 ** 8, (B, 5))
        _check_all_engines([rnet], [tnet], x, pallas=B < 80)


def test_width32_net_int32_lanes_bit_exact():
    """A net whose widest word is exactly 32 bits stays on int32 lanes."""
    nets = []
    for Ir in (RCIRC.ir, TIR):
        net = Ir.Netlist(in_bits=8, w_bits=[8])
        a = net.shl(net.input(0), 23)
        b = net.shl(net.input(1), 23)
        net.layer_pre_ids = [[a, b]]
        net.output_ids = [a, b]
        net.argmax([a, b])
        nets.append(net)
    x = np.array([[255, 200], [1, 255], [0, 0], [254, 255]], np.int64)
    tpop, oracle = _check_all_engines([nets[0]], [nets[1]], x)
    assert tpop.max_width == 32
    assert TNS.ops.lane_dtype(tpop) == torch.int32
    np.testing.assert_array_equal(oracle["amx"][0],
                                  np.stack([x[:, 0] << 23, x[:, 1] << 23], 1))


def test_wide_population_int64_lanes_bit_exact():
    nets = [synth((11, 12, 12, 7), 8, seed=3), synth((11, 5, 7), 8, seed=4)]
    x = np.random.default_rng(9).integers(0, 2 ** 8, (9, 11))
    tpop, _ = _check_all_engines([n[0] for n in nets], [n[1] for n in nets],
                                 x, pallas=False)
    assert tpop.max_width > 32
    assert TNS.ops.lane_dtype(tpop) == torch.int64


def test_per_candidate_inputs_and_accuracy():
    nets = [synth((7, 8, 3), 3, seed=s, in_bits=4) for s in (5, 6)]
    x = np.random.default_rng(10).integers(0, 2 ** 4, (2, 19, 7))
    y = np.random.default_rng(11).integers(0, 3, 19)
    tpop = TNS.pack_population([n[1] for n in nets])
    rpop = RNS.pack_population([n[0] for n in nets])
    got = TNS.population_accuracy(tpop, x, y, device="cpu")
    ref = RNS.population_accuracy(rpop, x, y, engine="levels")
    np.testing.assert_array_equal(got, ref)
    assert got.dtype == np.float64
    # netlist_accuracy (P=1 through the population engine) == integer_forward
    c = nets[0][2]
    xf = np.random.default_rng(12).random((31, 7)).astype(np.float32)
    yy = np.random.default_rng(13).integers(0, 3, 31)
    _, cls = TMZ.integer_forward(c, TMZ.quantize_inputs(c, xf))
    assert TCIRC.netlist_accuracy(nets[0][1], c, xf, yy, device="cpu") == \
        float(np.mean(cls == yy))


def test_kernel_wrapper_validates_inputs():
    _, tnet, _ = synth((5, 4, 3), 4, seed=1)
    pop = TNS.pack_population([tnet])
    with pytest.raises(ValueError, match="x shape"):
        TNS.netlist_sim(pop, torch.zeros((2, 3, 5), dtype=torch.int64))
    with pytest.raises(TypeError):
        TNS.netlist_sim(pop, torch.zeros((1, 3, 5), dtype=torch.float32))
    with pytest.raises(ValueError, match="unknown engine"):
        TNS.simulate_population(pop, np.zeros((3, 5), np.int64),
                                engine="pallas", device="cpu")


# ---------------------------------------------------------------------------
# what the CUDA kernel's shared-memory body relies on, checked on the CPU
# ---------------------------------------------------------------------------

# a GA population's spread of specs: (bits, sparsity, clusters)
SPECS = [(8, 0.0, None), (6, 0.2, None), (4, 0.4, 8), (3, 0.1, None),
         (2, 0.3, None), (5, 0.6, 4)]


@pytest.mark.parametrize("dataset", sorted(PRINTED_MLPS))
def test_operands_lie_in_strictly_earlier_levels(dataset):
    """Netlists at each dataset's published topology, packed by both
    packages into the same tables: every operand of a computed slot lies in
    a strictly earlier level than the slot, the order that the kernel's
    per-level barrier relies on, and the wrapper's check agrees."""
    dims = PRINTED_MLPS[dataset].layer_dims
    nets = [synth(dims, b, sparsity=sp, clusters=k, seed=i)
            for i, (b, sp, k) in enumerate(SPECS)]
    rpop = RNS.pack_population([n[0] for n in nets])
    tpop = TNS.pack_population([n[1] for n in nets])
    for f in ("op", "arg_a", "arg_b", "level_ptr", "n_levels", "n_nodes"):
        np.testing.assert_array_equal(getattr(tpop, f), getattr(rpop, f))
    one = {int(o) for o in (TIR.Op.SHL, TIR.Op.NEG, TIR.Op.RELU,
                            TIR.Op.TRUNC, TIR.Op.ADD, TIR.Op.SUB)}
    two = {int(TIR.Op.ADD), int(TIR.Op.SUB)}
    checked = 0
    for p in range(tpop.n_candidates):
        ptr = tpop.level_ptr[p]
        level = np.searchsorted(ptr, np.arange(tpop.n_nodes[p]),
                                side="right") - 1
        for s in range(tpop.n_nodes[p]):
            o = int(tpop.op[p, s])
            if o in one:
                assert level[tpop.arg_a[p, s]] < level[s]
                checked += 1
            if o in two:
                assert level[tpop.arg_b[p, s]] < level[s]
    assert checked > 100
    TNS.ops.check_levels(tpop)


def test_check_levels_refuses_an_operand_in_its_own_level():
    _, tnet, _ = synth((7, 5, 3), 4, seed=3)
    pop = TNS.pack_population([tnet])
    TNS.ops.check_levels(pop)
    ptr = pop.level_ptr[0]
    adds = (int(TIR.Op.ADD), int(TIR.Op.SUB))
    lo, s = next((ptr[l], s) for l in range(pop.n_levels[0])
                 for s in range(ptr[l], ptr[l + 1])
                 if pop.op[0, s] in adds and ptr[l + 1] - ptr[l] > 1)
    bad = pop.arg_b.copy()
    bad[0, s] = lo if s != lo else lo + 1          # a slot of its own level
    with pytest.raises(ValueError, match="earlier level"):
        TNS.ops.check_levels(dataclasses.replace(pop, arg_b=bad))
    ptr = pop.level_ptr.copy()
    ptr[0, 1] = ptr[0, 2] + 1                        # not monotone
    with pytest.raises(ValueError, match="tile"):
        TNS.ops.check_levels(dataclasses.replace(pop, level_ptr=ptr))


# the H100's SMs and the most shared memory a block can take (227 KB)
H100_SMS, H100_SMEM = 132, 232448


def test_smem_tile_rule():
    """The body and tile follow from (P, N, B, lane bytes) and the card's
    SMs and shared memory alone: the shared-memory body at the search's
    shapes, with bt = 16 int32 lanes for eight WhiteWine candidates; the
    global body once one sample's table passes 227 KB."""
    ops = TNS.ops

    def tile(P, N, B, lane, sms=H100_SMS):
        return ops.smem_tile(P, N, B, lane, sms, H100_SMEM)

    nets = [synth(PRINTED_MLPS["whitewine"].layer_dims, b, sparsity=sp,
                  clusters=k, seed=i)[1]
            for i, (b, sp, k) in enumerate(SPECS + SPECS[:2])]
    pop = TNS.pack_population(nets)
    N = pop.n_slots
    assert ops.lane_dtype(pop) == torch.int32
    bt = tile(8, N, 1223, 4)
    assert bt == 16
    assert 2 * ops.smem_bytes(N, bt, 4) <= H100_SMEM
    assert 8 * -(-1223 // bt) >= 2 * H100_SMS
    # a small grid keeps the largest tile that fits twice
    assert tile(1, N, 1, 4) == 16
    assert tile(1, 100, 5, 4) == 16
    # a table too large to fit twice at 16 samples takes a smaller tile
    big = H100_SMEM // (2 * (16 + 16 * 4)) + 1
    assert tile(8, big, 1223, 4) == 8
    # the largest table: one sample of int32 (int64) lanes in 227 KB
    for lane in (4, 8):
        edge = H100_SMEM // (16 + lane)
        assert ops.smem_bytes(edge, 1, lane) <= H100_SMEM
        assert tile(8, edge, 1223, lane) == 1
        assert tile(8, edge + 1, 1223, lane) is None
    # many candidates: the tile shrinks no further than two blocks an SM
    assert tile(64, N, 1223, 4) == 16
    assert tile(1, N, 1223, 4) == 4
    # a card of fewer SMs fills at a larger tile
    assert tile(1, N, 1223, 4, sms=32) == 16
