"""Card-only tests of the port's CUDA kernels: each kernel against its
plain PyTorch version and the numpy oracle, bit for bit. They import no
JAX (the machine with the card has none) and skip without a CUDA device;
on the card run them without the JAX-importing conftest:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import circuit
from repro_torch.core import minimize as MZ
from repro_torch.kernels import LAUNCHES, reset_launches
from repro_torch.kernels import netlist_sim as NS
from repro_torch.kernels.netlist_sim import ops as NSO


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


CASES = {
    "mixed": (lambda: [_net(d, 5, i) for i, d in enumerate(
        [(7, 3, 3), (7, 28, 3), (7, 14, 14, 3)])], 300, 7),
    "many_levels": (lambda: [_net((11,) + (10,) * 6 + (7,), 2, s,
                                  sparsity=0.2) for s in (1, 2)], 129, 11),
    "int64": (lambda: [_net((11, 12, 12, 7), 8, 3),
                       _net((11, 10, 7), 8, 4, clusters=4)], 77, 11),
    "ragged_batch": (lambda: [_net((5, 6, 3), 4, 2)], NSO.BLOCK + 3, 5),
    "one_sample": (lambda: [_net((5, 6, 3), 4, 2)], 1, 5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CASES))
def test_netlist_sim_kernel_matches_plain_and_oracle(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    make, B, n_in = CASES[case]
    pop = NS.pack_population(make())
    if case == "int64":
        assert NSO.lane_dtype(pop) == torch.int64
    x = np.random.default_rng(B).integers(0, 2 ** 4, (B, n_in))
    reset_launches()
    got = NS.simulate_population(pop, x, engine="cuda", device="cuda")
    torch.cuda.synchronize()
    assert LAUNCHES["netlist_sim"] == 1
    plain = NS.simulate_population(pop, x, engine="levels", device="cuda")
    oracle = NS.simulate_population_ref(pop, x)
    for out in (plain, oracle):
        np.testing.assert_array_equal(got["amx"], out["amx"])
        np.testing.assert_array_equal(got["argmax"], out["argmax"])


@pytest.mark.cuda
def test_netlist_sim_wrapper_never_falls_back_on_cuda(monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel or raises; it never
    runs the plain version instead."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pop = NS.pack_population([_net((5, 6, 3), 4, 2)])
    x = torch.zeros((1, 4, 5), dtype=torch.int64, device="cuda")

    def forbidden(*a, **k):
        raise AssertionError("plain version ran on a CUDA tensor")

    monkeypatch.setattr(NSO, "simulate_levels", forbidden)
    amx, cls = NS.netlist_sim(pop, x)
    assert amx.is_cuda and cls.is_cuda

    def broken(name):
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr("repro_torch.kernels.build.load", broken)
    with pytest.raises(RuntimeError, match="nvcc"):
        NS.netlist_sim(pop, x)
