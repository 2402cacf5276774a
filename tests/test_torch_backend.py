"""The port's process knobs (`repro_torch.configs.backend`): the netlist
engine chosen by the device the caller passes (never by whether a card is
present) and overridden by ``REPRO_NETLIST_ENGINE``; ``configure`` and the
``REPRO_*`` variables setting threads, anomaly mode, float64 as the
default float type and the entry points' default device, each put back
after the test."""
import pytest
import torch

import repro_torch
from repro_torch.configs import backend as BK


def test_netlist_engine_follows_the_device(monkeypatch):
    monkeypatch.delenv("REPRO_NETLIST_ENGINE", raising=False)
    assert BK.default_netlist_engine("cpu") == "levels"
    assert BK.default_netlist_engine(torch.device("cuda", 0)) == "cuda"
    assert BK.default_netlist_engine("cuda") == "cuda"
    monkeypatch.setenv("REPRO_NETLIST_ENGINE", "ref")
    assert BK.default_netlist_engine("cuda") == "ref"
    monkeypatch.setenv("REPRO_NETLIST_ENGINE", "bogus")
    assert BK.default_netlist_engine("cpu") == "levels"


@pytest.fixture()
def saved():
    state = (torch.get_num_threads(), torch.is_anomaly_enabled(),
             torch.get_default_dtype(), repro_torch._DEFAULT_DEVICE)
    yield
    torch.set_num_threads(state[0])
    torch.autograd.set_detect_anomaly(state[1])
    torch.set_default_dtype(state[2])
    repro_torch.set_default_device(state[3])


def test_configure_from_arguments_and_environment(saved, monkeypatch):
    BK.configure(platform="cpu", x64=True, cpu_cores=1, debug_nan=True)
    assert repro_torch.resolve_device(None) == torch.device("cpu")
    assert torch.get_default_dtype() == torch.float64
    assert torch.get_num_threads() == 1 and torch.is_anomaly_enabled()
    for k, v in {"REPRO_PLATFORM": "gpu", "REPRO_X64": "0",
                 "REPRO_CPU_CORES": "2", "REPRO_DEBUG_NAN": "false"}.items():
        monkeypatch.setenv(k, v)
    BK.configure()
    assert repro_torch._DEFAULT_DEVICE == "cuda"
    assert torch.get_default_dtype() == torch.float32
    assert torch.get_num_threads() == 2 and not torch.is_anomaly_enabled()
    with pytest.raises(ValueError):
        BK.set_platform("tpu")
    with pytest.raises(ValueError, match="unsupported"):
        repro_torch.resolve_device("meta")
    assert repro_torch.resolve_device("meta", meta=True).type == "meta"


def _population():
    import numpy as np

    from repro_torch import circuit as TCIRC
    from repro_torch.core import minimize as TMZ
    from repro_torch.kernels import netlist_sim as TNS
    r = np.random.default_rng(0)
    dims = (5, 4, 3)
    q = [r.integers(-15, 16, (a, b)).astype(np.int64)
         for a, b in zip(dims[:-1], dims[1:])]
    mlp = TMZ.CompiledMLP(q, [0.01, 0.02],
                          [r.normal(0, 0.3, b).astype(np.float32)
                           for b in dims[1:]], [None, None], [5, 5], 8)
    pop = TNS.pack_population([TCIRC.compile_netlist(mlp)] * 2)
    return pop, r.integers(0, 256, (7, 5)).astype(np.int64)


def test_netlist_sim_without_an_engine_takes_the_policy(monkeypatch):
    """`simulate_population(engine=None)` asks `default_netlist_engine` of
    the device: the levels engine on the CPU (the kernel's wrapper is not
    entered), numpy's oracle when ``REPRO_NETLIST_ENGINE=ref``."""
    import numpy as np

    from repro_torch.kernels.netlist_sim import ops
    pop, x = _population()
    oracle = ops.simulate_population_ref(pop, x)
    monkeypatch.delenv("REPRO_NETLIST_ENGINE", raising=False)
    calls = []
    wrapper = ops.netlist_sim
    monkeypatch.setattr(ops, "netlist_sim",
                        lambda *a, **k: calls.append(1) or wrapper(*a, **k))
    out = ops.simulate_population(pop, x, device="cpu")
    np.testing.assert_array_equal(out["amx"], oracle["amx"])
    assert calls == []
    ops.simulate_population(pop, x, engine="cuda", device="cpu")
    assert calls == [1]
    seen = []
    ref = ops.simulate_population_ref
    monkeypatch.setattr(ops, "simulate_population_ref",
                        lambda *a: seen.append(1) or ref(*a))
    monkeypatch.setenv("REPRO_NETLIST_ENGINE", "ref")
    out = ops.simulate_population(pop, x, device="cpu")
    np.testing.assert_array_equal(out["argmax"], oracle["argmax"])
    assert seen == [1] and calls == [1]


def test_entry_points_read_the_platform_knob(saved, monkeypatch):
    """``REPRO_PLATFORM=cpu`` runs an entry point on the CPU without
    ``--device cpu``: its ``main`` calls `configure`."""
    from repro_torch.launch import serve
    monkeypatch.setenv("REPRO_PLATFORM", "cpu")
    serve.main(["--arch", "qwen3-0.6b", "--batch", "1", "--requests", "1",
                "--max-new-tokens", "2", "--max-len", "16"])
    assert repro_torch._DEFAULT_DEVICE == "cpu"
