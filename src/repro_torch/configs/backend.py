"""Process-level knobs of the port, the counterpart of
`repro.configs.backend` in torch terms.

One place for what the benchmarks, the search runtime and the netlist-sim
engines set when the port leaves its defaults: the entry points' default
device (``platform``), the CPU threads (``cpu_cores``), float64 as the
default float type (``x64``) and NaN debugging (``debug_nan``). Call
:func:`configure` (or the individual setters) before the work starts, or
drive them through the ``REPRO_*`` environment variables it reads.

``default_netlist_engine(device)`` is the routing policy of
`repro_torch.kernels.netlist_sim` (`simulate_population` with no
``engine``): kernel K1 (``"cuda"``) for a CUDA device, the level-by-level
PyTorch engine (``"levels"``) for the CPU, by the device the caller passes
and never by whether a card happens to be present.
``REPRO_NETLIST_ENGINE`` overrides it.

The entry points (`repro_torch.paper`, `launch.serve`, `launch.train` and
the four `examples`) call :func:`configure` once their arguments are
parsed, so the ``REPRO_*`` variables reach them: ``REPRO_PLATFORM=cpu``
runs one on the CPU without ``--device cpu``.
"""
from __future__ import annotations

import os
import warnings
from multiprocessing import cpu_count

import torch

import repro_torch

_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def set_x64(use_x64: bool) -> None:
    """float64 as the default float type process-wide (``torch.tensor``
    of Python floats, ``torch.zeros`` without a dtype); the integer paths
    choose their widths themselves."""
    torch.set_default_dtype(torch.float64 if use_x64 else torch.float32)


def set_platform(platform: str = "cuda") -> None:
    """The device the entry points take when the caller passes none:
    ``"cuda"`` (or ``"gpu"``) or ``"cpu"``."""
    if platform not in _PLATFORMS:
        raise ValueError(f"platform {platform!r}: the port runs on "
                         f"{sorted(_PLATFORMS)}")
    repro_torch.set_default_device(_PLATFORMS[platform])


def set_cpu_cores(n: int) -> None:
    """Use ``n`` CPU threads for intra-op parallelism."""
    n = int(n)
    total = cpu_count()
    if n > total:
        warnings.warn(f"only {total} CPUs available, will use {total - 1}",
                      Warning)
        n = total - 1
    torch.set_num_threads(max(n, 1))


def set_debug_nan(flag: bool) -> None:
    """Autograd's anomaly mode: the backward op that produced the first
    NaN raises, with the forward op's trace."""
    torch.autograd.set_detect_anomaly(bool(flag))


def default_netlist_engine(device) -> str:
    """``"cuda"`` (kernel K1) for a CUDA device, ``"levels"`` for the CPU;
    overridable with ``REPRO_NETLIST_ENGINE=levels|cuda|ref``."""
    env = os.environ.get("REPRO_NETLIST_ENGINE", "").strip().lower()
    if env in ("levels", "cuda", "ref"):
        return env
    return "cuda" if torch.device(device).type == "cuda" else "levels"


def configure(*, platform: str | None = None, x64: bool | None = None,
              cpu_cores: int | None = None,
              debug_nan: bool | None = None) -> None:
    """Apply the requested knobs, falling back to ``REPRO_PLATFORM``,
    ``REPRO_X64``, ``REPRO_CPU_CORES`` and ``REPRO_DEBUG_NAN`` when an
    argument is None. Unset knobs are left at PyTorch's defaults."""
    def env(name):
        v = os.environ.get(name, "").strip()
        return v or None

    platform = platform if platform is not None else env("REPRO_PLATFORM")
    if platform:
        set_platform(platform)
    if x64 is None and env("REPRO_X64"):
        x64 = env("REPRO_X64") not in ("0", "false", "False")
    if x64 is not None:
        set_x64(bool(x64))
    cores = cpu_cores if cpu_cores is not None else env("REPRO_CPU_CORES")
    if cores:
        set_cpu_cores(int(cores))
    if debug_nan is None and env("REPRO_DEBUG_NAN"):
        debug_nan = env("REPRO_DEBUG_NAN") not in ("0", "false", "False")
    if debug_nan is not None:
        set_debug_nan(bool(debug_nan))
