"""Structured diagnostics shared by every analyzer in `repro_torch.verify`.

A verifier never asserts: it returns :class:`Diagnostic` records —
machine-readable (rule id, severity, node id) and human-readable (message +
node provenance) at once — so callers can decide whether a finding is fatal
(``check_netlist`` raises), a report line (the CI gate), or a statistic
(the mutation-catalog tests count catches per rule).

Severities
----------
``ERROR``  a structural-soundness violation: the netlist (or spec) is not a
           well-formed object of its domain — wrong interval, dangling
           argument, broken bookkeeping. Always fatal under ``check_*``.
``WARN``   a microarchitectural-convention violation: the object is
           structurally sound but does not look like anything the compiler
           or the sanctioned passes emit (a TRUNC outside the approximation
           sites, a non-canonical shared constant). Fatal only under
           ``strict`` checking — hand-built test netlists stay legal.

The ambient switch: `verify_enabled` reads ``REPRO_VERIFY`` (the test
suite turns it on in ``tests/conftest.py``; production paths leave it off
and pay nothing).
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

ERROR = "error"
WARN = "warn"

ENV_FLAG = "REPRO_VERIFY"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding of one analyzer rule."""
    severity: str                    # ERROR | WARN
    rule: str                        # stable rule id, e.g. "interval"
    message: str
    node: Optional[int] = None       # offending node id (netlist rules)
    provenance: str = ""             # op/role/layer/unit of that node

    def __str__(self) -> str:
        where = f" @node {self.node}" if self.node is not None else ""
        prov = f" [{self.provenance}]" if self.provenance else ""
        return f"{self.severity}:{self.rule}{where}{prov}: {self.message}"


class VerificationError(AssertionError):
    """Raised by ``check_*`` helpers when diagnostics are fatal. Subclasses
    AssertionError so legacy callers treating `Netlist.validate()` as an
    assertion boundary keep working."""

    def __init__(self, diags: Sequence[Diagnostic]):
        self.diagnostics = list(diags)
        lines = "\n".join(f"  {d}" for d in self.diagnostics)
        super().__init__(
            f"{len(self.diagnostics)} verification finding(s):\n{lines}")


def errors(diags: Sequence[Diagnostic]) -> List[Diagnostic]:
    return [d for d in diags if d.severity == ERROR]


def verify_enabled(override: Optional[bool] = None) -> bool:
    """Resolve the ambient verification switch: an explicit argument wins,
    else the ``REPRO_VERIFY`` env var (off unless set truthy)."""
    if override is not None:
        return bool(override)
    return os.environ.get(ENV_FLAG, "0").lower() not in ("", "0", "false",
                                                         "off")
