"""Selective scan (kernel K6): the Mamba-1 recurrence over time,
``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t``, ``y_t = C_t . h_t + D u_t``."""
from repro_torch.kernels.ssm_scan.ops import ssm_scan  # noqa: F401
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    selective_scan, ssm_scan_ref, ssm_scan_tolerance)

__all__ = ["ssm_scan", "selective_scan", "ssm_scan_ref",
           "ssm_scan_tolerance"]
