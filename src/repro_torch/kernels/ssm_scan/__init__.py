"""Selective scan (kernel K6): the Mamba-1 recurrence over time,
``h_t = exp(dt_t A) h_{t-1} + (dt_t u_t) B_t``, ``y_t = C_t . h_t + D u_t``;
its backward kernel gives the gradient on CUDA."""
from repro_torch.kernels.ssm_scan.ops import (  # noqa: F401
    SsmScanFn, ssm_scan, ssm_scan_bwd, ssm_scan_with_states)
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    selective_scan, ssm_scan_bwd_plain, ssm_scan_bwd_tolerance, ssm_scan_ref,
    ssm_scan_states_plain, ssm_scan_tolerance)

__all__ = ["SsmScanFn", "ssm_scan", "ssm_scan_bwd", "ssm_scan_bwd_plain",
           "ssm_scan_bwd_tolerance", "selective_scan", "ssm_scan_ref",
           "ssm_scan_states_plain", "ssm_scan_tolerance",
           "ssm_scan_with_states"]
