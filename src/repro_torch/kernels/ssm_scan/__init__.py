"""Diagonal SSM scan and its reverse scan (plain versions + CUDA kernels);
see ops.py."""

from repro_torch.kernels.ssm_scan.ops import (SSMScan,  # noqa: F401
                                              ssm_scan, ssm_scan_bwd)
from repro_torch.kernels.ssm_scan.ref import (  # noqa: F401
    ssm_scan_bwd_ref, ssm_scan_ref)
