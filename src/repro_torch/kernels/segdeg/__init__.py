"""Sorted-segment sum (plain version + CUDA kernel); see ops.py."""

from repro_torch.kernels.segdeg.ops import (banded_segsum,  # noqa: F401
                                            banded_segsum_ref,
                                            make_banded_segsum,
                                            segment_offsets)
