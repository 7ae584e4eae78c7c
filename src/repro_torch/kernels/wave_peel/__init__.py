"""Fused wave step (CUDA kernel + band tables + cost); see ops.py."""

from repro_torch.kernels.wave_peel.ops import (fused_step_cost,  # noqa: F401
                                               make_fused_wave_step,
                                               tel_bands, wave_peel)
