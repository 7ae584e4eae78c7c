"""Optimizers, their state specs on a mesh, and gradient compression
(PyTorch port of ``repro.optim``)."""

from repro_torch.optim.compression import (  # noqa: F401
    compressed_psum,
    compressed_psum_exact,
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.optimizers import (  # noqa: F401
    AdamW,
    Adafactor,
    make_optimizer,
    opt_state_pspecs,
    state_specs,
)
