"""Optimizers and gradient compression (PyTorch port of ``repro.optim``,
without the sharding specs and the compressed all-reduces: ROADMAP A11c)."""

from repro_torch.optim.compression import (  # noqa: F401
    dequantize_int8,
    quantize_int8,
)
from repro_torch.optim.optimizers import (  # noqa: F401
    AdamW,
    Adafactor,
    make_optimizer,
)
