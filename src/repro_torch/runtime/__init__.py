"""The fault-tolerant training driver (PyTorch port of ``repro.runtime``)."""

from repro_torch.runtime.trainer import (  # noqa: F401
    FaultInjector,
    InjectedFault,
    Trainer,
    TrainerConfig,
)
