"""Data pipelines (PyTorch port of ``repro.data``): the step-indexed
synthetic LM batches and the TCQ request stream."""

from repro_torch.data.pipeline import (SyntheticLMData,  # noqa: F401
                                       TCQRequestStream)
