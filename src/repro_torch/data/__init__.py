"""Request workloads for the serving launcher (PyTorch port of
``repro.data``; only the TCQ request stream is ported)."""

from repro_torch.data.pipeline import TCQRequestStream  # noqa: F401
