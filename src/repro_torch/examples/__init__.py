"""Runnable examples of the port (counterparts of the repository's
``examples/``): ``python -m repro_torch.examples.<name>`` with
``PYTHONPATH=src``.  Each runs on CUDA unless given ``--device cpu``."""
