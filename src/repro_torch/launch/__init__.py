"""Serving steps and shape cells of the LM substrate (PyTorch counterpart
of ``repro.launch``, without a mesh)."""
