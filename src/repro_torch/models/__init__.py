"""The LM substrate of the port: config, layers, mixers and the transformer
(a PyTorch counterpart of ``repro.models``)."""
