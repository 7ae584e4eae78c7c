"""PyTorch/CUDA port of the time-range k-core query system (``repro``).

``repro_torch.core`` answers TCQs on an NVIDIA H100 through hand-written
CUDA kernels (``repro_torch.kernels``); ``repro_torch.graphs`` holds the
graph generators and IO.  The JAX package ``repro`` is the reference this
port is tested against; nothing here imports it or JAX.
"""
