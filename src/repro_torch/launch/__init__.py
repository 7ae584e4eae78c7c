"""Launchers (PyTorch counterpart of ``repro.launch``): the LM
substrate's serving and training steps and shape cells, the TCQ serving
launcher, and the meshes of ranks (``mesh.py``, ``world.py``) the sharded
TCQ pipeline runs on.  The LM side of sharding is ROADMAP A11b."""
