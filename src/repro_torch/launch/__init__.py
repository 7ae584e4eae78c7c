"""Launchers (PyTorch counterpart of ``repro.launch``): the LM
substrate's serving and training steps and shape cells (with their
specs on a mesh), the TCQ serving launcher, the meshes of ranks
(``mesh.py``, ``world.py``) the sharded TCQ pipeline and the sharded LM
serve and train on, and the dry run (``dryrun.py``, with ``op_cost.py``
and ``analysis.py``) that costs each cell on the H100's roofline."""
