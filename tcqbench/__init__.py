"""The benchmark of the PyTorch/CUDA port (``repro_torch``): TCQ batches and
open-loop serving on one H100.  ``python3 tcqbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell once."""
