from repro_torch.graphs.generators import (  # noqa: F401
    erdos_temporal,
    paper_style_example,
    powerlaw_temporal,
    planted_cores,
)
from repro_torch.graphs.io import load_snap_edges, save_edges  # noqa: F401
from repro_torch.graphs.stream import EdgeStream  # noqa: F401
