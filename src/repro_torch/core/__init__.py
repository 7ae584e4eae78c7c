"""The paper's contribution, scalable time-range k-core queries (TCQ), on
PyTorch: the port of ``repro.core`` for the NVIDIA H100.

Public API:
  TemporalGraph        — host-side ArrayTEL (build / epoch-versioned
                         incremental append / ``from_state`` /
                         ``device_tel`` to a torch device)
  TCQEngine            — query engine for one graph, on CUDA by default
                         (streaming: update_graph installs new epochs)
  TCQService           — continuous serving runtime: window-clustered lane
                         pools, mid-flight admission, epoch-pinned
                         snapshots, on CUDA by default
  CoreCache            — TTI-keyed core-result cache (cross-request reuse,
                         incremental invalidation on ingest)
  ResilienceConfig     — opt-in degradation ladder (fused -> composite ->
                         numpy oracle), every demotion logged
  WriteAheadLog        — durable streaming: append-only CRC-checked journal
                         (TCQService(wal_dir=...) / TCQService.recover)
  temporal_kcore_query — one-shot convenience wrapper
  PHCIndex / iphc_query — the paper's baseline (PHC-Index built on the
                         device, Algorithm 1's online query on the host)
  tcd / tcd_batch      — the TCD operation (truncate + frontier peel + TTI)
  brute_force_query    — oracle
"""

from repro_torch.core.baseline import PHCIndex, iphc_query  # noqa: F401
from repro_torch.core.corecache import CacheView, CoreCache  # noqa: F401
from repro_torch.core.engine import WavePipeline  # noqa: F401
from repro_torch.core.graph import (DeviceTEL, GraphIngestError,  # noqa: F401
                                    TemporalGraph)
from repro_torch.core.oracle import brute_force_query, peel_window  # noqa: F401
from repro_torch.core.otcd import TCQEngine, temporal_kcore_query  # noqa: F401
from repro_torch.core.results import (CoreResult, QueryStats,  # noqa: F401
                                      TCQResult)
from repro_torch.core.scheduler import (EmptyStaircase, QueryState,  # noqa: F401
                                        autotune_wave)
from repro_torch.core.service import (TCQService, TCQTicket,  # noqa: F401
                                      cluster_windows)
from repro_torch.core.tcd import TCDResult, coreness, tcd, tcd_batch  # noqa: F401
from repro_torch.core.wal import (SnapshotCorruption, WALError,  # noqa: F401
                                  WALRecord, WALReplayError, WriteAheadLog)
from repro_torch.core.wave import (DegradationLadder,  # noqa: F401
                                   ResilienceConfig, StepDivergence,
                                   StepResult,
                                   make_oracle_step_fn, make_wave_step_fn,
                                   pack_alive_u32, unpack_alive_u32)
