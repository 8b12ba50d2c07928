"""Host-side execution runtime of the port (counterpart of
``repro.runtime``).

    prefetch — overlapped host-to-device chunk ingest (pinned staging
               slots, copies on a side CUDA stream) and its accounting
    metrics  — the ``log_scalars`` sinks every host loop emits to
    writer   — the background checkpoint writer, the run directory's
               manifest and its retention
"""

from repro_torch.runtime.metrics import (CollectMetrics,  # noqa: F401
                                         EarlyStopHook, JsonlMetrics,
                                         NullMetrics, StdoutMetrics,
                                         TeeMetrics, as_metrics,
                                         close_metrics, should_stop)
from repro_torch.runtime.prefetch import (IngestMeter,  # noqa: F401
                                          prefetch_to_device, tree_nbytes)
from repro_torch.runtime.writer import (CheckpointWriter,  # noqa: F401
                                        cleanup_orphans, read_manifest,
                                        snapshot_name, write_snapshot)
