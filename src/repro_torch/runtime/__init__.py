"""Host-side execution runtime of the port (counterpart of
``repro.runtime``).

    prefetch — overlapped host-to-device chunk ingest (pinned staging
               slots, copies on a side CUDA stream) and its accounting

Still to be ported: the checkpoint writer, the metrics sinks, and with
them ``tree_nbytes`` and ``IngestMeter.scalars``.
"""

from repro_torch.runtime.prefetch import (IngestMeter,  # noqa: F401
                                          prefetch_to_device)
