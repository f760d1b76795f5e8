"""Per-stage timing and the pipeline's error types (``twinvoice_tpu.utils``)."""

from twinvoice_tpu_torch.utils.tracing import StageTimer, trace_span, get_timer
from twinvoice_tpu_torch.utils.errors import (
    PipelineError,
    QrDecodeError,
    SegmentationError,
    OcrEngineError,
    StorageError,
    FailureLog,
)
