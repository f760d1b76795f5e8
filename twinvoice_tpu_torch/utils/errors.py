"""Structured error taxonomy + failure log for the recognition pipeline (a
copy of ``twinvoice_tpu.utils.errors``).

The reference swallows every failure silently (`except: pass` / `return ""`
around each external call — app_camera.py:404-405, 494-499, 566-570,
828-829), which makes field-level debugging impossible. Here each stage has
a typed error, and :class:`FailureLog` lets pipeline code degrade gracefully
*while recording* what failed, extending the provenance pattern the
reference already uses for successes (source/date_source/amount_source).
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, List


class PipelineError(Exception):
    """Base class; carries the pipeline stage name."""

    stage = "pipeline"


class QrDecodeError(PipelineError):
    stage = "qr"


class SegmentationError(PipelineError):
    stage = "segment"


class OcrEngineError(PipelineError):
    stage = "ocr"


class StorageError(PipelineError):
    stage = "store"


@dataclass
class Failure:
    stage: str
    error: str
    detail: str = ""
    ts: float = field(default_factory=time.time)


class FailureLog:
    """Collects per-stage failures instead of swallowing them."""

    def __init__(self):
        self.failures: List[Failure] = []

    def record(self, stage: str, exc: BaseException):
        self.failures.append(
            Failure(stage, type(exc).__name__, str(exc) or traceback.format_exc(limit=1))
        )

    def guarded(self, stage: str, fn: Callable, *args, default: Any = None, **kw):
        """Run ``fn``; on failure record it and return ``default``."""
        try:
            return fn(*args, **kw)
        except Exception as exc:  # noqa: BLE001 - the whole point is to catch
            self.record(stage, exc)
            return default

    def stages_failed(self) -> List[str]:
        return sorted({f.stage for f in self.failures})

    def as_dicts(self) -> List[dict]:
        return [f.__dict__ for f in self.failures]

    def __bool__(self):
        return bool(self.failures)
