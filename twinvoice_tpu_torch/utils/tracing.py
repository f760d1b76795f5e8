"""Per-stage wall-time meter (``twinvoice_tpu.utils.tracing``).
``trace_span`` records into a :class:`StageTimer` and marks the span on a
``torch.profiler`` timeline."""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict
from typing import Dict, List

import torch


class StageTimer:
    """Thread-safe accumulator of per-stage wall times."""

    def __init__(self):
        self._lock = threading.Lock()
        self._samples: Dict[str, List[float]] = defaultdict(list)

    def record(self, stage: str, seconds: float):
        with self._lock:
            self._samples[stage].append(seconds)

    def stats(self) -> Dict[str, Dict[str, float]]:
        out = {}
        with self._lock:
            for stage, xs in self._samples.items():
                s = sorted(xs)
                n = len(s)
                out[stage] = {
                    "count": n,
                    "total_s": sum(s),
                    "p50_ms": 1e3 * s[n // 2],
                    "p95_ms": 1e3 * s[min(n - 1, int(0.95 * n))],
                    "max_ms": 1e3 * s[-1],
                }
        return out

    def reset(self):
        with self._lock:
            self._samples.clear()

    def report(self) -> str:
        lines = [f"{'stage':24s} {'count':>6s} {'p50':>9s} {'p95':>9s} {'max':>9s}"]
        for stage, st in sorted(self.stats().items()):
            lines.append(
                f"{stage:24s} {st['count']:6d} {st['p50_ms']:8.1f}m {st['p95_ms']:8.1f}m {st['max_ms']:8.1f}m"
            )
        return "\n".join(lines)


_GLOBAL = StageTimer()


def get_timer() -> StageTimer:
    return _GLOBAL


@contextlib.contextmanager
def trace_span(stage: str, timer: StageTimer = None):
    """Time a pipeline stage (host wall clock; device work that the stage only
    enqueues is not waited for) and label it on the profiler timeline."""
    timer = timer or _GLOBAL
    t0 = time.perf_counter()
    with torch.profiler.record_function(stage):
        try:
            yield
        finally:
            timer.record(stage, time.perf_counter() - t0)
