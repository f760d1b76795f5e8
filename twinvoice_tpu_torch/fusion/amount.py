"""Total-amount decision: first OCR candidate that cleans to digits wins,
in engine-priority order; never None (falls back to "0").
Reference behavior: app_camera.py:707-734.

A copy of ``twinvoice_tpu.fusion.amount`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

import re
from typing import Optional


def extract_amount(*candidates: Optional[str]) -> str:
    """Candidates in priority order (e.g. cloud OCR first, local OCR second)."""
    for cand in candidates:
        if not cand:
            continue
        cleaned = re.sub(r"[^0-9]", "", str(cand))
        if cleaned.isdigit() and cleaned:
            return cleaned
    return "0"
