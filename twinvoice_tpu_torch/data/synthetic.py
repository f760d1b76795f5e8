"""The pure helpers of ``twinvoice_tpu.data.synthetic`` (copied): the ROC
date, the two QR payloads of a TW e-invoice and labelme shapes of
ground-truth boxes. ``render_invoice`` and its font registry stay with the
JAX package: they draw with Pillow on the host, and the port reads what they
render from fixture files."""

from __future__ import annotations

from typing import Dict, List, Tuple


def iso_to_roc(date_iso: str) -> str:
    """``2025-09-09`` → ``1140909`` (ROC calendar)."""
    y, m, d = date_iso.split("-")
    return f"{int(y) - 1911}{int(m):02d}{int(d):02d}"


def header_qr_payload(invoice_no: str, date_iso: str, amount: int = 0) -> str:
    """Realistic header-QR payload: number + ROC date + random-looking tail."""
    return f"{invoice_no}{iso_to_roc(date_iso)}1234:{amount:08x}:0:0:0:AAAA/BBBBCCCC=="


def items_qr_payload(items: List[dict]) -> str:
    body = ":".join(f"{it['name']}:{it['qty']}:{it['price']}" for it in items)
    return "**" + body


def labelme_shapes(boxes: Dict[str, Tuple[int, int, int, int]]) -> List[dict]:
    """Ground-truth boxes → labelme polygon shapes (for ``data.labelme``)."""
    shapes = []
    for label, (x1, y1, x2, y2) in boxes.items():
        shapes.append(
            {"label": label, "points": [[x1, y1], [x2, y1], [x2, y2], [x1, y2]]}
        )
    return shapes
