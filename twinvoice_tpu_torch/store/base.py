"""Persistence protocol for invoices + line items: the port's copy of
``twinvoice_tpu/store/base.py``.

Mirrors the operations the reference performs against Supabase
(app_camera.py:368-405 insert, 1044-1051 delete, 1108-1113 dashboard reads)
as one storage interface, so the UI/dashboard code runs identically against
the cloud client and the in-memory fake (SURVEY.md §4.3).
"""

from __future__ import annotations

from typing import List, Optional, Protocol, runtime_checkable


def invoice_row_from_meta(meta: dict, items: List[dict]) -> dict:
    """Shape a meta dict into the invoices table row (app_camera.py:371-381
    field mapping: invoice_no truncated to 10, amount coerced int, category
    default 未分類, source recorded as note + details)."""
    return {
        "invoice_no": (meta.get("invoice_no") or "")[:10],
        "date": meta.get("date"),
        "total_amount": int(meta.get("total_amount", 0) or 0),
        "category": meta.get("category", "未分類"),
        "note": meta.get("source", ""),
        "details": {
            "source": meta.get("source", ""),
            "qr_count": len(meta.get("qr_raw", [])),
        },
    }


def item_rows(invoice_id, items: List[dict]) -> List[dict]:
    return [
        {
            "invoice_id": invoice_id,
            "name": str(it.get("name", "")),
            "qty": int(it.get("qty", 1)),
            "price": int(it.get("price", 0)),
            "amount": int(it.get("amount", 0)),
        }
        for it in items
    ]


@runtime_checkable
class InvoiceStore(Protocol):
    def save_invoice(self, meta: dict, items: List[dict]) -> Optional[int]:
        """Insert invoice + items; returns new invoice id, or None on failure."""
        ...

    def delete_invoice(self, invoice_id: int) -> bool:
        """Delete items first, then the invoice (app_camera.py:1044-1051)."""
        ...

    def list_invoices(self, limit: int = 500) -> List[dict]:
        """Newest-first invoice rows (id, invoice_no, date, total_amount,
        category, note)."""
        ...

    def list_items(self, limit: int = 5000) -> List[dict]:
        ...
