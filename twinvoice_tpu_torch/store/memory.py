"""In-memory InvoiceStore — the test/offline backend (SURVEY.md §4.3): the
port's copy of ``twinvoice_tpu/store/memory.py``."""

from __future__ import annotations

from typing import List, Optional

from twinvoice_tpu_torch.store.base import invoice_row_from_meta, item_rows


class MemoryStore:
    def __init__(self):
        self._invoices: List[dict] = []
        self._items: List[dict] = []
        self._next_id = 1

    def save_invoice(self, meta: dict, items: List[dict]) -> Optional[int]:
        try:
            row = invoice_row_from_meta(meta, items)
        except (TypeError, ValueError):
            return None
        row["id"] = self._next_id
        self._next_id += 1
        self._invoices.append(row)
        self._items.extend(item_rows(row["id"], items or []))
        return row["id"]

    def delete_invoice(self, invoice_id: int) -> bool:
        self._items = [r for r in self._items if r["invoice_id"] != invoice_id]
        before = len(self._invoices)
        self._invoices = [r for r in self._invoices if r["id"] != invoice_id]
        return len(self._invoices) < before

    def list_invoices(self, limit: int = 500) -> List[dict]:
        return sorted(self._invoices, key=lambda r: -r["id"])[:limit]

    def list_items(self, limit: int = 5000) -> List[dict]:
        return list(self._items)[:limit]
