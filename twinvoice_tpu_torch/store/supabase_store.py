"""Supabase-backed InvoiceStore: the port's copy of
``twinvoice_tpu/store/supabase_store.py`` (gated: ``supabase`` is imported
only when the store is built from credentials, and its absence leaves the
store unavailable).

Implements the same table contract the reference uses (``invoices_data`` +
``invoice_items``; app_camera.py:368-405, 1044-1051, 1108-1113) behind the
InvoiceStore protocol. Credentials come from env/args, never hardcoded
(the reference embeds its API key in source, app_camera.py:68 — a pattern
we explicitly do not reproduce).
"""

from __future__ import annotations

import os
from typing import List, Optional

from twinvoice_tpu_torch.store.base import invoice_row_from_meta, item_rows

URL_ENV = "SUPABASE_URL"
KEY_ENV = "SUPABASE_KEY"


class SupabaseStore:
    def __init__(self, url: Optional[str] = None, key: Optional[str] = None, client=None):
        self._client = client
        if self._client is None:
            url = url or os.environ.get(URL_ENV)
            key = key or os.environ.get(KEY_ENV)
            if url and key:
                try:
                    from supabase import create_client  # pragma: no cover

                    self._client = create_client(url, key)
                except Exception:
                    self._client = None

    def available(self) -> bool:
        return self._client is not None

    def save_invoice(self, meta: dict, items: List[dict]) -> Optional[int]:
        if not self.available():
            return None
        try:
            row = invoice_row_from_meta(meta, items)
            resp = self._client.table("invoices_data").insert(row).execute()
            if not resp.data:
                return None
            invoice_id = resp.data[0]["id"]
            rows = item_rows(invoice_id, items or [])
            if rows:
                self._client.table("invoice_items").insert(rows).execute()
            return invoice_id
        except Exception:
            return None

    def delete_invoice(self, invoice_id: int) -> bool:
        if not self.available():
            return False
        try:
            self._client.table("invoice_items").delete().eq("invoice_id", invoice_id).execute()
            self._client.table("invoices_data").delete().eq("id", invoice_id).execute()
            return True
        except Exception:
            return False

    def list_invoices(self, limit: int = 500) -> List[dict]:
        if not self.available():
            return []
        resp = (
            self._client.table("invoices_data")
            .select("id, invoice_no, date, total_amount, category, note")
            .order("id", desc=True)
            .limit(limit)
            .execute()
        )
        return resp.data or []

    def list_items(self, limit: int = 5000) -> List[dict]:
        if not self.available():
            return []
        resp = (
            self._client.table("invoice_items")
            .select("invoice_id, name, qty, price, amount")
            .limit(limit)
            .execute()
        )
        return resp.data or []
