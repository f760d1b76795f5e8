"""Taiwanese Ministry-of-Finance e-invoice QR payload parsers (a copy of
``twinvoice_tpu.qr.parse``).

Every invoice carries two QR codes: a *header* QR whose payload starts with
the invoice number ([A-Z]{2}\\d{8}) immediately followed by a 7-digit
ROC-calendar date (e.g. ``1140909`` = 2025-09-09), and a *TEXT* QR (``**``
prefix) carrying ``name:qty:price`` line items. Reference behavior being
matched: app_camera.py:421-459 (header) and 94-161 (items/TEXT detection).
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Tuple

_HEADER_RE = re.compile(r"([A-Z]{2}\d{8})(\d{7})")
_BARE_INVOICE_RE = re.compile(r"[A-Z]{2}\d{8}")
_ITEM_RE = re.compile(r"([^:]+):(\d+):(\d+)")
_CJK_ITEMISH_RE = re.compile(r"[一-龥].*?\d+:\d+")

# item names that are structure, not products (reference junk list,
# app_camera.py:142)
_JUNK_NAMES = {"隨機", "總計", "金額"}


def coerce_text(x) -> str:
    """bytes/None/anything → str (reference safe_str, app_camera.py:407-416)."""
    if x is None:
        return ""
    if isinstance(x, bytes):
        return x.decode("utf-8", errors="ignore")
    return str(x)


def roc_date_to_iso(roc: str) -> Optional[str]:
    """``1140909`` → ``2025-09-09``; None when out of the plausible ROC range
    (years 100-200, reference validity window app_camera.py:446)."""
    if len(roc) != 7 or not roc.isdigit():
        return None
    year_roc, month, day = int(roc[:3]), int(roc[3:5]), int(roc[5:7])
    if not (100 <= year_roc <= 200 and 1 <= month <= 12 and 1 <= day <= 31):
        return None
    return f"{year_roc + 1911}-{month:02d}-{day:02d}"


def parse_header_qr(payloads: Iterable) -> Tuple[Optional[str], Optional[str]]:
    """Extract (invoice_no, iso_date) from raw QR payload strings.

    Priority: a payload containing number+date wins and stops the scan; a
    bare invoice number is kept as fallback (app_camera.py:437-457).
    """
    invoice_no = None
    for raw in payloads:
        s = coerce_text(raw)
        m = _HEADER_RE.search(s)
        if m:
            date = roc_date_to_iso(m.group(2))
            if date is not None:
                return m.group(1), date
            invoice_no = invoice_no or m.group(1)
        if invoice_no is None:
            m2 = _BARE_INVOICE_RE.search(s)
            if m2:
                invoice_no = m2.group(0)
    return invoice_no, None


def is_text_qr_payload(s: str) -> bool:
    """Heuristic for the line-item ('TEXT') QR (app_camera.py:116-120)."""
    s = coerce_text(s)
    return (
        "**********" in s
        or s.startswith("**")
        or bool(_CJK_ITEMISH_RE.search(s))
    )


def parse_items_qr(payloads: Iterable) -> List[dict]:
    """Concatenate TEXT-QR fragments and pull ``name:qty:price`` triples.

    Returns ``[{name, qty, price, amount}]`` with junk filtering
    (app_camera.py:122-161): names must be >1 char, not structural keywords,
    qty > 0, price ≥ 0; leading ``*`` runs stripped from names.
    """
    joined = "".join(
        ":" + coerce_text(raw) for raw in payloads if is_text_qr_payload(coerce_text(raw))
    )
    items = []
    for name, qty_s, price_s in _ITEM_RE.findall(joined):
        name = name.strip()
        if name.startswith("**********"):
            continue
        had_marker = name.startswith("*")
        # strip the TEXT-QR "**" marker *before* the keyword filter, so
        # structural rows like "**總計" are rejected too (stricter than the
        # reference, which checks junk pre-strip and lets "**總計" through)
        name = re.sub(r"^\*+\s*", "", name).strip()
        if not name or name in _JUNK_NAMES:
            continue
        # the length filter matches the reference's PRE-strip semantics
        # (app_camera.py:143): a single-char FIRST item ("**茶") keeps its
        # marker there and survives; only bare 1-char fragments are junk
        if len(name) <= 1 and not had_marker:
            continue
        qty, price = int(qty_s), int(price_s)
        if qty > 0 and price >= 0:
            items.append({"name": name, "qty": qty, "price": price, "amount": qty * price})
    return items


def is_valid_invoice_no(s: Optional[str]) -> bool:
    """Strict full-string check (app_camera.py:94-97)."""
    return bool(s) and bool(re.fullmatch(r"[A-Z]{2}\d{8}", s))
