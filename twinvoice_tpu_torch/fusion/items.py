"""Line-item utilities.

``adjust_items_to_total`` revives a dead-but-intended reference feature
(app_camera.py:182-225, defined and never called — SURVEY.md §2.2):
proportionally rescale item amounts so they sum exactly to the invoice
total, rounding to integers and absorbing the rounding residue into the
last item; prices are re-derived from qty where present.

A copy of ``twinvoice_tpu.fusion.items`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Dict, List


def sum_items_amount(items: List[dict]) -> int:
    """Σ price·qty with defensive coercion (app_camera.py:173-180 behavior)."""
    total = 0
    for it in items:
        try:
            total += int(it.get("price", 0)) * int(it.get("qty", 1))
        except (TypeError, ValueError):
            continue
    return total


def _as_int(value, default=0) -> int:
    try:
        return int(value)
    except (TypeError, ValueError):
        return default


def _item_amount(it: dict) -> int:
    if it.get("amount") is not None:
        return _as_int(it["amount"])
    if it.get("price") is not None and it.get("qty") is not None:
        return _as_int(it["price"]) * _as_int(it["qty"])
    return 0


def adjust_items_to_total(items: List[dict], total_amount: int) -> List[dict]:
    """Rescale item amounts so they sum to ``total_amount`` exactly.

    Returns new item dicts (functional — the reference mutates in place).
    No-ops when there is nothing to reconcile.
    """
    if not items or total_amount <= 0:
        return items
    originals = [_item_amount(it) for it in items]
    orig_total = sum(originals)
    if orig_total <= 0:
        return items

    ratio = total_amount / orig_total
    scaled = [int(round(a * ratio)) for a in originals]
    scaled[-1] += total_amount - sum(scaled)  # rounding residue → last item

    out = []
    for it, amt in zip(items, scaled):
        new = dict(it)
        new["amount"] = int(amt)
        qty = _as_int(new.get("qty", 1), default=1) or 1
        if qty > 0:
            new["price"] = int(round(amt / qty))
        out.append(new)
    return out


def pick_crop(crops: Dict[str, object], keys: List[str]):
    """First non-None crop among ``keys`` (app_camera.py:164-171)."""
    for k in keys:
        if crops.get(k) is not None:
            return crops[k]
    return None
