"""Keyword-based spending-category classifier.

Same category taxonomy and keyword data as the reference
(app_camera.py:231-256): substring match over invoice number + item names;
first matching category wins in dict order; default 未分類. The keyword
table is *data* (domain knowledge about Taiwanese merchants), kept
extensible per-instance instead of module-global.

A copy of ``twinvoice_tpu.fusion.classify`` (the port imports nothing of the
JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional

DEFAULT_KEYWORDS: Dict[str, List[str]] = {
    "餐飲": [
        "C & C", "咖啡", "飲料", "便當", "飯", "麵", "鍋",
        "漢堡", "炸", "茶", "吃", "餐", "壽司", "拉麵",
    ],
    "交通": [
        "捷運", "高鐵", "火車", "公車", "停車", "加油",
        "油", "ETC", "計程車",
    ],
    "購物": [
        "全家", "7-11", "7-ＥＬＥＶＥＮ", "家樂福",
        "momo", "蝦皮", "PChome", "商城",
    ],
    "生活": [
        "水費", "電費", "瓦斯", "管理費", "醫院", "藥局",
    ],
}

UNCLASSIFIED = "未分類"
CATEGORIES = tuple(DEFAULT_KEYWORDS) + (UNCLASSIFIED,)


def classify_invoice(
    meta: dict,
    items: List[dict],
    keywords: Optional[Dict[str, List[str]]] = None,
) -> str:
    kw = keywords or DEFAULT_KEYWORDS
    names = [it["name"] for it in items if it.get("name")]
    haystack = (meta.get("invoice_no") or "") + " " + " ".join(names)
    for category, needles in kw.items():
        if any(n in haystack for n in needles):
            return category
    return UNCLASSIFIED
