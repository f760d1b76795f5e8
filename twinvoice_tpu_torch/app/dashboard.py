"""Dashboard aggregation — the computation behind the reference's tab2
(app_camera.py:1091-1259): the port of ``twinvoice_tpu/app/dashboard.py``
without pandas.

A frame here is a list of row dicts, each with every column of the rows it
came from (a missing key is None). The functions take and return such
lists, with the values and the row order of the JAX module's DataFrames;
the UI turns them into frames where a chart or a table wants one.

What the JAX module's pandas calls do, and this module does:

- ``pd.to_numeric(amount, errors="coerce").fillna(0).astype(int)``: a
  number as it is, a string parsed as a decimal float (``"12.7"`` → 12.7,
  ``"1,200"`` and ``""`` → NaN), None and NaN → 0, then truncated toward
  zero; all-integer columns stay exact, a non-finite value raises.
- ``pd.to_datetime(date, errors="coerce")`` on strings: pandas infers one
  format from the first value that is not None, NaN, ``""`` or a NaT
  string, and coerces every value that does not match it to NaT. The
  shapes held are ``%Y{sep}%m{sep}%d`` with ``sep`` one of ``-``, ``/``,
  ``.`` (month and day of one or two digits) or none (``%Y%m%d``), then
  optionally ``T`` or a blank and ``%H:%M`` or ``%H:%M:%S``, with or
  without blanks before and after: a value matches the inferred format when
  it has the first value's shape (the same separators, seconds or not,
  blanks where it had them). When the first value is an impossible date or
  of no such shape, each value is parsed alone, a date of any held shape.
  (pandas hands what its ISO parser refuses to ``dateutil``, which reads
  further shapes, such as ``01/02/2025``; those are NaT here.)
- a NaT date has year ``""`` and a missing month (None): pandas 3's
  ``astype(str)`` keeps a missing period missing (pandas 2 wrote
  ``"NaT"``), so ``groupby("month")`` drops such rows;
- ``groupby`` sorts its keys and drops None keys;
- ``sort_values("date", ascending=False)`` is pandas' ``nargsort``: numpy's
  quicksort over the reversed non-NaT dates, reversed back, NaT last.
"""

from __future__ import annotations

import datetime as _dt
import math
import re
from typing import List, Optional

import numpy as np

_NAT_STRINGS = {"NaT", "nat", "NAT", "nan", "NaN", "NAN"}
# a date of the shapes held: blanks, %Y, a separator (- / . or none), %m,
# the separator, %d, optionally [ T]%H:%M[:%S], blanks
_DATE = re.compile(r"^(\s*)(\d{4})([-/.]?)(\d{1,2})\3(\d{1,2})"
                   r"(?:([ T])(\d{1,2}):(\d{1,2})(?::(\d{1,2}))?)?(\s*)$")
_DECIMAL = re.compile(r"^[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?$")
_SPECIAL = {"inf": math.inf, "+inf": math.inf, "-inf": -math.inf, "infinity": math.inf,
            "+infinity": math.inf, "-infinity": -math.inf, "nan": math.nan,
            "+nan": math.nan, "-nan": math.nan}


def _is_null(v) -> bool:
    return v is None or (isinstance(v, float) and math.isnan(v))


def _number(v):
    """One value of ``pd.to_numeric(errors="coerce")``: an int, a float or
    NaN."""
    if _is_null(v):
        return math.nan
    if isinstance(v, (bool, int, np.integer)):
        return int(v)
    if isinstance(v, (float, np.floating)):
        return float(v)
    if isinstance(v, str):
        s = v.strip()
        if s.lower() in _SPECIAL:
            return _SPECIAL[s.lower()]
        if not s.isascii() or not _DECIMAL.match(s):
            return math.nan
        return int(s) if re.fullmatch(r"[+-]?\d+", s) else float(s)
    return math.nan


def _amounts(values) -> List[int]:
    """``pd.to_numeric(col, errors="coerce").fillna(0).astype(int)``."""
    nums = [_number(v) for v in values]
    if all(isinstance(n, int) for n in nums):
        return nums
    arr = np.array(nums, np.float64)
    arr[np.isnan(arr)] = 0.0
    if not np.isfinite(arr).all():
        raise ValueError("Cannot convert non-finite values (NA or inf) to integer")
    return [int(x) for x in arr.astype(np.int64)]


def _make_date(y, m, d, hh=0, mm=0, ss=0) -> Optional[_dt.datetime]:
    try:
        return _dt.datetime(int(y), int(m), int(d), int(hh or 0), int(mm or 0), int(ss or 0))
    except ValueError:
        return None


def _date_parts(s: str):
    """→ (shape, datetime or None) of a string of a held shape, else None.
    The shape is what pandas' inferred format fixes: blanks before, the
    separator, the time's separator and whether it has seconds, blanks
    after."""
    m = _DATE.match(s)
    if not m:
        return None
    lead, y, sep, mo, d, tsep, hh, mm, ss, trail = m.groups()
    if not sep and (len(mo) != 2 or len(d) != 2):
        return None
    shape = (bool(lead), sep, tsep, ss is not None, bool(trail))
    return shape, _make_date(y, mo, d, hh, mm, ss)


def _dates(values) -> List[Optional[_dt.datetime]]:
    """``pd.to_datetime(col, errors="coerce")`` on None and strings: a
    datetime, or None for NaT."""
    for v in values:
        if not (_is_null(v) or isinstance(v, str)):
            raise TypeError(f"a date is a string or None, got {type(v).__name__}")
    first = next((v for v in values if not _is_null(v) and v != ""
                  and v not in _NAT_STRINGS), None)
    parts = _date_parts(first) if first is not None else None
    fmt = parts[0] if parts and parts[1] is not None else None
    out = []
    for v in values:
        p = None if _is_null(v) or v == "" or v in _NAT_STRINGS else _date_parts(v)
        if p is None or (fmt is not None and p[0] != fmt):
            out.append(None)
        else:
            out.append(p[1])
    return out


def _rows(records: List[dict]) -> List[dict]:
    """Row dicts → copies with every column of any of them (missing: None),
    the columns in order of first appearance, as ``pd.DataFrame(records)``."""
    cols: dict = {}
    for r in records:
        cols.update(dict.fromkeys(r))
    return [{c: r.get(c) for c in cols} for r in records]


def prepare_frames(invoices: List[dict], items: List[dict]):
    """Raw store rows → (invoice rows with year/month columns, item rows)."""
    df = _rows(invoices)
    df_items = _rows(items)
    if df:
        for r, amount in zip(df, _amounts([r["total_amount"] for r in df])):
            r["total_amount"] = amount
        for r, date in zip(df, _dates([r["date"] for r in df])):
            r["date"] = date
            r["year"] = "" if date is None else str(date.year)
            r["month"] = None if date is None else f"{date.year:04d}-{date.month:02d}"
    return df, df_items


def years(df) -> List[str]:
    if not df:
        return []
    return sorted({r["year"] for r in df if r["year"]}, reverse=True)


def year_summary(df, year: str):
    """(the year's rows, total spend for the year)."""
    sel = [dict(r) for r in df if r["year"] == year]
    return sel, sum(r["total_amount"] for r in sel)


def months_in(df_year) -> List[str]:
    return sorted({r["month"] for r in df_year}, reverse=True)


def _group_sum(rows, key):
    totals: dict = {}
    for r in rows:
        if not _is_null(r[key]):
            totals[r[key]] = totals.get(r[key], 0) + r["total_amount"]
    return [{key: k, "total_amount": totals[k]} for k in sorted(totals)]


def monthly_totals(df_year):
    """Per-month totals for the bar chart; adds a 2-digit month label."""
    return [dict(r, month_label=r["month"][-2:]) for r in _group_sum(df_year, "month")]


def category_totals(df_year, month: Optional[str] = None):
    """Per-category totals for the pie chart, optionally month-filtered."""
    sel = df_year if month is None else [r for r in df_year if r["month"] == month]
    return _group_sum(sel, "category")


def _date_key(d: _dt.datetime) -> int:
    return (d.toordinal() * 86400 + d.hour * 3600 + d.minute * 60 + d.second) * 10**6 \
        + d.microsecond


def invoices_sorted(df_year, month: Optional[str] = None):
    sel = df_year if month is None else [r for r in df_year if r["month"] == month]
    dated = [i for i, r in enumerate(sel) if r["date"] is not None]
    undated = [i for i, r in enumerate(sel) if r["date"] is None]
    # datetime64, as pandas sorts them: numpy's quicksort of that dtype
    # (not the vectorized one of int64) decides the order of equal dates
    keys = np.array([_date_key(sel[i]["date"]) for i in dated], np.int64).view("M8[us]")[::-1]
    idx = np.array(dated, np.int64)[::-1]
    order = idx[keys.argsort(kind="quicksort")][::-1]
    return [sel[i] for i in order.tolist() + undated]


def items_for_invoice(df_items, invoice_id: int):
    if not df_items:
        return df_items
    return [r for r in df_items if r["invoice_id"] == invoice_id]
