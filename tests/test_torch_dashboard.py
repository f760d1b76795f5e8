"""PyTorch port: the dashboard's aggregation without pandas
(``app/dashboard.py``) against the JAX package's pandas one, on the rows of
the JAX package's ``tests/unit/test_dashboard.py`` and on seeded sets of
store rows with bad amounts (``"12.7"``, ``"1,200"``, None, ``""``), dates
missing, empty, impossible or of a second format placed first, and runs of
equal dates (the sort's tie order: pandas' ``nargsort`` on numpy's
quicksort). Every function's values and row order equal JAX's
(``chip_smoke.dashboard_record``: the frames, years, per year its rows,
total, months, monthly and category totals, sorted rows, each invoice's
items). Tolerance: none."""

import random

import pytest

import chip_smoke
from twinvoice_tpu.app import dashboard as J
from twinvoice_tpu.store.memory import MemoryStore as JMemoryStore
from twinvoice_tpu_torch.app import dashboard as T
from twinvoice_tpu_torch.store.memory import MemoryStore

UNIT_ROWS = [
    ("AB11111111", "2025-01-15", "100", "餐飲"),
    ("AB22222222", "2025-01-20", "50", "交通"),
    ("AB33333333", "2025-02-05", "200", "餐飲"),
    ("AB44444444", "2024-12-31", "999", "購物"),
    ("AB55555555", None, "77", "生活"),
]
DATES = ["2025-01-15", "2025-01-20", "2025-02-05", "2024-12-31", "2025-1-5", "2024-02-29",
         None, "", "NaT", "2025/03/01", "2025.04.04", "20250115", "2025-13-45", "2025-02-30",
         " 2025-01-15", "2025-01-15 ", "2025-01-20 01:02", "2025-01-20T01:02:03", "None"]
AMOUNTS = [100, "50", "12.7", "1,200", None, "", "abc", " 7 ", -3, 2.9, "1e2", "-3.9", "+8"]
CATEGORIES = ["餐飲", "交通", "購物", "生活", "未分類", None]


def _rows(frame):
    return frame.to_dict("records")


def _record(D, rows, invoices, items):
    return chip_smoke.dashboard_record(D, rows, invoices, items)


def _both(invoices, items):
    return _record(T, list, invoices, items), _record(J, _rows, invoices, items)


def _store_rows(cls):
    s = cls()
    for no, date, amt, cat in UNIT_ROWS:
        s.save_invoice({"invoice_no": no, "date": date, "total_amount": amt, "category": cat,
                        "source": "QR", "qr_raw": []},
                       [{"name": "x", "qty": 1, "price": int(amt), "amount": int(amt)}])
    return s.list_invoices(), s.list_items()


def test_unit_rows_equal_jax():
    inv, its = _store_rows(MemoryStore)
    assert (inv, its) == _store_rows(JMemoryStore)
    got, want = _both(inv, its)
    assert got == want
    assert got["years"] == ["2025", "2024"] and got["by_year"]["2025"]["total"] == 350
    assert got["by_year"]["2025"]["monthly"] == [
        {"month": "2025-01", "total_amount": 150, "month_label": "01"},
        {"month": "2025-02", "total_amount": 200, "month_label": "02"}]


def _seeded(seed):
    rng = random.Random(seed)
    n = rng.randint(1, 24)
    first = rng.choice(DATES)
    invoices = [{"id": n - i, "invoice_no": f"AB{rng.randint(0, 99999999):08d}",
                 "date": first if i == 0 else rng.choice(DATES[:4] * 4 + DATES),
                 "total_amount": rng.choice(AMOUNTS) if rng.random() < 0.5
                 else rng.randint(0, 999),
                 "category": rng.choice(CATEGORIES[:-1] if rng.random() < 0.8 else CATEGORIES),
                 "note": rng.choice(["QR", "merged_ocr", ""])} for i in range(n)]
    items = [{"invoice_id": rng.randint(0, n), "name": f"i{j}", "qty": 1, "price": 3,
              "amount": 3} for j in range(rng.randint(0, 8))]
    return invoices, items


@pytest.mark.parametrize("seed", range(24))
def test_seeded_rows_equal_jax(seed):
    invoices, items = _seeded(seed)
    got, want = _both(invoices, items)
    assert got == want


def test_second_format_first_coerces_the_rest():
    """pandas infers the format from the first date: ``%Y/%m/%d`` here, so
    the ISO dates after it are NaT (no year, no month)."""
    rows = [{"id": i, "invoice_no": "x", "date": d, "total_amount": 1, "category": "a",
             "note": ""} for i, d in enumerate(["2025/01/15", "2025-01-16", "2025/1/5"])]
    got, want = _both(rows, [])
    assert got == want
    assert [r["year"] for r in got["frame"]] == ["2025", "", "2025"]
    assert [r["month"] for r in got["frame"]] == ["2025-01", None, "2025-01"]


@pytest.mark.parametrize("n", [3, 16, 17, 40, 130])
def test_equal_dates_keep_pandas_tie_order(n):
    """Runs of equal dates beyond numpy's insertion-sort cutoff (16)."""
    rng = random.Random(n)
    rows = [{"id": i, "invoice_no": f"N{i}", "date": rng.choice(["2025-03-01", "2025-03-02"]),
             "total_amount": i, "category": "a", "note": ""} for i in range(n)]
    got, want = _both(rows, [])
    assert got == want
    order = [r["id"] for r in T.invoices_sorted(T.year_summary(
        T.prepare_frames(rows, [])[0], "2025")[0])]
    assert order == [int(i) for i in J.invoices_sorted(J.year_summary(
        J.prepare_frames(rows, [])[0], "2025")[0])["id"]]


@pytest.mark.parametrize("amount,want", [("12.7", 12), ("1,200", 0), ("", 0), (None, 0),
                                         (" 7 ", 7), ("-3.9", -3), ("1e2", 100), (5.99, 5),
                                         ("1E+2", 100), ("00012", 12), ("-.5", 0),
                                         ("-nan", 0), ("1.5e", 0), ("infinit", 0)])
def test_amount_coercion(amount, want):
    rows = [{"id": 1, "invoice_no": "x", "date": "2025-01-01", "total_amount": amount,
             "category": "a", "note": ""}]
    assert T.prepare_frames(rows, [])[0][0]["total_amount"] == want
    assert int(J.prepare_frames(rows, [])[0]["total_amount"].iloc[0]) == want


@pytest.mark.parametrize("amount", ["inf", "-Infinity", "+INF", float("inf")])
def test_non_finite_amount_raises_as_pandas(amount):
    rows = [{"id": 1, "invoice_no": "x", "date": "2025-01-01", "total_amount": amount,
             "category": "a", "note": ""}]
    with pytest.raises(ValueError):
        J.prepare_frames(rows, [])
    with pytest.raises(ValueError):
        T.prepare_frames(rows, [])


def test_empty_store():
    df, df_items = T.prepare_frames([], [])
    assert df == [] and df_items == [] and T.years(df) == []
    assert J.prepare_frames([], [])[0].empty
    assert T.items_for_invoice([], 3) == []
    assert _both([], [])[0] == _both([], [])[1]
