"""PyTorch port: the store (``twinvoice_tpu_torch/store``) against the JAX
package's: row shaping, the in-memory store's save/list/delete, and the
Supabase store on the fake client of the JAX package's
``tests/unit/test_store.py`` (``chip_smoke.FakeSupabaseClient``), on a
client whose calls fail and with no credentials. Every row and every return
(None, False, [] or the exception's type) equal. Tolerance: none."""

import pytest

import chip_smoke
from twinvoice_tpu.store import base as jbase
from twinvoice_tpu.store.memory import MemoryStore as JMemoryStore
from twinvoice_tpu.store.supabase_store import SupabaseStore as JSupabaseStore
from twinvoice_tpu_torch.store import base as tbase
from twinvoice_tpu_torch.store.memory import MemoryStore
from twinvoice_tpu_torch.store.supabase_store import SupabaseStore

META = chip_smoke.STORE_META
ITEMS = chip_smoke.STORE_ITEMS
ROW_CASES = {
    "reference": (META, ITEMS),
    "empty": ({}, []),
    "amount_none": ({"total_amount": None}, []),
    "amount_zero_str": ({"total_amount": "0"}, None),
    "long_number": ({"invoice_no": "AB123456789012", "source": "merged_ocr"}, []),
    "number_none": ({"invoice_no": None, "qr_raw": ["x"] * 5}, []),
    "category_none": ({"category": None, "date": None}, []),
    "amount_comma": ({"total_amount": "1,200"}, []),
    "amount_float_str": ({"total_amount": "12.5"}, []),
    "amount_float": ({"total_amount": 12.9}, []),
    "amount_list": ({"total_amount": [1]}, []),
}
ITEM_CASES = {
    "reference": ITEMS,
    "defaults": [{}],
    "strings": [{"name": 5, "qty": "2", "price": "30", "amount": "60"}],
    "bad_qty": [{"name": "x", "qty": "x"}],
    "float_qty": [{"qty": 1.9, "price": -2.5}],
    "empty": [],
}


def _call(fn, *args):
    try:
        return fn(*args)
    except Exception as e:
        return ("raises", type(e).__name__)


@pytest.mark.parametrize("case", sorted(ROW_CASES))
def test_invoice_row_equals_jax(case):
    meta, items = ROW_CASES[case]
    assert _call(tbase.invoice_row_from_meta, meta, items) == _call(
        jbase.invoice_row_from_meta, meta, items)


@pytest.mark.parametrize("case", sorted(ITEM_CASES))
def test_item_rows_equal_jax(case):
    assert _call(tbase.item_rows, 7, ITEM_CASES[case]) == _call(jbase.item_rows, 7,
                                                               ITEM_CASES[case])


def test_truncation_and_failed_conversion():
    assert tbase.invoice_row_from_meta(META, ITEMS)["invoice_no"] == "AB12345678"
    store = MemoryStore()
    assert store.save_invoice(dict(META, total_amount="1,200"), ITEMS) is None
    assert store.list_invoices() == [] and store.list_items() == []


def test_scripted_calls_equal_jax():
    """Every scripted call of ``chip_smoke.store_ops`` on each store kind
    (phase 28 (a)), the fake client's tables after them too."""
    got = chip_smoke.store_record(MemoryStore, SupabaseStore)
    want = chip_smoke.store_record(JMemoryStore, JSupabaseStore)
    assert got == want
    ops = dict((op, r) for op, r in got["memory"])
    assert ops["save"] == 1 and ops["save amount 1,200"] is None
    assert ops["save bad item"] == ["raises", "ValueError"]  # raised after the row went in
    assert dict((op, r) for op, r in got["supabase"])["save bad item"] is None
    assert [r for _, r in got["supabase_failing"]][:2] == [None, None]
    assert got["supabase_bare"][0] is False and got["supabase_creds"] is False


def test_memory_store_order_and_limits():
    for cls in (MemoryStore, JMemoryStore):
        s = cls()
        ids = [s.save_invoice(dict(META, invoice_no=f"AB{i:08d}"), ITEMS * i) for i in range(6)]
        assert ids == list(range(1, 7))
        assert [r["id"] for r in s.list_invoices(3)] == [6, 5, 4]
        assert len(s.list_items(4)) == 4
        assert s.delete_invoice(6) and not s.delete_invoice(6)
    assert MemoryStore().list_invoices() == []


def test_supabase_unavailable_without_client(monkeypatch):
    for name in ("SUPABASE_URL", "SUPABASE_KEY"):
        monkeypatch.delenv(name, raising=False)
    store = SupabaseStore()
    assert not store.available()
    assert (store.save_invoice(META, ITEMS), store.delete_invoice(1), store.list_invoices(),
            store.list_items()) == (None, False, [], [])
    monkeypatch.setenv("SUPABASE_URL", "http://localhost:1")
    monkeypatch.setenv("SUPABASE_KEY", "k")
    assert SupabaseStore().available() is JSupabaseStore().available() is False


def test_supabase_failing_client_list_raises_as_jax():
    """The list calls carry no guard in the JAX store: a failing client's
    error reaches the caller, in the port's too."""
    for cls in (SupabaseStore, JSupabaseStore):
        store = cls(client=chip_smoke.FakeSupabaseClient(fail=True))
        with pytest.raises(RuntimeError):
            store.list_invoices()
        assert store.delete_invoice(1) is False
